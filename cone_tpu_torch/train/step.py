"""The training step (cone/train.py:53-89): positive-window forward,
negative-window forward, the GT-proposal matching forward once the adapter
is on, the criterion, the backward, the global-norm clip and the AdamW
update. The adapter gate (`epoch >= start_epoch_for_adapter`,
cone/train.py:73-78) is an argument of each call.

Data parallel (`reduce` over a group, parallel/distributed.GroupReduce):
the batch is this rank's row block, the criterion its share of the global
batch's loss, and one coalesced all-reduce sums the gradients after the
backward, so the clip sees the global norm and every rank takes the same
update. The metrics a step returns are the global batch's. Dropout masks
are drawn for the global batch from one generator seeded per step from
(train.seed, global step), and each rank keeps its row block of them
(models/dropout.py), so N ranks take the single run's steps with dropout
on too.
"""

from __future__ import annotations

import numpy as np
import torch

from cone_tpu_torch.config import ConeConfig
from cone_tpu_torch.models.dropout import global_rows, step_seed
from cone_tpu_torch.models.losses import compute_losses, loss_weight_dict, total_loss
from cone_tpu_torch.ops.pooling import matching_embeds_gt
from cone_tpu_torch.parallel.distributed import LOCAL, GroupReduce
from cone_tpu_torch.parallel.mesh import row_block


def batch_to_device(batch: dict, device) -> dict:
    """A TrainLoader batch (numpy) as tensors on `device`; integer arrays
    become int64, the index type of gather. Tensors pass through."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(v.astype(np.int64) if v.dtype.kind in "iu" else v)
        out[k] = v.to(device, non_blocking=True)
    return out


def global_terms(losses: dict, reduce: GroupReduce) -> dict:
    """Per-term shares -> the global batch's terms (detached), in one
    all-reduce."""
    total = reduce.sum(torch.stack([v.detach().float() for v in losses.values()]))
    return dict(zip(losses, total.unbind()))


def make_loss_fn(model, cfg: ConeConfig, reduce: GroupReduce = LOCAL):
    """loss_fn(batch, adapter_on) -> (total, per-term losses), on tensors on
    the model's device, in whatever mode the model is in: the train step
    (dropout on) and the eval-split loss pass (dropout off, the reference's
    criterion.eval() stance, cone/inference.py:32-34) share it. With a
    group, both are this rank's shares."""
    weights = loss_weight_dict(cfg.loss, cfg.model.dec_layers)

    def loss_fn(batch: dict, adapter_on: bool):
        pos_out = model(batch["query_tokens"], batch["query_mask"],
                        batch["pos_motion"], batch["pos_mask"])
        neg_out = None
        if cfg.loss.neg_loss:
            neg_out = model(batch["query_tokens"], batch["query_mask"],
                            batch["neg_motion"], batch["neg_mask"])
            neg_out["vid_mask"] = batch["neg_mask"]
        if adapter_on and cfg.loss.adapter_loss:
            pos_out["adapter_embeds"] = matching_embeds_gt(
                model.adapt, batch["query_cls"], batch["pos_appear"], batch["prop_start"],
                batch["prop_end"])
        targets = {"span_labels": batch["span_labels"], "span_mask": batch["span_mask"],
                   "saliency_pos": batch["sal_pos"], "saliency_neg": batch["sal_neg"]}
        losses = compute_losses(pos_out, targets, neg_out, cfg.loss, reduce)
        total = total_loss(losses, weights)
        losses["loss_overall"] = total
        return total, losses

    return loss_fn


def make_train_step(model, optimizer, scheduler, cfg: ConeConfig,
                    reduce: GroupReduce = LOCAL):
    """train_step(batch, adapter_on) -> metrics: every criterion term,
    loss_overall and grad_norm (the global gradient norm before the clip),
    as 0-d tensors on the device; the model is in train mode for the step.
    Parameters without a gradient in a step (the adapter before it is
    switched on, an unused text position table) are left alone by AdamW,
    as in the reference, and by the gradient all-reduce.

    The step's two forwards draw their dropout masks, in call order, from
    one generator on the model's device, seeded from (train.seed, global
    step); the global step is the lr schedule's step count, which a
    resumed run restores. The masks cover the global batch (this rank's
    rows times the ranks) and the rank keeps its row block."""
    loss_fn = make_loss_fn(model, cfg, reduce)
    params = [p for p in model.parameters() if p.requires_grad]
    device = params[0].device
    clip = cfg.train.grad_clip if cfg.train.grad_clip > 0 else float("inf")
    gen = torch.Generator(device=device)

    def train_step(batch: dict, adapter_on: bool = False) -> dict:
        model.train()
        batch = batch_to_device(batch, device)
        rows = len(batch["query_tokens"])
        lo, _ = row_block(rows * reduce.world, reduce.rank, reduce.world)
        gen.manual_seed(step_seed(cfg.train.seed, scheduler.last_epoch))
        with global_rows(gen, rows * reduce.world, lo):
            total, losses = loss_fn(batch, adapter_on)
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        reduce.sum_grads(params)
        # the pre-clip norm (torch's own clip, cone/train.py:87-88)
        grad_norm = torch.nn.utils.clip_grad_norm_(params, clip)
        optimizer.step()
        scheduler.step()
        metrics = global_terms(losses, reduce)
        metrics["grad_norm"] = grad_norm
        return metrics

    return train_step


def make_eval_loss_step(model, cfg: ConeConfig, reduce: GroupReduce = LOCAL):
    """eval_loss_step(batch, adapter_on) -> per-term losses of the global
    batch: the criterion forward-only on eval-split windows, the model in
    eval mode (restored after) under torch.no_grad(). The eval-loss curves
    the reference prepares for TensorBoard in eval_epoch
    (cone/inference.py:30-36, 96-98)."""
    loss_fn = make_loss_fn(model, cfg, reduce)
    device = next(model.parameters()).device

    def eval_loss_step(batch: dict, adapter_on: bool = False) -> dict:
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                _, losses = loss_fn(batch_to_device(batch, device), adapter_on)
        finally:
            model.train(was_training)
        return global_terms(losses, reduce)

    return eval_loss_step


def to_floats(metrics: dict) -> dict:
    """0-d device tensors -> Python floats in one device-to-host transfer."""
    if not metrics:
        return {}
    host = torch.stack([v.float() for v in metrics.values()]).cpu().tolist()
    return dict(zip(metrics, host))
