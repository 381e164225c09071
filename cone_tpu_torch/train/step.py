"""The training step (cone/train.py:53-89): positive-window forward,
negative-window forward, the GT-proposal matching forward once the adapter
is on, the criterion, the backward, the global-norm clip and the AdamW
update. The adapter gate (`epoch >= start_epoch_for_adapter`,
cone/train.py:73-78) is an argument of each call.
"""

from __future__ import annotations

import numpy as np
import torch

from cone_tpu_torch.config import ConeConfig
from cone_tpu_torch.models.losses import compute_losses, loss_weight_dict, total_loss


def batch_to_device(batch: dict, device) -> dict:
    """A TrainLoader batch (numpy) as tensors on `device`; integer arrays
    become int64, the index type of gather. Tensors pass through."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(v.astype(np.int64) if v.dtype.kind in "iu" else v)
        out[k] = v.to(device, non_blocking=True)
    return out


def make_loss_fn(model, cfg: ConeConfig):
    """loss_fn(batch, adapter_on) -> (total, per-term losses), on tensors on
    the model's device, in whatever mode the model is in: the train step
    (dropout on) and the eval-split loss pass (dropout off, the reference's
    criterion.eval() stance, cone/inference.py:32-34) share it."""
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
            pos_out["logits_per_video"] = model.clip_matching_gt(
                batch["query_cls"], batch["pos_appear"], batch["prop_start"],
                batch["prop_end"])
        targets = {"span_labels": batch["span_labels"], "span_mask": batch["span_mask"],
                   "saliency_pos": batch["sal_pos"], "saliency_neg": batch["sal_neg"]}
        losses = compute_losses(pos_out, targets, neg_out, cfg.loss)
        total = total_loss(losses, weights)
        losses["loss_overall"] = total
        return total, losses

    return loss_fn


def make_train_step(model, optimizer, scheduler, cfg: ConeConfig):
    """train_step(batch, adapter_on) -> metrics: every criterion term,
    loss_overall and grad_norm (the global gradient norm before the clip),
    as 0-d tensors on the device; the model is in train mode for the step.
    Parameters without a gradient in a step (the adapter before it is
    switched on, an unused text position table) are left alone by AdamW,
    as in the reference."""
    loss_fn = make_loss_fn(model, cfg)
    params = [p for p in model.parameters() if p.requires_grad]
    device = params[0].device
    clip = cfg.train.grad_clip if cfg.train.grad_clip > 0 else float("inf")

    def train_step(batch: dict, adapter_on: bool = False) -> dict:
        model.train()
        total, losses = loss_fn(batch_to_device(batch, device), adapter_on)
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        # the pre-clip norm (torch's own clip, cone/train.py:87-88)
        grad_norm = torch.nn.utils.clip_grad_norm_(params, clip)
        optimizer.step()
        scheduler.step()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["grad_norm"] = grad_norm
        return metrics

    return train_step


def make_eval_loss_step(model, cfg: ConeConfig):
    """eval_loss_step(batch, adapter_on) -> per-term losses: the criterion
    forward-only on eval-split windows, the model in eval mode (restored
    after) under torch.no_grad(). The eval-loss curves the reference
    prepares for TensorBoard in eval_epoch (cone/inference.py:30-36, 96-98)."""
    loss_fn = make_loss_fn(model, cfg)
    device = next(model.parameters()).device

    def eval_loss_step(batch: dict, adapter_on: bool = False) -> dict:
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                _, losses = loss_fn(batch_to_device(batch, device), adapter_on)
        finally:
            model.train(was_training)
        return losses

    return eval_loss_step


def to_floats(metrics: dict) -> dict:
    """0-d device tensors -> Python floats in one device-to-host transfer."""
    if not metrics:
        return {}
    host = torch.stack([v.float() for v in metrics.values()]).cpu().tolist()
    return dict(zip(metrics, host))
