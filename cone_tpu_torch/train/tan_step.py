"""The training step of the CONE-TAN family (cone_tpu/train/tan_step.py;
the reference closure cone_2dtan/moment_localization/train.py:254-338):
the positive window's scaled-IoU BCE, the negative window's map pushed
toward an all-zero target (train.py:266-272), and the adapter NCE on GT
proposals weighted by loss.adapter_loss_coef once the adapter is on. The
global gradient norm is clipped to 10 (the engine's hardcoded
clip_grad_norm_, lib/core/engine.py:43-56) before the Adam update. TAN has
no dropout. Forward and backward compute in full float32 on the card
(utils/device.resolve_device switches TF32 off). Data parallel as the CONE
step (train/step.py): each term is this rank's share of the global batch's
(the BCE means over the world size, the adapter InfoNCE against the
gathered other side), and the gradients are summed before the clip.
"""

from __future__ import annotations

import torch

from cone_tpu_torch.config import TanConfig
from cone_tpu_torch.models.losses import adapter_nce_share
from cone_tpu_torch.models.tan import bce_rescale_loss
from cone_tpu_torch.ops.pooling import matching_embeds_gt
from cone_tpu_torch.parallel.distributed import LOCAL, GroupReduce
from cone_tpu_torch.train.optim import zero_missing_grads
from cone_tpu_torch.train.step import batch_to_device, global_terms

GRAD_CLIP = 10.0


def iou_targets(num_clips: int, start_pos: torch.Tensor, end_pos: torch.Tensor) -> torch.Tensor:
    """Batched models/tan.py iou_target_map: (B,) window-local GT spans in
    map cells -> (B, S, E) hull-union IoU of every cell [s, e + 1]."""
    dev = start_pos.device
    s = torch.arange(num_clips, dtype=torch.float32, device=dev)[None, :, None]
    e = torch.arange(1, num_clips + 1, dtype=torch.float32, device=dev)[None, None, :]
    st, ed = start_pos[:, None, None], end_pos[:, None, None]
    inter = (torch.minimum(e, ed) - torch.maximum(s, st)).clamp(min=0)
    union = (torch.maximum(e, ed) - torch.minimum(s, st)).clamp(min=0)
    return torch.where(union > 0, inter / torch.where(union == 0, 1.0, union), 0.0)


def make_tan_loss_fn(model, tan_cfg: TanConfig, use_neg_loss: bool = True,
                     adapter_loss_coef: float = 0.1, reduce: GroupReduce = LOCAL):
    """loss_fn(batch, adapter_on) -> (total, per-term losses) on tensors on
    the model's device; with a group, this rank's shares. adapter_loss_coef
    defaults to the reference's TRAIN.ADAPTER_LOSS_WEIGHT
    (lib/core/config.py:83); the loop passes loss.adapter_loss_coef."""
    world = reduce.world

    def loss_fn(batch: dict, adapter_on: bool):
        pos_scores, map_mask = model(batch["query_tokens"], batch["query_mask"],
                                     batch["pos_motion"])
        # the window-local GT span in clips, from the normalized cxw label;
        # the IoU targets live on the pooled map grid, so positions divide by
        # TARGET_STRIDE (cone_2dtan/lib/datasets/mad.py:150-153)
        c, w = batch["span_labels"][:, 0, 0], batch["span_labels"][:, 0, 1]
        wl = batch["video_length"].float()
        targets = iou_targets(tan_cfg.num_clips, (c - w / 2) * wl / tan_cfg.frame_stride,
                              (c + w / 2) * wl / tan_cfg.frame_stride)
        loss, _ = bce_rescale_loss(pos_scores, map_mask, targets, tan_cfg.min_iou,
                                   tan_cfg.max_iou, tan_cfg.bias)
        loss = loss / world
        losses = {"loss_bce": loss}
        if use_neg_loss:
            neg_scores, _ = model(batch["query_tokens"], batch["query_mask"],
                                  batch["neg_motion"])
            neg_loss, _ = bce_rescale_loss(neg_scores, map_mask, torch.zeros_like(neg_scores),
                                           tan_cfg.min_iou, tan_cfg.max_iou, tan_cfg.bias)
            neg_loss = neg_loss / world
            losses["loss_neg_bce"] = neg_loss
            loss = loss + neg_loss
        if adapter_on and tan_cfg.adapter_module == "linear":
            prop, text = matching_embeds_gt(model.adapt, batch["query_cls"],
                                            batch["pos_appear"], batch["prop_start"],
                                            batch["prop_end"])
            a_loss = adapter_nce_share(prop, text, tan_cfg.temperature, reduce)
            losses["loss_adapter"] = a_loss
            loss = loss + adapter_loss_coef * a_loss
        losses["loss_overall"] = loss
        return loss, losses

    return loss_fn


def make_tan_train_step(model, optimizer, tan_cfg: TanConfig, use_neg_loss: bool = True,
                        adapter_loss_coef: float = 0.1, reduce: GroupReduce = LOCAL):
    """train_step(batch, adapter_on) -> metrics: each loss term of the
    global batch, loss_overall and grad_norm (the global gradient norm
    before the clip), as 0-d tensors on the device. A parameter without a
    gradient (the adapter while it is off) takes a zero gradient after the
    clip, so Adam's L2 decay moves it as cone_tpu's
    clip -> add_decayed_weights -> adam chain does (train/optim.py)."""
    loss_fn = make_tan_loss_fn(model, tan_cfg, use_neg_loss, adapter_loss_coef, reduce)
    params = [p for p in model.parameters() if p.requires_grad]
    device = params[0].device

    def train_step(batch: dict, adapter_on: bool = False) -> dict:
        model.train()
        total, losses = loss_fn(batch_to_device(batch, device), adapter_on)
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        reduce.sum_grads(params)
        grad_norm = torch.nn.utils.clip_grad_norm_(params, GRAD_CLIP)
        zero_missing_grads(params)
        optimizer.step()
        metrics = global_terms(losses, reduce)
        metrics["grad_norm"] = grad_norm
        return metrics

    return train_step


def make_tan_eval_loss_step(model, tan_cfg: TanConfig, use_neg_loss: bool = True,
                            adapter_loss_coef: float = 0.1, reduce: GroupReduce = LOCAL):
    """eval_loss_step(batch, adapter_on) -> per-term losses of the global
    batch: the train loss forward-only under torch.no_grad() (TAN has no
    dropout), the 2D-TAN engine's loss-reporting test pass
    (cone_2dtan/lib/core/engine.py:75-102)."""
    loss_fn = make_tan_loss_fn(model, tan_cfg, use_neg_loss, adapter_loss_coef, reduce)
    device = next(model.parameters()).device

    def eval_loss_step(batch: dict, adapter_on: bool = False) -> dict:
        with torch.no_grad():
            _, losses = loss_fn(batch_to_device(batch, device), adapter_on)
        return global_terms(losses, reduce)

    return eval_loss_step
