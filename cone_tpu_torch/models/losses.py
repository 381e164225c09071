"""CONE training criterion (cone/model.py:213-425, SetCriterion) on tensors.

Hungarian-matched span L1 + gIoU, foreground/background cross entropy with
the negative window's queries folded in as all-background, intra- and
inter-window hinge saliency, the adapter's symmetric InfoNCE, and the same
terms per earlier decoder layer. The matcher runs on the device
(ops/matching.py) instead of scipy on the host.

Targets are fixed-shape tensors with masks:
    span_labels  (B, NT, 2) normalized cxw, span_mask (B, NT)
    saliency_pos (B, P) int clip index, saliency_neg (B, P)

One deliberate deviation from the reference, shared with the JAX package:
the negative window's max saliency is taken over its valid frames only
(the reference's max runs over padding too, cone/model.py:358). The two
agree when windows are full-length.

Data parallel: every term is this rank's exact share of the global batch's
term, so the shares sum over ranks to the global loss and their gradients,
summed over ranks, to its gradient (parallel/distributed.GroupReduce). The
per-element means divide by counts that are equal on every rank (rows
split evenly) and become local means over the world size; the two terms
that couple rows take global quantities from the group: the span L1 and
gIoU divide by the global span count, and the adapter's InfoNCE scores its
rows and columns against the gathered other side. With one rank and no
group every reduction is the identity.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from cone_tpu_torch.config import LossConfig
from cone_tpu_torch.ops.matching import hungarian_match, matcher_cost, safe_target_spans
from cone_tpu_torch.ops.spans import generalized_temporal_iou, span_cxw_to_xx
from cone_tpu_torch.parallel.distributed import LOCAL, GroupReduce

FOREGROUND = 0
BACKGROUND = 1


def _weighted_ce(logits: torch.Tensor, labels: torch.Tensor, eos_coef: float) -> torch.Tensor:
    """Per-element w[label] * nll with w = (1, eos_coef), then the mean over
    the element count (reduction='none' followed by .mean(),
    cone/model.py:323-324). F.cross_entropy(weight=w) with its default
    reduction would divide by the weight sum instead."""
    nll = F.cross_entropy(logits.flatten(0, -2), labels.flatten(), reduction="none")
    w = torch.where(labels.flatten() == FOREGROUND, 1.0, eos_coef)
    return (w * nll).mean()


def _match_layer(outputs, tgt_spans, span_mask, cfg: LossConfig):
    with torch.no_grad():
        cost = matcher_cost(
            outputs["pred_spans"], outputs["pred_logits"], tgt_spans,
            cost_span=cfg.set_cost_span, cost_giou=cfg.set_cost_giou,
            cost_class=cfg.set_cost_class, tgt_mask=span_mask)
        return hungarian_match(cost, span_mask)  # (B, NT)


def _span_losses(outputs, tgt_spans, span_mask, assign, n):
    """L1 + gIoU over matched pairs (cone/model.py:266-297); `n` is the
    global batch's span count (at least 1)."""
    src = torch.gather(outputs["pred_spans"], 1, assign[..., None].expand(-1, -1, 2))
    l1 = (src - tgt_spans).abs().sum(-1)  # (B, NT): per-span L1 over 2 coords
    loss_span = (l1 * span_mask).sum() / (2.0 * n)  # mean over 2 * #spans elements

    # padded target slots are degenerate (0, 0) spans; if the matched
    # prediction's sigmoid width also underflows to exactly 0, gIoU there is
    # 0/0 = NaN, which poisons `NaN * 0` in the forward and the zero
    # cotangent times NaN in the backward. Replace masked targets with a
    # safe unit span BEFORE the IoU, then mask.
    tgt_xx = span_cxw_to_xx(safe_target_spans(tgt_spans, span_mask))
    giou = generalized_temporal_iou(span_cxw_to_xx(src)[..., None, :], tgt_xx[..., None, :])
    loss_giou = ((1.0 - giou[..., 0, 0]) * span_mask).sum() / n
    return loss_span, loss_giou


def _label_loss(outputs, assign, span_mask, neg_outputs, eos_coef, n=None, world=1):
    """Foreground/background CE; the negative window's logits are appended
    as pure background (cone/model.py:299-329). Returns (loss, class_error)
    as this rank's shares; `n` is the global span count (default: these
    rows' own, one process)."""
    if n is None:
        n = span_mask.sum().clamp(min=1.0)
    logits = outputs["pred_logits"]  # (B, NQ, 2)
    if neg_outputs is not None:
        logits = torch.cat([logits, neg_outputs["pred_logits"]], dim=1)
    # foreground at the matched query slots; a padded target's assign may
    # name the same query as a real one, and amax lets the real one win
    # whatever the order of the writes
    fg = torch.zeros(logits.shape[:2], dtype=span_mask.dtype, device=logits.device)
    fg = fg.scatter_reduce(1, assign, span_mask, reduce="amax")
    labels = torch.where(fg > 0, FOREGROUND, BACKGROUND)
    loss = _weighted_ce(logits, labels, eos_coef) / world

    # class_error on the matched positive-window queries (cone/misc.py:4,
    # cone/model.py:328): % of matched queries whose argmax is not foreground
    with torch.no_grad():
        matched = torch.gather(outputs["pred_logits"], 1, assign[..., None].expand(-1, -1, 2))
        correct = (matched.argmax(-1) == FOREGROUND).to(span_mask.dtype) * span_mask
        class_error = 100.0 * (span_mask.sum() - correct.sum()) / n
    return loss, class_error


def _saliency_loss(outputs, sal_pos, sal_neg, neg_outputs, neg_vid_mask, margin: float,
                   world: int):
    """Intra-window hinge + inter-window hinge (cone/model.py:331-365),
    this rank's share."""
    scores = outputs["saliency_scores"]  # (B, L)
    b, n_pairs = sal_pos.shape
    pos = torch.gather(scores, 1, sal_pos)  # (B, P)
    neg = torch.gather(scores, 1, sal_neg)
    loss = (margin + neg - pos).clamp(min=0).sum() / (b * n_pairs) * 2
    if neg_outputs is not None:
        neg_scores = neg_outputs["saliency_scores"]  # (B, L)
        if neg_vid_mask is not None:
            neg_scores = torch.where(neg_vid_mask.bool(), neg_scores, -1e30)
        neg_max = neg_scores.amax(dim=1, keepdim=True)  # (B, 1)
        loss = loss + (margin + neg_max - pos).clamp(min=0).sum() / (b * n_pairs) * 2
    return loss / world


def adapter_nce_share(prop: torch.Tensor, text: torch.Tensor, temperature: float,
                      reduce: GroupReduce = LOCAL) -> torch.Tensor:
    """This rank's share of the adapter's symmetric InfoNCE over the global
    batch's (B, B) video <-> text matrix logits_per_video = prop @ text.T
    (cone/model.py:250-264), from its (b, D) unit-norm proposal and text
    rows (ops/pooling.matching_embeds_gt): its b rows of the matrix against
    the gathered text side, and its b columns against the gathered proposal
    side. With one rank and no group, the whole loss."""
    b, d = prop.shape
    both = reduce.gather_rows(torch.cat([prop, text], dim=1))   # (B, 2D), rank order
    own = (torch.arange(b, device=prop.device) + reduce.rank * b)[:, None]
    rows = (prop @ both[:, d:].T) / temperature     # own rows of logits_per_video
    cols = (text @ both[:, :d].T) / temperature     # own columns, transposed
    n = b * reduce.world
    loss_v = -rows.log_softmax(-1).gather(1, own).sum() / n
    loss_t = -cols.log_softmax(-1).gather(1, own).sum() / n
    return (loss_v + loss_t) / 2


def compute_losses(outputs: dict, targets: Optional[dict], neg_outputs: Optional[dict],
                   cfg: LossConfig, reduce: GroupReduce = LOCAL) -> dict:
    """Every criterion term (unweighted), keyed like the reference; with a
    group, this rank's share of each (module docstring).

    outputs: the model's output dict (with "aux_outputs", and for the
    adapter loss "adapter_embeds", this rank's (prop, text) rows).
    targets: span_labels, span_mask, saliency_pos, saliency_neg, or None for
    the label-only mode (cone/model.py:398-401). neg_outputs: the negative
    window's outputs or None; its optional "vid_mask" (B, L) bounds the
    saliency max."""
    losses = {}
    world = reduce.world
    if targets is None:
        logits = outputs["pred_logits"]
        labels = torch.full(logits.shape[:2], BACKGROUND, dtype=torch.int64,
                            device=logits.device)
        losses["loss_label"] = _weighted_ce(logits, labels, cfg.eos_coef) / world
        return losses

    tgt_spans = targets["span_labels"]
    span_mask = targets["span_mask"].float()
    n = reduce.sum(span_mask.sum()).clamp(min=1.0)
    assign = _match_layer(outputs, tgt_spans, span_mask, cfg)
    losses["loss_span"], losses["loss_giou"] = _span_losses(outputs, tgt_spans, span_mask,
                                                            assign, n)
    losses["loss_label"], losses["class_error"] = _label_loss(
        outputs, assign, span_mask, neg_outputs, cfg.eos_coef, n, world)
    losses["loss_saliency"] = _saliency_loss(
        outputs, targets["saliency_pos"], targets["saliency_neg"], neg_outputs,
        neg_outputs.get("vid_mask") if neg_outputs else None, cfg.saliency_margin, world)
    if "adapter_embeds" in outputs:
        losses["loss_adapter"] = adapter_nce_share(*outputs["adapter_embeds"], cfg.temperature,
                                                   reduce)
    if cfg.aux_loss:
        for i, aux in enumerate(outputs.get("aux_outputs", [])):
            a_assign = _match_layer(aux, tgt_spans, span_mask, cfg)
            losses[f"loss_span_{i}"], losses[f"loss_giou_{i}"] = _span_losses(
                aux, tgt_spans, span_mask, a_assign, n)
            losses[f"loss_label_{i}"], losses[f"class_error_{i}"] = _label_loss(
                aux, a_assign, span_mask, neg_outputs, cfg.eos_coef, n, world)
    return losses


def loss_weight_dict(cfg: LossConfig, dec_layers: int) -> dict:
    """Weights of the final weighted sum (cone/model.py:499-511)."""
    w = {
        "loss_span": cfg.span_loss_coef,
        "loss_giou": cfg.giou_loss_coef,
        "loss_label": cfg.label_loss_coef,
        "loss_saliency": cfg.lw_saliency,
    }
    if cfg.adapter_loss:
        w["loss_adapter"] = cfg.adapter_loss_coef
    if cfg.aux_loss:
        for i in range(dec_layers - 1):
            for k in ("loss_span", "loss_giou", "loss_label"):
                w[f"{k}_{i}"] = w[k]
    return w


def total_loss(losses: dict, weights: dict) -> torch.Tensor:
    """Weighted sum over the terms present in both dicts (cone/train.py:68-71)."""
    total = 0.0
    for k, v in losses.items():
        if k in weights:
            total = total + v * weights[k]
    return total
