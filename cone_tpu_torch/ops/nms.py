"""Temporal non-maximum suppression (utils/temporal_nms.py:25-74 semantics).

  * `temporal_nms_host`   numpy, reference-exact (hull-union IoU, stable
    descending sort). The submission path where bit parity matters.
  * `temporal_nms_device` tensors, batched over any leading axes, the same
    greedy decisions as fixed-shape masked suppression.
"""

from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30


def _iou_np(head: np.ndarray, rest: np.ndarray, hull: bool) -> np.ndarray:
    """IoU of `head` (2,) vs `rest` (N, 2); hull=True uses the reference's
    union max(ed) - min(st), hull=False the standard union."""
    inter = np.maximum(
        0.0, np.minimum(head[1], rest[:, 1]) - np.maximum(head[0], rest[:, 0]))
    if hull:
        union = np.maximum(head[1], rest[:, 1]) - np.minimum(head[0], rest[:, 0])
    else:
        union = (head[1] - head[0]) + (rest[:, 1] - rest[:, 0]) - inter
    out = np.zeros_like(inter)
    nz = union != 0
    out[nz] = inter[nz] / union[nz]
    return out


def temporal_nms_host(predictions, nms_thd: float, max_after_nms: int = 100,
                      hull_union: bool = True):
    """Greedy NMS over [st, ed, score] triplets; returns the kept triplets
    in descending score order, at most `max_after_nms`."""
    if len(predictions) == 1:
        return list(predictions)

    preds = sorted(predictions, key=lambda x: x[2], reverse=True)
    arr = np.asarray([p[:2] for p in preds], dtype=np.float64)
    alive = np.ones(len(preds), dtype=bool)
    kept = []
    idxs = np.arange(len(preds))
    while alive.sum() > 1 and len(kept) < max_after_nms:
        cur = idxs[alive][0]
        rest = idxs[alive][1:]
        iou = _iou_np(arr[cur], arr[rest], hull_union)
        alive[rest[iou > nms_thd]] = False
        alive[cur] = False
        kept.append(cur)
    if len(kept) < max_after_nms and alive.sum() >= 1:
        kept.append(idxs[alive][0])
    return [preds[i] for i in kept]


def _take(x: torch.Tensor, idx: torch.Tensor, dim: int) -> torch.Tensor:
    """take_along_axis: `idx` indexes `dim` of `x`; a trailing dim of `x`
    beyond idx's rank is carried along."""
    if x.dim() > idx.dim():
        idx = idx[..., None].expand(*idx.shape, x.shape[-1])
    return torch.gather(x, dim, idx)


def dedup_spans_device(spans, scores_list, valid):
    """The reference's dict dedup (cone/inference.py:214-216) on tensors:
    candidates sharing an identical (st, ed) collapse to ONE entry at the
    FIRST occurrence's slot carrying the LAST occurrence's scores.

    spans (..., P, 2) already 4-dp rounded (so float equality is the dict
    key equality); scores_list: (..., P) tensors rewritten in lockstep;
    valid (..., P) bool. Returns (new_scores_tuple, new_valid)."""
    st, ed = spans[..., 0], spans[..., 1]
    same = ((st[..., :, None] == st[..., None, :])
            & (ed[..., :, None] == ed[..., None, :])
            & valid[..., :, None] & valid[..., None, :])
    p = spans.shape[-2]
    idx = torch.arange(p, device=spans.device)
    first = torch.where(same, idx, p).amin(-1)
    last = torch.where(same, idx, -1).amax(-1).clamp(min=0)
    keep = valid & (first == idx)
    return tuple(torch.gather(s, -1, last) for s in scores_list), keep


def temporal_nms_device(spans: torch.Tensor, scores: torch.Tensor,
                        valid: torch.Tensor, nms_thd: float, max_after_nms: int,
                        hull_union: bool = True, max_before_nms: int | None = None):
    """Batched greedy NMS.

    Args:
        spans (..., P, 2), scores (..., P), valid (..., P) bool.
        nms_thd: -1 is the reference's no-NMS sentinel (keep score order);
            any other value suppresses like the host path.
        max_after_nms: K kept slots.
        max_before_nms: with suppression on, only the top-`max_before_nms`
            candidates enter NMS at all (the host path's truncation).

    Returns:
        (kept_spans (..., K, 2), kept_scores (..., K), kept_valid (..., K))
        in descending score order, missing slots invalid.

    The pairwise suppression matrix is built once; the greedy scan is then
    P steps of two small elementwise launches each on (..., P) masks.
    """
    p = scores.shape[-1]
    dev = scores.device
    neg = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    order = torch.argsort(-neg, dim=-1, stable=True)
    s_spans = _take(spans, order, -2)
    s_scores = torch.gather(neg, -1, order)
    keep = torch.gather(valid, -1, order)

    if nms_thd != -1:
        if max_before_nms is not None and max_before_nms < p:
            keep = keep & (torch.arange(p, device=dev) < max_before_nms)
        st, ed = s_spans[..., 0], s_spans[..., 1]
        hs, he = st[..., :, None], ed[..., :, None]   # row i = head i
        inter = (torch.minimum(he, ed[..., None, :])
                 - torch.maximum(hs, st[..., None, :])).clamp(min=0)
        if hull_union:
            union = torch.maximum(he, ed[..., None, :]) - torch.minimum(hs, st[..., None, :])
        else:
            union = (he - hs) + (ed - st)[..., None, :] - inter
        iou = torch.where(union != 0, inter / torch.where(union == 0, 1.0, union),
                          torch.zeros_like(inter))
        later = torch.ones(p, p, dtype=torch.bool, device=dev).triu(1)
        sup = (iou > nms_thd) & later
        for i in range(p):
            keep.masked_fill_(keep[..., i, None] & sup[..., i, :], False)

    # compact the kept entries to the front, preserving score order
    kept_rank = keep.int().cumsum(-1) - 1
    slot = torch.where(keep, kept_rank, p)
    ar = torch.arange(p, device=dev)
    take = torch.argsort(torch.where(slot < max_after_nms, slot, p + ar),
                         dim=-1, stable=True)[..., :max_after_nms]
    out_valid = torch.gather(keep & (slot < max_after_nms), -1, take)
    return _take(s_spans, take, -2), torch.gather(s_scores, -1, take), out_valid
