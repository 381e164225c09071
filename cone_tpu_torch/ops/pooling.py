"""Masked segment mean-pooling for proposal features and the matching
scores built on it (cone/model.py:130-210), as batched matmuls.

The pooled sums must be true fp32: on the card that needs TF32 off for
matmuls, which utils/device.resolve_device sees to.
"""

from __future__ import annotations

import torch

from cone_tpu_torch.ops.spans import span_cxw_to_xx


def masked_segment_mean(features: torch.Tensor, start: torch.Tensor,
                        end: torch.Tensor) -> torch.Tensor:
    """Mean of features[b, start[b, k]:end[b, k], :] for every (b, k).

    features (B, L, D); start/end (B, K) int, end exclusive. Empty
    segments (end <= start) yield zeros. Returns (B, K, D)."""
    pos = torch.arange(features.shape[1], device=features.device)
    seg = ((pos >= start[..., None]) & (pos < end[..., None])).to(features.dtype)
    count = seg.sum(-1, keepdim=True).clamp(min=1.0)
    return torch.bmm(seg, features) / count


def proposal_mean_pool(vid_appear: torch.Tensor, vid_appear_mask: torch.Tensor,
                       pred_spans_cxw: torch.Tensor) -> torch.Tensor:
    """Pool appearance features inside each predicted proposal
    (cone/model.py:186-200): spans scale by the valid window length (mask
    sum), start = max(floor(st), 0), end = ceil(ed). Returns (B, NQ, D)."""
    duration = vid_appear_mask.sum(-1)
    prop = span_cxw_to_xx(pred_spans_cxw) * duration[:, None, None]
    start = torch.floor(prop[..., 0]).clamp(min=0.0).int()
    end = torch.ceil(prop[..., 1]).int()
    return masked_segment_mean(vid_appear, start, end)


def matching_embeds_gt(adapt_fn, src_cls_txt, src_vid_appear, proposal_start,
                       proposal_end):
    """The two unit-norm sides of the GT-proposal matching: (B, D) adapted
    proposal features and (B, D) text CLS (cone/model.py:130-148).
    `adapt_fn` is the residual adapter."""
    text = src_cls_txt / torch.linalg.vector_norm(src_cls_txt, dim=1, keepdim=True)
    pooled = masked_segment_mean(src_vid_appear, proposal_start[:, None],
                                 proposal_end[:, None])[:, 0]
    prop = adapt_fn(pooled)
    return prop / torch.linalg.vector_norm(prop, dim=1, keepdim=True), text


def matching_sim_gt(adapt_fn, src_cls_txt, src_vid_appear, proposal_start,
                    proposal_end):
    """GT-proposal <-> text CLS similarity matrix (B, B)
    (cone/model.py:130-148)."""
    prop, text = matching_embeds_gt(adapt_fn, src_cls_txt, src_vid_appear,
                                    proposal_start, proposal_end)
    return prop @ text.T


def matching_scores_pred(adapt_fn, src_cls_txt, pooled):
    """(B, K, D) pooled proposal features -> (B, K) cosine matching scores,
    with a safe normalize: empty proposals pool to exact zeros and score 0."""
    text = src_cls_txt / torch.linalg.vector_norm(src_cls_txt, dim=1, keepdim=True)
    prop = adapt_fn(pooled)
    n2 = (prop * prop).sum(2, keepdim=True)
    prop = torch.where(n2 > 0, prop * torch.rsqrt(torch.where(n2 > 0, n2, 1.0)),
                       torch.zeros_like(prop))
    return torch.bmm(prop, text[:, :, None])[..., 0]
