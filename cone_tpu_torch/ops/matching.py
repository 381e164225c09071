"""Exact Hungarian matching on the device by permutation enumeration
(cone/matcher.py:61-105 semantics).

The reference solves each (num_queries x num_targets) linear-sum assignment
with scipy on the host, a device-to-host sync every training step. With
num_queries <= 6 (default 5) the assignment polytope is tiny: scoring all
num_queries! query permutations (<= 720) with one masked gather-sum and
taking the argmin is exact, shape-static and stays on the device.

Cost (cone/matcher.py:61-95):
    C = cost_span * L1(pred_cxw, tgt_cxw)
      + cost_giou * (-gIoU(pred_xx, tgt_xx))
      + cost_class * (-softmax(pred_logits)[foreground])
"""

from __future__ import annotations

import functools
import itertools

import torch

from cone_tpu_torch.ops.spans import generalized_temporal_iou, span_cxw_to_xx

@functools.lru_cache(maxsize=16)
def permutations(n: int, device: torch.device) -> torch.Tensor:
    """(n!, n) int64 table of every permutation of range(n) in lexicographic
    order, built once per (n, device) and kept on the device."""
    return torch.tensor(list(itertools.permutations(range(n))), dtype=torch.int64,
                        device=device)


def safe_target_spans(spans: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """cxw spans (..., 2) with every slot where mask (...) is 0 replaced by
    the unit span (0.5, 1.0)."""
    real = mask > 0
    return torch.stack([torch.where(real, spans[..., 0], 0.5),
                        torch.where(real, spans[..., 1], 1.0)], dim=-1)


def hungarian_match(cost: torch.Tensor, tgt_mask: torch.Tensor) -> torch.Tensor:
    """Solve the LSAP exactly for every batch element.

    cost (B, NQ, NT), NT <= NQ (pad targets and mark them in tgt_mask);
    tgt_mask (B, NT), 1 for real targets. Returns assign (B, NT) int64:
    the query matched to target j (meaningless where tgt_mask is 0). Among
    equal-cost optima the lexicographically smallest permutation wins:
    argmin returns the first minimum on the CPU and on CUDA alike."""
    b, nq, nt = cost.shape
    if nt > nq:
        raise ValueError(f"pad or clamp targets to <= num_queries ({nt} > {nq})")
    perm_t = permutations(nq, cost.device)[:, :nt]  # (P, NT): query of target j
    # total[b, p] = sum_j cost[b, perm_t[p, j], j] * tgt_mask[b, j]
    picked = cost[:, perm_t, torch.arange(nt, device=cost.device)]  # (B, P, NT)
    total = (picked * tgt_mask.to(cost.dtype)[:, None, :]).sum(-1)  # (B, P)
    return perm_t[total.argmin(dim=1)]


def matcher_cost(pred_spans: torch.Tensor, pred_logits: torch.Tensor,
                 tgt_spans: torch.Tensor, cost_span: float = 10.0,
                 cost_giou: float = 1.0, cost_class: float = 4.0,
                 foreground_label: int = 0,
                 tgt_mask: torch.Tensor = None) -> torch.Tensor:
    """Per-sample matching cost (B, NQ, NT) from pred_spans (B, NQ, 2) cxw,
    pred_logits (B, NQ, 2) and tgt_spans (B, NT, 2) cxw (padded). Built per
    batch element; the reference's all-pairs cost over the flattened batch
    sliced back to its block diagonal gives the same numbers."""
    prob_fg = pred_logits.softmax(-1)[..., foreground_label]  # (B, NQ)
    if tgt_mask is not None:
        # padded target slots are degenerate (0, 0) spans; against a
        # prediction whose sigmoid width underflowed to exactly 0, gIoU is
        # 0/0 = NaN, and in hungarian_match every permutation total becomes
        # NaN through `cost * mask` (0 * NaN = NaN). Substitute a safe unit span.
        tgt_spans = safe_target_spans(tgt_spans, tgt_mask)
    l1 = (pred_spans[:, :, None, :] - tgt_spans[:, None, :, :]).abs().sum(-1)
    giou = generalized_temporal_iou(span_cxw_to_xx(pred_spans), span_cxw_to_xx(tgt_spans))
    return cost_span * l1 - cost_giou * giou - cost_class * prob_fg[:, :, None]
