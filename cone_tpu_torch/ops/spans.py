"""Temporal span geometry on tensors (cone/span_utils.py semantics).

Spans come in two formats, last dim 2:
  xx  = (start, end)
  cxw = (center, width)
All functions broadcast over leading dims.
"""

from __future__ import annotations

import torch


def span_xx_to_cxw(xx_spans: torch.Tensor) -> torch.Tensor:
    """(..., 2) (st, ed) -> (..., 2) (center, width)."""
    center = xx_spans.sum(-1) * 0.5
    width = xx_spans[..., 1] - xx_spans[..., 0]
    return torch.stack([center, width], dim=-1)


def span_cxw_to_xx(cxw_spans: torch.Tensor) -> torch.Tensor:
    """(..., 2) (center, width) -> (..., 2) (st, ed)."""
    x1 = cxw_spans[..., 0] - 0.5 * cxw_spans[..., 1]
    x2 = cxw_spans[..., 0] + 0.5 * cxw_spans[..., 1]
    return torch.stack([x1, x2], dim=-1)


def temporal_iou(spans1: torch.Tensor, spans2: torch.Tensor):
    """Pairwise IoU of (..., N, 2) and (..., M, 2) xx spans -> (iou, union),
    (..., N, M); leading dims broadcast."""
    areas1 = spans1[..., 1] - spans1[..., 0]
    areas2 = spans2[..., 1] - spans2[..., 0]
    left = torch.maximum(spans1[..., :, None, 0], spans2[..., None, :, 0])
    right = torch.minimum(spans1[..., :, None, 1], spans2[..., None, :, 1])
    inter = (right - left).clamp(min=0)
    union = areas1[..., :, None] + areas2[..., None, :] - inter
    return inter / union, union


def generalized_temporal_iou(spans1: torch.Tensor, spans2: torch.Tensor) -> torch.Tensor:
    """Pairwise 1-D generalized IoU, (..., N, M); leading dims broadcast."""
    spans1, spans2 = spans1.float(), spans2.float()
    iou, union = temporal_iou(spans1, spans2)
    left = torch.minimum(spans1[..., :, None, 0], spans2[..., None, :, 0])
    right = torch.maximum(spans1[..., :, None, 1], spans2[..., None, :, 1])
    enclosing = (right - left).clamp(min=0)
    return iou - (enclosing - union) / enclosing


def round4_device(x: torch.Tensor) -> torch.Tensor:
    """Decimal 4-dp rounding on the device, valid at MAD time magnitudes.

    A naive fp32 round(x * 1e4) / 1e4 loses the .5 boundary once x * 1e4
    passes 2^23 (any timestamp past ~839 s). Splitting off the integer part
    keeps the scaled fraction below 1e4. torch.round rounds half to even,
    like the JAX package's jnp.round."""
    i = torch.floor(x)
    return i + torch.round((x - i) * 1e4) / 1e4
