"""Sliding-window geometry and coarse window scoring.

Windows over a video of `ctx_l` clips (cone/ego4d_mad_dataloader.py:142-159):

    stride     = max_v_l // 2
    num_window = ceil(ctx_l / stride) + 1
    window i   = [max((i-1)*stride, 0), min((i-1)*stride + max_v_l, ctx_l))

Consecutive windows share a half, so the per-window max over frames is a
max over stride segments followed by a pairwise max of adjacent segments.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from cone_tpu_torch.ops.coarse import NEG_INF, window_scores_from_segment_max


def num_windows(ctx_l: int, stride: int) -> int:
    """ceil(ctx_l / stride) + 1 (host-side int math)."""
    return math.ceil(ctx_l / stride) + 1


def window_bounds(window_idx, stride: int, max_v_l: int, ctx_l):
    """Start/end clip indices of window(s) `window_idx` (int or tensor)."""
    if isinstance(window_idx, torch.Tensor):
        start = ((window_idx - 1) * stride).clamp(min=0)
        end = torch.minimum((window_idx - 1) * stride + max_v_l,
                            torch.as_tensor(ctx_l, device=window_idx.device))
        return start, end
    return max((window_idx - 1) * stride, 0), min((window_idx - 1) * stride + max_v_l, ctx_l)


def window_scores_from_frame_scores(frame_scores: torch.Tensor, ctx_l,
                                    stride: int, max_windows: int):
    """Per-window max of frame scores for every window at once.

    Args:
        frame_scores: (..., L_pad); frames at positions >= ctx_l are ignored.
        ctx_l: int or tensor broadcastable to frame_scores.shape[:-1].
        stride: max_v_l // 2.
        max_windows: window slots to emit (>= num_windows(ctx_l, stride)).

    Returns:
        (scores, valid), both (..., max_windows): invalid slots score
        -1e30; valid is True for i < ceil(ctx_l / stride) + 1.
    """
    l_pad = frame_scores.shape[-1]
    n_seg = -(-l_pad // stride)
    ctx = torch.as_tensor(ctx_l, device=frame_scores.device)
    idx = torch.arange(l_pad, device=frame_scores.device)
    masked = torch.where(idx < ctx[..., None], frame_scores,
                         torch.full_like(frame_scores, NEG_INF))
    masked = F.pad(masked, (0, n_seg * stride - l_pad), value=NEG_INF)
    seg_max = masked.view(*masked.shape[:-1], n_seg, stride).amax(-1)
    return window_scores_from_segment_max(seg_max, ctx, stride, max_windows)


def coarse_window_scores(feats: torch.Tensor, cls: torch.Tensor, ctx_l: torch.Tensor,
                         stride: int, max_windows: int):
    """The plain coarse scoring (cone/inference.py:276-299): query rows cls
    (B, Q, D), or (Q, D) shared by every video, against frames feats
    (B, L_pad, D) of videos with ctx_l (B,) clips, then the per-window max.
    Returns (scores, valid), both (B, Q, max_windows)."""
    return window_scores_from_frame_scores(cls @ feats.transpose(1, 2), ctx_l[:, None],
                                           stride, max_windows)


def slice_windows(features: torch.Tensor, window_idx: torch.Tensor,
                  stride: int, max_v_l: int, ctx_l):
    """Gather windows out of padded video features as one fixed-shape batch.

    Args:
        features: (L_pad, D) with a scalar ctx_l, or (B, L_pad, D) with
            window_idx (B, ...) and ctx_l (B,).
        window_idx: int window indices; padded slots are tracked by the
            caller's own window-valid mask.

    Returns:
        feats   (..., max_v_l, D) windows, zeroed past their length,
        mask    (..., max_v_l) float32 1/0 validity,
        starts  (...) int32 window start clip index,
        lengths (...) int32 window length in clips.
    """
    if features.dim() == 2:
        out = slice_windows(features[None], window_idx[None], stride, max_v_l,
                            torch.as_tensor(ctx_l, device=features.device).reshape(1))
        return tuple(x[0] for x in out)
    b = features.shape[0]
    lead = (b,) + (1,) * (window_idx.dim() - 1)
    ctx = torch.as_tensor(ctx_l, device=features.device).reshape(lead)
    video = torch.arange(b, device=features.device).reshape(lead)
    (feats,), mask, start, length = slice_windows_flat((features,), video, window_idx, ctx,
                                                       stride, max_v_l)
    return feats, mask, start, length


def slice_windows_flat(stacks, video, window_idx: torch.Tensor, ctx_l, stride: int,
                       max_v_l: int):
    """Gather windows of many videos out of stacked (V, L_pad, D_i) tensors.

    slice_windows with a per-window video row: window n is window
    `window_idx[n]` of video `video[n]` of the stack, whose length is
    `ctx_l[n]`. Each tensor of `stacks` (the first one a tensor, a later
    None passes through) is gathered at the same rows, so encoded features
    and their per-frame scales come out together and decode after the
    gather. video and ctx_l broadcast to window_idx.

    Returns (list of (..., max_v_l, D_i) windows zeroed past their length,
    mask (..., max_v_l) float32, starts (...) int32, lengths (...) int32).
    """
    v, l_pad = stacks[0].shape[:2]
    dev = stacks[0].device
    start = ((window_idx - 1) * stride).clamp(min=0)
    end = torch.minimum((window_idx - 1) * stride + max_v_l, ctx_l)
    pos = start[..., None] + torch.arange(max_v_l, device=dev)
    mask = (pos < end[..., None]).float()
    row = pos.clamp(0, l_pad - 1) + (video * l_pad)[..., None]
    out = [None if x is None else x.reshape(v * l_pad, x.shape[-1])[row] * mask[..., None]
           for x in stacks]
    return out, mask, start.int(), (end - start).int()
