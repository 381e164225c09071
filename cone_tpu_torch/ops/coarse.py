"""Coarse stage: per-stride-segment max of frame <-> query similarity.

`coarse_segment_max` replaces the TPU kernel
cone_tpu/ops/pallas_coarse.py:66 (`coarse_segment_max`, body `_kernel`
:31-62) with the hand-written CUDA kernel csrc/coarse_segment_max.cu.

What bounds it on the card: the bytes of the feature stream. Each frame
row (D fp32) is read once and meets 2*Q*D flops, about 16 flops per byte
at Q = 32, far below the card's fp32 ridge. The kernel therefore streams
the features exactly once with coalesced loads, keeps the query matrix in
shared memory, never writes the (Q, L) score matrix, and masks the ragged
tail itself, so the caller does not copy the stream to pad it (the Pallas
wrapper concatenated zero rows up to its tile).

Routing is by the tensors' device: CUDA tensors launch the kernel (or
raise), CPU tensors take the plain PyTorch version beside it. There is no
fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

NEG_INF = -1e30
MAX_QUERIES = 128           # csrc/coarse_segment_max.cu kMaxQGroups * 32
MAX_SMEM_BYTES = 232448     # opt-in dynamic shared memory per block (H100)


def _check(feats, cls, ctx_l, stride):
    if feats.dim() != 3 or cls.dim() != 3 or ctx_l.dim() != 1:
        raise ValueError(f"want feats (B, L, D), cls (B, Q, D), ctx_l (B,); got "
                         f"{tuple(feats.shape)}, {tuple(cls.shape)}, {tuple(ctx_l.shape)}")
    b, _, d = feats.shape
    if cls.shape[0] != b or cls.shape[2] != d or ctx_l.shape[0] != b:
        raise ValueError(f"shape mismatch: feats {tuple(feats.shape)}, cls "
                         f"{tuple(cls.shape)}, ctx_l {tuple(ctx_l.shape)}")
    if feats.dtype != torch.float32 or cls.dtype != torch.float32:
        raise TypeError(f"feats and cls must be float32, got {feats.dtype}, {cls.dtype}")
    if ctx_l.dtype != torch.int32:
        raise TypeError(f"ctx_l must be int32, got {ctx_l.dtype}")
    if not (feats.device == cls.device == ctx_l.device):
        raise ValueError(f"tensors on different devices: {feats.device}, "
                         f"{cls.device}, {ctx_l.device}")
    if int(stride) < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")


def coarse_segment_max_plain(feats: torch.Tensor, cls: torch.Tensor,
                             ctx_l: torch.Tensor, stride: int) -> torch.Tensor:
    """The plain PyTorch version: masked cls @ feats^T, then a max over each
    stride segment. Same signature and result as `coarse_segment_max`."""
    _check(feats, cls, ctx_l, stride)
    b, l_pad, _ = feats.shape
    n_seg = -(-l_pad // stride)
    scores = torch.matmul(cls, feats.transpose(1, 2))   # (B, Q, L)
    idx = torch.arange(l_pad, device=feats.device)
    scores = torch.where(idx < ctx_l[:, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    scores = F.pad(scores, (0, n_seg * stride - l_pad), value=NEG_INF)
    return scores.view(b, cls.shape[1], n_seg, stride).amax(-1)


def _library():
    from cone_tpu_torch.kernels.build import load_library

    lib = load_library("coarse_segment_max")
    if not getattr(lib, "_argtypes_set", False):
        lib.coarse_segment_max_f32.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.coarse_segment_max_f32.restype = ctypes.c_int
        lib.coarse_segment_max_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.coarse_segment_max_smem_bytes.restype = ctypes.c_size_t
        lib.coarse_cuda_error_string.argtypes = [ctypes.c_int]
        lib.coarse_cuda_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def coarse_segment_max(feats: torch.Tensor, cls: torch.Tensor,
                       ctx_l: torch.Tensor, stride: int) -> torch.Tensor:
    """Per-stride-segment max similarity.

    Args:
        feats: (B, L_pad, D) float32 adapted, L2-normalized video features.
        cls: (B, Q, D) float32 query CLS features.
        ctx_l: (B,) int32 valid frame counts, on the same device.
        stride: segment length (max_v_l // 2).

    Returns:
        (B, Q, ceil(L_pad / stride)) float32; a segment with no frame below
        ctx_l is -1e30.
    """
    _check(feats, cls, ctx_l, stride)
    if feats.device.type == "cpu":
        return coarse_segment_max_plain(feats, cls, ctx_l, stride)
    if feats.device.type != "cuda":
        raise ValueError(f"no coarse kernel for device {feats.device}")
    if not (feats.is_contiguous() and cls.is_contiguous() and ctx_l.is_contiguous()):
        raise ValueError("feats, cls and ctx_l must be contiguous")
    b, l_pad, d = feats.shape
    q = cls.shape[1]
    if d % 4 or feats.data_ptr() % 16 or cls.data_ptr() % 16:
        raise ValueError(f"kernel needs D % 4 == 0 and 16-byte aligned rows (D={d})")
    if not 1 <= q <= MAX_QUERIES:
        raise ValueError(f"kernel takes 1..{MAX_QUERIES} queries, got {q}")
    lib = _library()
    smem = lib.coarse_segment_max_smem_bytes(q, d)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"Q={q}, D={d} needs {smem} bytes of shared memory "
                         f"(> {MAX_SMEM_BYTES})")
    n_seg = -(-l_pad // stride)
    out = torch.empty((b, q, n_seg), dtype=torch.float32, device=feats.device)
    with torch.cuda.device(feats.device):
        rc = lib.coarse_segment_max_f32(
            feats.data_ptr(), cls.data_ptr(), ctx_l.data_ptr(), out.data_ptr(),
            b, l_pad, d, q, int(stride), n_seg,
            torch.cuda.current_stream(feats.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"coarse_segment_max launch failed: CUDA error {rc} "
                           f"({lib.coarse_cuda_error_string(rc).decode()})")
    coarse_segment_max.launches += 1
    return out


coarse_segment_max.launches = 0


def window_scores_from_segment_max(seg_max: torch.Tensor, ctx_l, stride: int,
                                   max_windows: int):
    """Combine adjacent segment maxes into window scores: window i covers
    segments {i-1, i} clipped to [0, H), H = ceil(ctx_l / stride) (see
    ops/windows.py). seg_max (..., n_seg); ctx_l an int or a tensor
    broadcastable to seg_max.shape[:-1]. Returns (scores, valid), both
    (..., max_windows), invalid slots scored -1e30."""
    n_seg = seg_max.shape[-1]
    dev = seg_max.device
    h = (-(-torch.as_tensor(ctx_l, device=dev) // stride))[..., None]
    w_idx = torch.arange(max_windows, device=dev)
    j1 = torch.minimum((w_idx - 1).clamp(min=0), h - 1).clamp(max=n_seg - 1)
    j2 = torch.minimum(w_idx, h - 1).clamp(max=n_seg - 1)
    lead = seg_max.shape[:-1]
    j1 = j1.expand(*lead, max_windows)
    j2 = j2.expand(*lead, max_windows)
    scores = torch.maximum(torch.gather(seg_max, -1, j1), torch.gather(seg_max, -1, j2))
    valid = (w_idx < h + 1).expand(*lead, max_windows)
    return torch.where(valid, scores, torch.full_like(scores, NEG_INF)), valid
