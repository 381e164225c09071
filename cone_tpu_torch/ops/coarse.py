"""Coarse stage: per-stride-segment max of frame <-> query similarity.

`coarse_segment_max` replaces the TPU kernel
cone_tpu/ops/pallas_coarse.py:66 (`coarse_segment_max`, body `_kernel`
:31-62) with the hand-written CUDA kernel csrc/coarse_segment_max.cu.

What bounds it on the card: the bytes of the feature stream. Each frame
row (D fp32) is read once and meets 2*Q*D flops, about 16 flops per byte
at Q = 32. To stay near that bound the product must not be the slower
part, so the kernel computes it on the tensor cores as 3xTF32 (each fp32
operand split into two TF32 parts, three `mma.sync` products summed in
fp32), streams the frames through `cp.async` rings, and gives
a block a run of consecutive segments so that the query matrix is staged
once per block; each warp streams its own 16-frame tiles through a ring of
its own (two chunks in flight, one being multiplied), with no block-wide
barrier in the loop. `plan` below sizes the
run (one segment per block while the grid does not fill the card, as at
Ego4D; several at MAD) and `layout` mirrors what the launcher derives
from the shape. The (Q, L) scores
never reach device memory, and the kernel masks the ragged tail and
`ctx_l` itself, so the caller does not copy the stream to pad it (the
Pallas wrapper concatenated zero rows up to its tile).

Routing is by the tensors' device: CUDA tensors launch the kernel (or
raise), CPU tensors take the plain PyTorch version beside it. There is no
fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

NEG_INF = -1e30
MAX_QUERIES = 128           # csrc/coarse_segment_max.cu kMaxQ
MAX_SMEM_BYTES = 232448     # opt-in dynamic shared memory per block (H100)
_TILE_COLS, _STAGE_FLOATS, _STAGES = 32, 16 * 36, 3   # kTileD, kStageFloats, kStages


def layout(q: int, d: int, l_pad: int, stride: int, segs_per_block: int) -> dict:
    """The kernel's layout for one shape, as its launcher derives it.

    A warp's work item is 16 frames x `ntw` 8-query tiles. `ntw` starts at
    all query tiles (rounded up to a power of two: the template instance)
    and is halved while every (frame tile, query group) item of a block's
    run still gets a warp of its own, so a short run (Ego4D: one 45-frame
    segment) spreads over the block's warps by queries, as long as shared
    memory holds the layout. `warps` is 16 while
    a warp's sums fit (ntw <= 4), else 8. Shared memory holds the query
    matrix (rows padded to whole items, columns to the 32-column chunk + 4),
    the run's (segment, query) maxima and, per warp, a ring of three
    16-frame chunks. A shape whose `smem_bytes` exceed a block's limit
    is refused by the wrapper."""
    n_qt = -(-q // 8)

    def with_ntw(ntw):
        warps = 16 if ntw <= 4 else 8
        qpad = -(-n_qt // ntw) * ntw * 8
        cls_ld = -(-d // _TILE_COLS) * _TILE_COLS + 4
        return dict(ntw=ntw, warps=warps,
                    smem_bytes=4 * (qpad * cls_ld + segs_per_block * qpad
                                    + warps * _STAGES * _STAGE_FLOATS))

    ntw = 1
    while ntw < n_qt:
        ntw *= 2
    m_tiles = -(-min(segs_per_block * stride, l_pad) // 16)
    while ntw > 1:
        half = with_ntw(ntw // 2)
        if m_tiles * -(-n_qt // (ntw // 2)) > half["warps"] \
                or half["smem_bytes"] > MAX_SMEM_BYTES:
            break
        ntw //= 2
    return with_ntw(ntw)


def plan(n_seg: int, b: int, n_sm: int = 132) -> dict:
    """How the launch is cut: `segs_per_block` consecutive segments of one
    video per block, one block per SM, so that the whole grid is resident
    at once and every block stages the queries once. While `n_seg * b`
    blocks fit on the card a block owns one segment."""
    spb = min(n_seg, max(1, -(-(n_seg * b) // n_sm)))
    return dict(segs_per_block=spb, grid=(-(-n_seg // spb), b))


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
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.coarse_segment_max_f32.restype = ctypes.c_int
        lib.coarse_segment_max_layout.argtypes = (
            [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)] * 2
            + [ctypes.POINTER(ctypes.c_size_t)])
        lib.coarse_segment_max_layout.restype = None
        lib.coarse_cuda_error_string.argtypes = [ctypes.c_int]
        lib.coarse_cuda_error_string.restype = ctypes.c_char_p
        for shape in ((32, 256, 2304, 45, 1), (32, 512, 36864, 62, 5), (5, 16, 90, 45, 2),
                      (128, 100, 4000, 7, 40), (40, 64, 520, 45, 4), (128, 512, 200, 45, 1)):
            ntw, warps, nbytes = ctypes.c_int(), ctypes.c_int(), ctypes.c_size_t()
            lib.coarse_segment_max_layout(*shape, ntw, warps, nbytes)
            if dict(ntw=ntw.value, warps=warps.value, smem_bytes=nbytes.value) \
                    != layout(*shape):
                raise RuntimeError("ops/coarse.py and csrc/coarse_segment_max.cu disagree "
                                   f"on the kernel's layout at {shape}")
        lib._argtypes_set = True
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=256)
def _segs_per_block(b, q, l_pad, d, stride, segs_per_block, n_sm) -> int:
    """The run length of one launch, checked against the kernel's limits;
    cached by shape, since a serving path repeats a few shapes."""
    n_seg = -(-l_pad // stride)
    spb = plan(n_seg, b, n_sm)["segs_per_block"] if segs_per_block is None \
        else int(segs_per_block)
    if not 1 <= spb <= n_seg:
        raise ValueError(f"segs_per_block must be in 1..{n_seg}, got {spb}")
    smem = layout(q, d, l_pad, stride, spb)["smem_bytes"]
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"Q={q}, D={d}, {spb} segments per block needs {smem} bytes of "
                         f"shared memory (> {MAX_SMEM_BYTES})")
    return spb


def coarse_segment_max(feats: torch.Tensor, cls: torch.Tensor,
                       ctx_l: torch.Tensor, stride: int,
                       segs_per_block: int | None = None) -> torch.Tensor:
    """Per-stride-segment max similarity.

    Args:
        feats: (B, L_pad, D) float32 adapted, L2-normalized video features.
        cls: (B, Q, D) float32 query CLS features.
        ctx_l: (B,) int32 valid frame counts, on the same device.
        stride: segment length (max_v_l // 2).
        segs_per_block: overrides `plan`'s run length (kernel only; for
            measurements and tests of the run's seams).

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
    if b > 65535:
        raise ValueError(f"kernel takes up to 65535 videos per launch, got {b}")
    n_seg = -(-l_pad // stride)
    dev_index = feats.device.index if feats.device.index is not None \
        else torch.cuda.current_device()
    spb = _segs_per_block(b, q, l_pad, d, int(stride), segs_per_block, _sm_count(dev_index))
    lib = _library()
    out = torch.empty((b, q, n_seg), dtype=torch.float32, device=feats.device)
    with torch.cuda.device(feats.device):
        rc = lib.coarse_segment_max_f32(
            feats.data_ptr(), cls.data_ptr(), ctx_l.data_ptr(), out.data_ptr(),
            b, l_pad, d, q, int(stride), n_seg, spb,
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
