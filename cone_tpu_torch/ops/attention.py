"""Masked multi-head attention core: softmax((q_h k_h^T) * hd^-0.5, masked
keys at -1e30) v_h per window and head, heads being column blocks of D.

`masked_attention` replaces the TPU kernel tools/bench_attn.py:79
(`pallas_attention`, body `attn_kernel` :57-76) with the hand-written CUDA
kernel csrc/masked_attention.cu. Like its TPU counterpart it is reached
from its own entry point (cone_tpu_torch/tools/bench_attn.py) and not from
the model: models/transformer.py keeps its explicit matmul + softmax.

What bounds it on the card: in bfloat16 the bytes of q, k, v and out; in
float32 the 4*B*H*Lq*Lk*hd operations if they ran on the FMA pipes. The
kernel runs both products on the tensor cores (`mma.sync`: bfloat16 as it
is, float32 as 3xTF32, each operand split into two TF32 parts and three
products summed in fp32), stages a window's Q, K and V once by 16-byte
`cp.async` for a group of heads that fills 256-byte rows (two blocks of
eight warps an SM, so one block's loads overlap the other's products),
keeps a whole row of logits and its softmax in registers, feeds the
weights to P.V without leaving the registers, and writes each head's
columns in place; see the note at the top of the source. `block_plan`
below is the layout the kernel derives from the shape.

Routing is by the tensors' device: CUDA tensors launch the kernel (or
raise), CPU tensors take the plain PyTorch version beside it. There is no
fallback from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

NEG_INF = -1e30             # the package's mask value (models/transformer.py)
MAX_KEYS = 256              # csrc/masked_attention.cu kMaxKeys
MAX_HEAD_DIM = 128          # csrc/masked_attention.cu kMaxHeadDim
HEAD_DIM_MULTIPLE = 16      # the k16 step of mma.sync.m16n8k16
MAX_SMEM_BYTES = 232448     # opt-in dynamic shared memory per block (H100)
_Q_CHUNK = 128              # csrc/masked_attention.cu kQChunk: query rows a block stages
_ROW_BYTES, _PAD_BYTES, _MASK_BYTES = 256, 16, 32    # kRowBytes, kPadBytes, kMaskBytes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def block_plan(lq: int, lk: int, hd: int, nheads: int, itemsize: int) -> dict:
    """The kernel's layout for one shape: a block owns one window, up to 128
    query rows and `heads_per_block` heads (as many as fill a 256-byte row);
    Q, K and V sit in shared memory in their own type, rows padded by 16
    bytes, query rows to a multiple of 16, key rows to the instance's
    16 * `key_tiles` (4, 7, 8 or 16 register tiles of 16 keys for Lk <= 64,
    112, 128, 256; rows past Lk are zero; 7 is there for the fine stage's
    110 tokens); 32 bytes hold the window's mask as bits. Returns heads_per_block, the grid per window (head groups,
    query chunks), `key_tiles` and `smem_bytes`."""
    hb = min(max(_ROW_BYTES // (hd * itemsize), 1), nheads)
    q_rows = 16 * -(-min(lq, _Q_CHUNK) // 16)
    kt = 4 if lk <= 64 else 7 if lk <= 112 else 8 if lk <= 128 else 16
    row = hb * hd * itemsize + _PAD_BYTES
    return dict(heads_per_block=hb, grid=(-(-nheads // hb), -(-lq // _Q_CHUNK)),
                key_tiles=kt, smem_bytes=(q_rows + 32 * kt) * row + _MASK_BYTES)


def smem_bytes(lq: int, lk: int, hd: int, nheads: int, itemsize: int) -> int:
    """Dynamic shared memory one block of the kernel needs."""
    return block_plan(lq, lk, hd, nheads, itemsize)["smem_bytes"]


def _check(q, k, v, key_padding_mask, nheads):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"want q (B, Lq, D), k and v (B, Lk, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, lq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != d or lq < 1 or k.shape[1] < 1:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if int(nheads) < 1 or d % int(nheads):
        raise ValueError(f"D={d} is not a multiple of nheads={nheads}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must all be float32 or all bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"tensors on different devices: {q.device}, {k.device}, {v.device}")
    if key_padding_mask is not None:
        if key_padding_mask.dtype != torch.bool:
            raise TypeError(f"key_padding_mask must be bool, got {key_padding_mask.dtype}")
        if tuple(key_padding_mask.shape) != (b, k.shape[1]):
            raise ValueError(f"key_padding_mask {tuple(key_padding_mask.shape)} != "
                             f"(B, Lk) = {(b, k.shape[1])}")
        if key_padding_mask.device != q.device:
            raise ValueError(f"key_padding_mask on {key_padding_mask.device}, q on {q.device}")


def masked_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           key_padding_mask: Optional[torch.Tensor],
                           nheads: int) -> torch.Tensor:
    """The plain PyTorch version: split heads, scale q, q k^T, masked_fill
    with -1e30, softmax, P v, merge heads. In float32 this is the core of
    models/transformer.py MultiheadAttention.forward, operation for
    operation. For bfloat16 inputs the logits and the softmax stay float32
    and the weights are cast to v's type before P v, as the TPU kernel does.
    Same signature and result as `masked_attention`."""
    _check(q, k, v, key_padding_mask, nheads)
    d, h = q.shape[-1], int(nheads)

    def split(x):
        b, l, _ = x.shape
        return x.reshape(b, l, h, d // h).transpose(1, 2)  # (B, H, L, hd)

    qh, kh, vh = split(q), split(k), split(v)
    logits = (qh.float() * (d // h) ** -0.5) @ kh.float().transpose(-1, -2)
    if key_padding_mask is not None:
        logits = logits.masked_fill(key_padding_mask[:, None, None, :], NEG_INF)
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    out = (weights @ vh).transpose(1, 2)
    return out.reshape(out.shape[0], out.shape[1], d)


def _library():
    from cone_tpu_torch.kernels.build import load_library

    lib = load_library("masked_attention")
    if not getattr(lib, "_argtypes_set", False):
        lib.masked_attention.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
        lib.masked_attention.restype = ctypes.c_int
        lib.masked_attention_smem_bytes.argtypes = [ctypes.c_int] * 5
        lib.masked_attention_smem_bytes.restype = ctypes.c_size_t
        lib.masked_attention_max_keys.restype = ctypes.c_int
        lib.masked_attention_max_head_dim.restype = ctypes.c_int
        lib.masked_attention_error_string.argtypes = [ctypes.c_int]
        lib.masked_attention_error_string.restype = ctypes.c_char_p
        if (lib.masked_attention_max_keys() != MAX_KEYS
                or lib.masked_attention_max_head_dim() != MAX_HEAD_DIM
                or any(lib.masked_attention_smem_bytes(*shape) != smem_bytes(*shape)
                       for shape in ((110, 110, 32, 8, 2), (110, 110, 32, 8, 4),
                                     (40, 60, 64, 4, 2), (300, 256, 128, 3, 2),
                                     (5, 17, 16, 2, 4)))):
            raise RuntimeError("ops/attention.py and csrc/masked_attention.cu disagree "
                               "on the kernel's limits")
        lib._argtypes_set = True
    return lib


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     key_padding_mask: Optional[torch.Tensor],
                     nheads: int) -> torch.Tensor:
    """Masked multi-head attention core.

    Args:
        q: (B, Lq, D) float32 or bfloat16, already projected.
        k, v: (B, Lk, D), same type and device as q.
        key_padding_mask: (B, Lk) bool, True = ignore the key; or None.
        nheads: heads H; head h owns columns [h * D/H, (h + 1) * D/H).

    Returns:
        (B, Lq, D) of q's type. A row whose keys are all masked attends
        uniformly to every key, as masked_fill + softmax does.
    """
    _check(q, k, v, key_padding_mask, nheads)
    if q.device.type == "cpu":
        return masked_attention_plain(q, k, v, key_padding_mask, nheads)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
            and (key_padding_mask is None or key_padding_mask.is_contiguous())):
        raise ValueError("q, k, v and key_padding_mask must be contiguous")
    b, lq, d = q.shape
    lk, h = k.shape[1], int(nheads)
    hd = d // h
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"kernel takes a head width up to {MAX_HEAD_DIM}, got {hd}")
    if lk > MAX_KEYS:
        raise ValueError(f"kernel takes up to {MAX_KEYS} keys, got {lk}")
    if hd % HEAD_DIM_MULTIPLE:
        raise ValueError(f"kernel takes a head width that is a multiple of "
                         f"{HEAD_DIM_MULTIPLE}, got {hd}")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned")
    plan = block_plan(lq, lk, hd, h, q.element_size())
    if plan["smem_bytes"] > MAX_SMEM_BYTES:
        raise ValueError(f"Lq={lq}, Lk={lk}, head width {hd} in {q.dtype} needs "
                         f"{plan['smem_bytes']} bytes of shared memory (> {MAX_SMEM_BYTES})")
    if b >= 2 ** 31 or max(plan["grid"]) > 65535:
        raise ValueError(f"B = {b}, grid {plan['grid']} per window exceeds the launch grid")
    lib = _library()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = lib.masked_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if key_padding_mask is None else key_padding_mask.data_ptr(),
            out.data_ptr(), b, lq, lk, d, h, _DTYPES[q.dtype], hd ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"masked_attention launch failed: CUDA error {rc} "
                           f"({lib.masked_attention_error_string(rc).decode()})")
    masked_attention.launches += 1
    return out


masked_attention.launches = 0
