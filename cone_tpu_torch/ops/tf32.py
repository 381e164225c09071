"""A CPU model of the 3xTF32 products in the CUDA kernels
(csrc/coarse_segment_max.cu, csrc/masked_attention.cu in float32).

A tensor core takes fp32 operands as TF32: 8 exponent bits, 10 mantissa
bits. The kernels keep fp32 accuracy by splitting every operand x into
hi = tf32(x) and lo = tf32(x - hi) and adding three products,
hi*hi + hi*lo + lo*hi, into an fp32 accumulator; the lo*lo term, about
2^-22 of |a||b|, is dropped. The tests use this model to hold that error
under the kernels' stated tolerance at the shapes they run at.
"""

from __future__ import annotations

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as `cvt.rna.tf32.f32` does: to nearest on 10
    mantissa bits, ties away from zero. float32 in, float32 out."""
    if x.dtype != torch.float32:
        raise TypeError(f"round_tf32 takes float32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """(hi, lo) with hi = tf32(x), lo = tf32(x - hi)."""
    hi = round_tf32(x)
    return hi, round_tf32(x - hi)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels compute it: three TF32 products. Each product of
    two TF32 numbers is exact in fp32, so the sums are taken in float64 and
    rounded once: what is left is the error of the split alone."""
    a_hi, a_lo = (t.double() for t in split_tf32(a))
    b_hi, b_lo = (t.double() for t in split_tf32(b))
    return (a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi).float()
