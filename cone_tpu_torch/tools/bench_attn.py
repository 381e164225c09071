"""The masked-attention kernel against the explicit matmul + softmax, at the
fine stage's serving shape (counterpart of tools/bench_attn.py).

    python -m cone_tpu_torch.tools.bench_attn [--device cuda] [--seed 0]

For float32 and bfloat16 at B windows x L tokens x D channels x H heads
(default 640 x 110 x 256 x 8, the Ego4D fine stage), with key-padding
lengths drawn from 60..L: the kernel's error against the plain version, the
CUDA-event times of the kernel (ops/attention.masked_attention), of the
plain version and, as a yardstick only, of one
F.scaled_dot_product_attention call with an additive float mask, beside
the analytic bound of the shape on this card. Prints one JSON line.

On the CPU (--device cpu) the wrapper takes the plain version and no time
is reported: a device time comes only from the card.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch
import torch.nn.functional as F

from cone_tpu_torch.ops import attention as at
from cone_tpu_torch.utils.device import card_peaks, cuda_ms, resolve_device

# kernel vs plain on the card. float32: fp32 sums in another order and expf,
# relative to max(1, |want|.max()). bfloat16, unit-variance inputs: one bf16
# rounding of the weights and one of the output.
F32_REL_TOL = 1e-5
BF16_ATOL = 2e-2
SHAPE = (640, 110, 256, 8)  # B, L, D, H: the Ego4D fine-stage serving shape


def tolerance(dtype, want) -> float:
    if dtype == torch.float32:
        return F32_REL_TOL * max(1.0, float(want.abs().max()))
    return BF16_ATOL


def make_inputs(b, lq, lk, d, dtype, device, seed=0, min_len=60):
    """q, k, v ~ N(0, 1) and a key-padding mask with lengths in
    min_len..Lk (clipped to 1..Lk), all from numpy with a seed."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(b, lq, d)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(b, lk, d)).astype(np.float32))
            for _ in range(2))
    lens = rng.integers(max(1, min(min_len, lk)), lk + 1, b)
    mask = torch.from_numpy(np.arange(lk)[None] >= lens[:, None])
    return (*(x.to(device=device, dtype=dtype) for x in (q, k, v)), mask.to(device))


def bound_ms(b, lq, lk, d, h, dtype, peaks):
    """The least time the card could take: q, k, v, mask read once and out
    written once over the memory rate, against 4 B H Lq Lk hd operations
    over the peak rate of the type."""
    item = torch.empty((), dtype=dtype).element_size()
    nbytes = item * (2 * b * lq * d + 2 * b * lk * d) + b * lk
    flops = 4 * b * h * lq * lk * (d // h)
    rate = peaks["float32" if dtype == torch.float32 else "bfloat16"]
    t_bytes, t_ops = nbytes / peaks["bytes"] * 1e3, flops / rate * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, flops=flops)


def sdpa(q, k, v, mask, h):
    """One library call computing the same function: an additive float mask
    keeps fully masked rows finite. Timed as a yardstick; the port calls it
    nowhere else."""
    b, lq, d = q.shape

    def split(x):
        return x.reshape(b, x.shape[1], h, d // h).transpose(1, 2)

    bias = torch.zeros(mask.shape, dtype=q.dtype, device=q.device).masked_fill(mask, at.NEG_INF)
    out = F.scaled_dot_product_attention(split(q), split(k), split(v),
                                         attn_mask=bias[:, None, None, :])
    return out.transpose(1, 2).reshape(b, lq, d)


def compare(q, k, v, mask, h):
    """(max abs err, tolerance, got) of the wrapper against the plain
    version; raises unless finite and within the tolerance."""
    got = at.masked_attention(q, k, v, mask, h)
    if got.is_cuda:
        torch.cuda.synchronize()
    want = at.masked_attention_plain(q, k, v, mask, h)
    if got.shape != want.shape or got.dtype != want.dtype:
        raise RuntimeError(f"kernel gave {tuple(got.shape)} {got.dtype}, plain "
                           f"{tuple(want.shape)} {want.dtype}")
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError("masked_attention: non-finite output")
    err = float((got.float() - want.float()).abs().max())
    tol = tolerance(q.dtype, want.float())
    if err > tol:
        raise RuntimeError(f"masked_attention {q.dtype} {tuple(q.shape)}: max abs err "
                           f"{err} > {tol}")
    return err, tol, got


def run(device="cuda", seed=0, shape=SHAPE, iters=50):
    """Measure both dtypes at `shape`; returns {"shapes", "device",
    "results": {dtype name: {max_abs_err, tol, ms, plain_ms, library_ms,
    bound_ms, bound_by, bytes, flops}}}. Times are None on the CPU."""
    dev = resolve_device(device)
    b, l, d, h = shape
    on_card = dev.type == "cuda"
    name = torch.cuda.get_device_name(dev) if on_card else "cpu"
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, mask = make_inputs(b, l, l, d, dtype, dev, seed)
        err, tol, _ = compare(q, k, v, mask, h)
        res = dict(max_abs_err=err, tol=tol, ms=None, plain_ms=None, library_ms=None)
        if on_card:
            lib_err = float((sdpa(q, k, v, mask, h).float()
                             - at.masked_attention_plain(q, k, v, mask, h).float()).abs().max())
            res.update(
                ms=cuda_ms(lambda: at.masked_attention(q, k, v, mask, h), iters),
                plain_ms=cuda_ms(lambda: at.masked_attention_plain(q, k, v, mask, h), iters),
                library_ms=cuda_ms(lambda: sdpa(q, k, v, mask, h), iters),
                library_max_abs_err=lib_err,
                **bound_ms(b, l, l, d, h, dtype, card_peaks(name)))
        results[str(dtype).split(".")[-1]] = res
    return dict(shapes=list(shape), device=name, results=results)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shape", type=int, nargs=4, default=list(SHAPE),
                    metavar=("B", "L", "D", "H"))
    args = ap.parse_args(argv)
    out = run(args.device, args.seed, tuple(args.shape))
    if torch.device(args.device).type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60).stdout.strip().splitlines()[0]
        out["card"] = smi
    print(json.dumps({"metric": "attn_kernel_vs_plain", **out}))


if __name__ == "__main__":
    main()
