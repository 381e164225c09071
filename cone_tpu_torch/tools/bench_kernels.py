"""Both hand-written kernels at their four record shapes, timed on the card.

    python -m cone_tpu_torch.tools.bench_kernels [--seed 0] [--spb N ...]

coarse_segment_max at the Ego4D shape (B 1, Q 32, L 2304, D 256, stride 45)
and the MAD shape (L 36864, D 512, stride 62); masked_attention at B 640,
L 110, D 256, H 8 in float32 and bfloat16. For each: the error against the
plain version, CUDA-event time per call of the kernel, of the plain version
and of the library yardstick, and the kernel's device time per launch from
torch.profiler. One JSON line per shape, then one with the card.

The script uses only the wrappers' public signatures, so it also times
another checkout of the package: put that checkout first on PYTHONPATH and
run this file by its path; two trees measured in one call compare on one
card. `--spb` times the coarse kernel at given segments-per-block settings
beside the plan's (trees that have the parameter only).
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess

import torch
import torch.nn.functional as F

from cone_tpu_torch.ops import attention as at
from cone_tpu_torch.ops import coarse as co
from cone_tpu_torch.tools import bench_attn
from cone_tpu_torch.utils.device import cuda_ms

COARSE_SHAPES = {  # label: (B, Q, L, D, stride, ctx_l, timed calls)
    "ego4d": (1, 32, 2304, 256, 45, 2243, 500),
    "mad": (1, 32, 36864, 512, 62, 36000, 100),
}
PROFILER_SESSIONS = 3   # fresh torch.profiler sessions tried per device-time read


def kernel_device_us(fn, kernel_name: str, launches: int = 20) -> float | None:
    """Device time per launch, in microseconds, of the kernels whose name
    contains `kernel_name`, from torch.profiler over `launches` calls of
    `fn`. Now and then a profiler session records none of the kernel's
    launches (the CUPTI trace comes back without them; the kernel ran): up
    to PROFILER_SESSIONS fresh sessions are tried, and None (not measured)
    is returned if none saw the kernel. A device time is a measurement, not
    a check: whether the kernel ran and agrees is held elsewhere."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILER_SESSIONS + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(launches):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages() if kernel_name in e.key]
        if ev:
            total = sum(getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
                        for e in ev)
            return total / sum(e.count for e in ev)
        print(f"torch.profiler session {attempt} of {PROFILER_SESSIONS} recorded no "
              f"{kernel_name} launch", flush=True)
    print(f"torch.profiler recorded no {kernel_name} launch in {PROFILER_SESSIONS} sessions: "
          f"device time not measured", flush=True)
    return None


def fmt_us(us: float | None) -> str:
    return "not measured" if us is None else f"{us:.2f}us"


def coarse_inputs(b, q, l_pad, d, ctx, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    feats = torch.randn(b, l_pad, d, generator=gen, device="cuda")
    feats = feats / feats.norm(dim=-1, keepdim=True)
    cls = torch.randn(b, q, d, generator=gen, device="cuda")
    cls = cls / cls.norm(dim=-1, keepdim=True)
    return feats, cls, torch.full((b,), ctx, dtype=torch.int32, device="cuda")


def bench_coarse(label, seed=0, spbs=()):
    b, q, l_pad, d, stride, ctx, iters = COARSE_SHAPES[label]
    feats, cls, ctx_t = coarse_inputs(b, q, l_pad, d, ctx, seed)
    got = co.coarse_segment_max(feats, cls, ctx_t, stride)
    torch.cuda.synchronize()
    want = co.coarse_segment_max_plain(feats, cls, ctx_t, stride)
    n_valid = -(-ctx // stride)
    res = dict(
        kernel="coarse_segment_max", shape=label,
        max_abs_err=float((got - want)[..., :n_valid].abs().max()),
        ms=cuda_ms(lambda: co.coarse_segment_max(feats, cls, ctx_t, stride), iters),
        plain_ms=cuda_ms(lambda: co.coarse_segment_max_plain(feats, cls, ctx_t, stride), iters),
        library_ms=cuda_ms(lambda: F.max_pool1d(torch.matmul(cls, feats.mT), stride, stride,
                                                ceil_mode=True), iters),
        device_us=kernel_device_us(lambda: co.coarse_segment_max(feats, cls, ctx_t, stride),
                                   "coarse_segment_max_kernel"))
    if "segs_per_block" in inspect.signature(co.coarse_segment_max).parameters:
        res["plan"] = co.plan(-(-l_pad // stride), b)
        res["device_us_by_segs_per_block"] = {
            spb: kernel_device_us(lambda: co.coarse_segment_max(feats, cls, ctx_t, stride, spb),
                                  "coarse_segment_max_kernel") for spb in spbs}
    return res


def bench_attention(dtype, seed=0, iters=50):
    b, l, d, h = bench_attn.SHAPE
    q, k, v, mask = bench_attn.make_inputs(b, l, l, d, dtype, "cuda", seed)
    err, tol, _ = bench_attn.compare(q, k, v, mask, h)
    return dict(
        kernel="masked_attention", shape=str(dtype).split(".")[-1], max_abs_err=err, tol=tol,
        ms=cuda_ms(lambda: at.masked_attention(q, k, v, mask, h), iters),
        plain_ms=cuda_ms(lambda: at.masked_attention_plain(q, k, v, mask, h), iters),
        library_ms=cuda_ms(lambda: bench_attn.sdpa(q, k, v, mask, h), iters),
        device_us=kernel_device_us(lambda: at.masked_attention(q, k, v, mask, h),
                                   "masked_attention_kernel"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--spb", type=int, nargs="*", default=[],
                    help="segments per block to time the coarse kernel at (MAD shape)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_kernels needs a CUDA card: a device time comes only from one")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps(bench_coarse("ego4d", args.seed)), flush=True)
    print(json.dumps(bench_coarse("mad", args.seed, args.spb)), flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        print(json.dumps(bench_attention(dtype, args.seed)), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"package": at.__file__, "card": smi}))


if __name__ == "__main__":
    main()
