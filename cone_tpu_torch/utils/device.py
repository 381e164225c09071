"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """`device` as a torch.device. The entry points default to "cuda" and
    run on the CPU only when the caller asks for it: a CUDA device without
    a card raises here instead of carrying on elsewhere.

    On the card it also switches TF32 off in cuDNN and cuBLAS for the
    process: PyTorch lets cuDNN's convolutions and RNNs compute in TF32 by
    default (about three decimal digits), and the port computes in float32,
    as cone_tpu and the reference fixtures do."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev


def card_peaks(name: str) -> dict:
    """Published peaks of a card at its full power limit, from NVIDIA's data
    sheets (dense rates): device-memory bytes/s, float32 FLOP/s outside the
    tensor cores, bfloat16 FLOP/s in them. The analytic bounds of the
    kernels are computed against these."""
    if "H200" in name:
        return {"bytes": 4.8e12, "float32": 67e12, "bfloat16": 989e12}
    if "H100" in name and "PCIe" in name:
        return {"bytes": 2.0e12, "float32": 51e12, "bfloat16": 756e12}
    if "H100" in name:
        return {"bytes": 3.35e12, "float32": 67e12, "bfloat16": 989e12}
    raise RuntimeError(f"no peak table for {name!r}")


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of `fn()` in milliseconds over `iters` back-to-back
    calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters
