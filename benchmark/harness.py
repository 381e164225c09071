"""One run of one cell: set-up, the measured window, the check, the result.

  1. the traffic driver makes the inputs and the weights from the seed,
     builds the program's objects and warms the cell's own shapes
     (`setup`); everything from the process's start to here is `setup_s`;
  2. it drives the program for the window (`window`); a traced run drives
     a stretch of `trace_seconds` untraced (its time and work kept in the
     readers' `work` under "untraced"), then the same again with the
     profiler and the spans on;
  3. the peak device memory is read, the program's state is freed
     (`release`), and the plain reference judges what the timed path
     produced (`check`): each number compared beside its limit;
  4. the result line: the cell's end-to-end metrics (untraced) or its
     per-layer metrics (traced), the device, the numbers compared last.

`run_cell` takes the device as an argument so that the tests can drive a
whole run on the CPU at a tiny size; `benchmark/run.py` refuses to run
without the cards a cell asks for.
"""

from __future__ import annotations

import gc
import json
import math
import sys
import time
from dataclasses import dataclass, field
from typing import Optional

from benchmark import manifest
from benchmark.trace import NoTracer, Tracer

FORBIDDEN = ("jax", "jaxlib", "flax", "cone_tpu")


@dataclass
class RunContext:
    cell: dict
    cfg: object            # the program's ConeConfig
    mix: dict
    seed: int
    device: object         # torch.device
    tracer: object
    fault: Optional[str] = None
    work: dict = field(default_factory=dict)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole (`cone_tpu_torch` is not `cone_tpu`)."""
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(FORBIDDEN))


def build_config(cfg_file: dict, overrides: Optional[dict] = None):
    """The program's ConeConfig from a configuration file's `config`, with
    `overrides` ({section: {field: value}}, tests only) on top."""
    from cone_tpu_torch.config import ConeConfig

    raw = json.loads(json.dumps(cfg_file["config"]))
    for section, vals in (overrides or {}).items():
        raw.setdefault(section, {}).update(vals)
    return ConeConfig.from_json(json.dumps(raw), strict=True)


def device_info(device, chips: int, peak_bytes: int) -> dict:
    import torch

    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
            "count": chips, "memory_peak_bytes": int(peak_bytes)}


def _num(x) -> float:
    """A finite float for the JSON line: a reading that is infinite (a
    request that never finished, a ranking that is no permutation) as 1e300."""
    x = float(x)
    return x if math.isfinite(x) else 1e300


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, device, t0: float,
             overrides: Optional[dict] = None, mix_overrides: Optional[dict] = None,
             fault: Optional[str] = None, log=print) -> dict:
    """One run; returns the result dict (the line `run.py` prints)."""
    import torch

    man = manifest.load()
    cell = manifest.cell(man, cell_name)
    cfg = build_config(manifest.config_file(man, cell["config"]), overrides)
    mix = dict(manifest.traffic(cell["traffic"]), **(mix_overrides or {}))
    lim = manifest.limits(cell_name)["limits"]
    tracer = Tracer(device) if trace else NoTracer()
    ctx = RunContext(cell=cell, cfg=cfg, mix=mix, seed=seed, device=device,
                     tracer=tracer, fault=fault)
    drv = manifest.driver(mix["kind"]).Driver(ctx)

    drv.setup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.3f} s", file=sys.stderr)

    if trace:
        # the same stretch of work untraced first: the time it takes is the
        # one the profiler's own cost does not stretch (device_idle_share, mfu)
        drv.window(float(seconds))
        ctx.work = {"untraced": dict(ctx.work)}
    tracer.start()
    measured = drv.window(float(seconds))
    tracer.stop()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    view = None
    if trace:
        t_read = time.perf_counter()
        view = tracer.view()
        log(f"trace: {len(view.ops)} device operations read in "
            f"{time.perf_counter() - t_read:.3f} s; device s by span "
            f"{json.dumps({k: v / 1e9 for k, v in view.span_device_ns.items()})}, "
            f"spans {json.dumps(view.span_count)}", file=sys.stderr)
    drv.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    numbers = drv.check()
    log(f"check {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    checks = {k: {"value": _num(v), "limit": lim[k]["limit"]} for k, v in numbers.items()}
    correct = (set(numbers) == set(lim)
               and all(numbers[k] <= lim[k]["limit"] for k in numbers)
               and measured["failed"] == 0)

    metrics = {}
    if trace:
        for m in manifest.metrics_of(man, cell_name, "per_layer"):
            v = manifest.reader(m["name"])(view, ctx.work)
            if v is not None:
                metrics[m["name"]] = {"value": _num(v), "unit": m["unit"]}
    else:
        for m in manifest.metrics_of(man, cell_name, "end_to_end"):
            v = setup_s if m["name"] == "setup_s" else measured["metrics"].get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": _num(v), "unit": m["unit"]}
    dev = device_info(device, int(cell["chips"]), peak)
    result = {"correct": bool(correct), "attempted": int(measured["attempted"]),
              "failed": int(measured["failed"]), "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = view.busy_s
        dev["window_s"] = view.window_s
        result["breakdown"] = view.breakdown()
    result["checks"] = checks
    return result
