"""Where a data-parallel train step's time goes against the plain step, on
one device.

    python -m cone_tpu_torch.tools.bench_dp_step [--steps 20] [--rounds 2] [--device cuda]

At the Ego4D preset's full width (dist_worker's "ego4d" problem: hidden
256, bsz 32, dropouts 0, the adapter on), on batches copied to the device
beforehand, copies of the model from one seed each take the CONE train
step (make_train_step) with another reduction:

  plain        no group (parallel/distributed.LOCAL);
  noop         the data-parallel code path (span-count sum, row gather,
               coalesced gradient buffer, stacked metrics) with an
               all-reduce that does nothing;
  group_grads  over a one-rank group (NCCL on a card, gloo on the CPU), the
               gradient all-reduce only, the small collectives as in noop;
  group        every collective over the group.

The variants take turns, --steps warm steps each per round, over --rounds
rounds, first plain and noop before the group exists, then all four; each
step ends in reading its metrics, as `train` does. Reported per variant:
host-clock ms per step (median, min); the process's threads before and
with the group; the collectives per step and their host ms, the
gradient's apart. Then the pieces alone, synchronized: the coalesced
gradient all-reduce (sum_grads), a 0-d sum, the row gather. Last,
torch.profiler over --rounds x 5 steps of `plain` and of `group` in turns
(after one discarded session; `run(profile=False)` skips it): device ms
per step and busy share, host self time per step by kind of op, and the
ops whose host time differs most between the two. Ends with one JSON
line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

PROFILED_STEPS = 5


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _threads() -> int:
    with open("/proc/self/status") as f:
        return next(int(line.split()[1]) for line in f if line.startswith("Threads:"))


def run(steps: int = 20, rounds: int = 2, device="cuda", seed: int = 0,
        profile: bool = True) -> dict:
    import torch.distributed as dist

    from cone_tpu_torch.data import TrainLoader
    from cone_tpu_torch.parallel import distributed
    from cone_tpu_torch.parallel.distributed import LOCAL, GroupReduce
    from cone_tpu_torch.tools.dist_worker import problem
    from cone_tpu_torch.train.loop import build_family
    from cone_tpu_torch.train.optim import make_optimizer
    from cone_tpu_torch.train.step import batch_to_device, make_train_step, to_floats
    from cone_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    cfg, ds = problem("ego4d")
    loader = TrainLoader(ds, bsz=cfg.train.bsz, seed=seed)
    batches = [batch_to_device(b, dev) for e in range(4) for b in loader.epoch(e)]
    calls = {"grads": [], "small": []}   # host seconds of each collective in a group
    big = 1 << 16                        # the gradient buffer: millions of elements

    def timed_all_reduce(t, small=True):
        if not small and t.numel() < big:
            return
        t0 = time.perf_counter()
        dist.all_reduce(t)
        calls["small" if t.numel() < big else "grads"].append(time.perf_counter() - t0)

    def make(reduce):
        model = build_family(cfg, seed=cfg.train.seed, device=dev)
        opt, sched = make_optimizer(model, cfg.train, 10 ** 6)
        return model, make_train_step(model, opt, sched, cfg, reduce)

    def warm(step):
        for i in range(3):   # allocator, cuBLAS handles, AdamW state
            to_floats(step(batches[i % len(batches)], True))
        _sync(dev)

    def take_turns(variants, walls):
        for _ in range(rounds):
            for k, (_, step) in variants.items():
                for i in range(steps):
                    t0 = time.perf_counter()
                    to_floats(step(batches[i % len(batches)], True))
                    walls.setdefault(k, []).append(time.perf_counter() - t0)

    torch.manual_seed(seed)
    variants = {"plain": make(LOCAL), "noop": make(GroupReduce(0, 1, lambda t: None))}
    for _, step in variants.values():
        warm(step)
    threads_before = _threads()
    walls_before = {}
    take_turns(variants, walls_before)

    distributed.initialize(num_processes=1, process_id=0, device=device)
    try:
        backend = distributed.backend()
        variants["group_grads"] = make(GroupReduce(
            0, 1, lambda t: timed_all_reduce(t, small=False)))
        variants["group"] = make(GroupReduce(0, 1, timed_all_reduce))
        for k in ("group_grads", "group"):
            warm(variants[k][1])
        threads_after = _threads()
        walls = {}
        calls["grads"].clear()
        calls["small"].clear()
        take_turns(variants, walls)
        # the gradient's in group_grads and group, the small ones in group only
        n_steps = {"grads": 2 * rounds * steps, "small": rounds * steps}
        collectives = {k: dict(per_step=len(v) / n_steps[k],
                               host_ms_per_call=float(np.mean(v)) * 1e3 if v else None)
                       for k, v in calls.items()}

        # the pieces alone, synchronized
        model, _ = variants["group"]
        params = [p for p in model.parameters() if p.grad is not None]
        red = distributed.batch_reduce()

        def piece_ms(fn, n=20):
            for _ in range(3):
                fn()
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            _sync(dev)
            return (time.perf_counter() - t0) / n * 1e3

        x0 = torch.ones((), device=dev)
        rows = torch.randn(cfg.train.bsz, 2 * cfg.model.hidden_dim, device=dev)
        pieces = {"sum_grads": piece_ms(lambda: red.sum_grads(params)),
                  "sum_0d": piece_ms(lambda: red.sum(x0)),
                  "gather_rows": piece_ms(lambda: red.gather_rows(rows)),
                  "grad_bytes": 4 * sum(p.numel() for p in params)}

        prof = _profile(variants, batches, rounds, dev) if profile else None
    finally:
        distributed.shutdown()

    def ms(d, f):
        return {k: float(f(v)) * 1e3 for k, v in d.items()}

    out = {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "torch": torch.__version__, "backend": backend, "bsz": cfg.train.bsz,
        "steps_per_variant": rounds * steps,
        "step_ms_median": ms(walls, np.median),
        "step_ms_min": ms(walls, np.min),
        "step_ms_median_before_group": ms(walls_before, np.median),
        "threads": {"before_group": threads_before, "with_group": threads_after},
        "collectives": collectives,
        "pieces_ms": pieces,
    }
    if prof is not None:
        out.update(prof)
    return out


def _profile(variants, batches, rounds, dev) -> dict:
    """torch.profiler over rounds x PROFILED_STEPS steps of `plain` and of
    `group` in turns, after one discarded session (the profiler's own
    first-session cost)."""
    from cone_tpu_torch.train.loop import device_seconds
    from cone_tpu_torch.train.step import to_floats

    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = {k: dict(wall_ms=0.0, device_ms=0.0, ops={}) for k in ("plain", "group")}
    n_prof = rounds * PROFILED_STEPS
    for j, k in enumerate(["plain"] + ["plain", "group"] * rounds):
        step = variants[k][1]
        with torch.profiler.profile(activities=acts) as p:
            t0 = time.perf_counter()
            for i in range(PROFILED_STEPS):
                to_floats(step(batches[i % len(batches)], True))
            _sync(dev)
            wall = time.perf_counter() - t0
        if j == 0:
            continue
        avgs = p.key_averages()
        prof[k]["wall_ms"] += wall / n_prof * 1e3
        prof[k]["device_ms"] += device_seconds(avgs) / n_prof * 1e3
        for e in avgs:
            c, t = prof[k]["ops"].get(e.key, (0.0, 0.0))
            prof[k]["ops"][e.key] = (c + e.count / n_prof,
                                     t + e.self_cpu_time_total / n_prof / 1e3)

    def kinds(ops):
        out = {}
        for key, (_, ms) in ops.items():
            kind = ("comms" if any(w in key for w in ("nccl", "c10d", "record_param_comms",
                                                      "gloo")) else
                    "cuda_runtime" if key.startswith("cu") else
                    "aten" if key.startswith("aten::") else
                    "autograd" if "autograd" in key or key.endswith("Backward0") else
                    "other")
            out[kind] = out.get(kind, 0.0) + ms
        return out

    a, b = prof["plain"]["ops"], prof["group"]["ops"]
    diff = sorted(((k, a.get(k, (0, 0.0)), b.get(k, (0, 0.0))) for k in set(a) | set(b)),
                  key=lambda r: abs(r[2][1] - r[1][1]), reverse=True)[:15]
    return {
        "profiled": {k: {"wall_ms_per_step": v["wall_ms"], "device_ms_per_step": v["device_ms"],
                         "busy_share": v["device_ms"] / v["wall_ms"],
                         "host_ms_per_step_by_kind": kinds(v["ops"])}
                     for k, v in prof.items()},
        "host_ops_most_changed": [
            {"op": k[:80], "plain_calls": pa[0], "plain_ms": round(pa[1], 4),
             "group_calls": pb[0], "group_ms": round(pb[1], 4)} for k, pa, pb in diff],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = run(args.steps, args.rounds, args.device)
    print(f"train step at Ego4D width, bsz {res['bsz']}, on {res['device']}, "
          f"{res['steps_per_variant']} warm steps per variant, host clock: median ms "
          + ", ".join(f"{k} {v:.2f}" for k, v in res["step_ms_median"].items())
          + " (min " + ", ".join(f"{k} {v:.2f}" for k, v in res["step_ms_min"].items())
          + "; before the group " + ", ".join(
              f"{k} {v:.2f}" for k, v in res["step_ms_median_before_group"].items()) + ")")
    print(f"group ({res['backend']}, torch {res['torch']}): collectives {res['collectives']}; "
          f"threads {res['threads']}; pieces alone (ms): {res['pieces_ms']}")
    print(f"profiled: {res['profiled']}")
    print("host ops whose self time changed most (per step: calls, ms), plain -> group:")
    for r in res["host_ops_most_changed"]:
        print(f"  {r['op']}: {r['plain_calls']:.0f}, {r['plain_ms']:.3f} -> "
              f"{r['group_calls']:.0f}, {r['group_ms']:.3f}")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
