"""Find the highest request rate the served path sustains, once, on the card.

    python3 benchmark/sweep_rate.py --workload mad-search --rates 10 20 30 40 --seconds 15 [--write]

One set-up of the cell (library resident, service warm), then the cell's
open-loop traffic offered at each rate for `--seconds`. A rate is
sustained when every request is answered and the backlog does not grow:
the median latency of the last quarter of the schedule is within twice
that of the first quarter plus 50 ms. The highest sustained rate is the
highest below which every rate offered was sustained. Prints one JSON line
per rate and that rate; with --write, sets the mix's `rate` to 0.8 of it
(rounded to 0.1 requests/s) in `benchmark/workloads/<traffic>.json`.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def summarize(rate, got) -> dict:
    import numpy as np

    lat, n = got["lat"], len(got["lat"])
    done = np.isfinite(lat)
    q = max(1, n // 4)
    first = float(np.median(lat[:q])) if done[:q].all() else float("inf")
    last = float(np.median(lat[-q:])) if done[-q:].all() else float("inf")
    ok = bool(done.all() and last <= 2 * first + 0.05)
    pct = np.percentile(lat[done], [50, 95, 99]) * 1e3 if done.any() else [float("nan")] * 3
    return {"rate": rate, "requests": n, "answered": int(done.sum()),
            "completed_per_s": float(done.sum() / got["elapsed"]),
            "p50_ms": float(pct[0]), "p95_ms": float(pct[1]), "p99_ms": float(pct[2]),
            "first_quarter_median_ms": 1e3 * first, "last_quarter_median_ms": 1e3 * last,
            "max_send_late_ms": 1e3 * float(got["late"].max()), "sustained": ok}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="mad-search")
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--seed", type=int, default=4242)
    ap.add_argument("--write", action="store_true")
    args = ap.parse_args()
    import torch

    from benchmark import manifest
    from benchmark.harness import RunContext, build_config
    from benchmark.trace import NoTracer

    if not torch.cuda.is_available():
        sys.exit("sweep: no CUDA card")
    man = manifest.load()
    cell = manifest.cell(man, args.workload)
    cfg = build_config(manifest.config_file(man, cell["config"]))
    mix = manifest.traffic(cell["traffic"])
    ctx = RunContext(cell=cell, cfg=cfg, mix=mix, seed=args.seed,
                     device=torch.device("cuda", 0), tracer=NoTracer())
    drv = manifest.driver(mix["kind"]).Driver(ctx)
    drv.setup()
    print(json.dumps({"setup_s": time.perf_counter() - T0}), flush=True)
    best, failing = None, False
    for i, rate in enumerate(sorted(args.rates)):
        row = summarize(rate, drv.offer(rate, args.seconds, args.seed + i))
        print(json.dumps(row), flush=True)
        failing = failing or not row["sustained"]
        if not failing:
            best = rate
    drv.release()
    print(json.dumps({"highest_sustained": best}), flush=True)
    if args.write and best:
        path = manifest.BENCH_DIR / "workloads" / f"{cell['traffic']}.json"
        mix["rate"] = round(0.8 * best, 1)
        path.write_text(json.dumps(mix, indent=1) + "\n")
        print(f"rate {mix['rate']} written to {path}")


if __name__ == "__main__":
    main()
