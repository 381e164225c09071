"""The readings the limits of `benchmark/limits/<cell>.json` are set from.

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13 ... [--seconds 2]
                                 [--fault <name>]

For each seed, in one process on the card: the cell's set-up, a short
window of the program's timed path and its check (the program's reading,
the lower one), then the control on the same inputs: the reference put in
the program's place in the nearest precision below the configuration's
(float32 with TF32 on), judged the same way (the upper reading). With
--fault, the program runs with that fault of its traffic driver's
`FAULTS` planted in the timed path, and its reading is the fault's. Prints
one JSON line per seed and appends them to
chiprun_out/control-<cell>.jsonl when that directory exists. The
benchmark's own runs never run this.
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


def readings(cell_name, seed, seconds, device, overrides=None, mix_overrides=None,
             fault=None):
    """(program's numbers, control's numbers, the driver) of one seed; with
    a fault, (the faulty program's numbers, None, the driver)."""
    import torch

    from benchmark import manifest
    from benchmark.harness import RunContext, build_config
    from benchmark.trace import NoTracer

    man = manifest.load()
    cell = manifest.cell(man, cell_name)
    cfg = build_config(manifest.config_file(man, cell["config"]), overrides)
    mix = dict(manifest.traffic(cell["traffic"]), **(mix_overrides or {}))
    kind = manifest.driver(mix["kind"])
    ctx = RunContext(cell=cell, cfg=cfg, mix=mix, seed=seed, device=device, tracer=NoTracer(),
                     fault=fault)
    drv = kind.Driver(ctx)
    drv.setup()
    drv.window(seconds)
    drv.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    program = drv.check()
    return program, (None if fault else drv.control()), drv


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("control: no CUDA card")
    out_dir = os.path.join(ROOT, "chiprun_out")
    lines = []
    for seed in args.seeds:
        t = time.perf_counter()
        program, control, drv = readings(args.workload, seed, args.seconds,
                                         torch.device("cuda", 0), fault=args.fault)
        line = {"cell": args.workload, "seed": seed, "fault": args.fault, "program": program,
                "control": control, "detail": getattr(drv, "detail", None),
                "seconds": time.perf_counter() - t}
        print(json.dumps(line), flush=True)
        lines.append(line)
    if os.path.isdir(out_dir):
        with open(os.path.join(out_dir, f"control-{args.workload}.jsonl"), "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")


if __name__ == "__main__":
    main()
