"""Run one benchmark cell once, on the card, and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object: correct, attempted, failed, metrics, device (and with --trace 1
breakdown), and last, under `checks`, each number compared with the plain
reference beside its limit; the same numbers end standard error.

Exits with another code than 0, printing no result, when the cell is not
in BENCHMARK.json, the program is not in the checkout, there is no CUDA
card or fewer than the cell asks for, or once the window has closed any of
jax, jaxlib, flax or the JAX package is loaded in this process.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# libraries the port may load must not bring JAX in with them
for _var in ("USE_FLAX", "USE_JAX", "USE_TF"):
    os.environ.setdefault(_var, "0")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def fail(msg: str, code: int = 2) -> None:
    print(f"benchmark: {msg}", file=sys.stderr)
    sys.exit(code)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import manifest
    from benchmark.harness import forbidden_modules, run_cell

    try:
        cell = manifest.cell(manifest.load(), args.workload)
    except (KeyError, OSError) as e:
        fail(str(e))
    if importlib.util.find_spec("cone_tpu_torch") is None:
        fail("the program (cone_tpu_torch) is not in this checkout")
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA card: torch.cuda.is_available() is False")
    if torch.cuda.device_count() < int(cell["chips"]):
        fail(f"{args.workload} needs {cell['chips']} cards, "
             f"{torch.cuda.device_count()} present")
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T0, log=print)
    bad = forbidden_modules()
    if bad:
        fail(f"modules loaded in the run's process: {', '.join(bad)}", 3)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
