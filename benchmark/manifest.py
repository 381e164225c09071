"""`BENCHMARK.json` and the files it names, found by name.

  * a configuration `<config>`: `benchmark/configs/<config>.json`, the
    program's configuration as it is run (its `config` key), with its
    source, the port's preset and overrides it came from, and its cuts;
  * a traffic mix `<traffic>`: `benchmark/workloads/<traffic>.json`, the
    driver kind (`benchmark/traffic/<kind>.py`) and its parameters;
  * a cell's limits: `benchmark/limits/<cell>.json`, each compared number
    with its limit and the readings it was set from;
  * a per-layer metric `<metric>`: `benchmark/layer_metrics/<metric>.py`,
    whose `read(trace, work)` returns the number or None; a metric split
    by the end-to-end metric it moves (`<base>.<part>`, as `mfu.eval` and
    `mfu.train`) without a file of its own is read by `<base>.py`.

A new configuration, traffic mix, cell or metric is new files and new
entries; no file here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def load(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_file(manifest: dict, config: str) -> dict:
    for c in manifest["configs"]:
        if c["name"] == config:
            return _json(ROOT / c["file"])
    raise KeyError(f"no config {config!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return _json(BENCH_DIR / "workloads" / f"{name}.json")


def limits(cell_name: str) -> dict:
    return _json(BENCH_DIR / "limits" / f"{cell_name}.json")


def driver(kind: str):
    return importlib.import_module(f"benchmark.traffic.{kind}")


def reader(metric: str):
    """The `read` function of a per-layer metric's own file, or of the file
    of the metric it splits."""
    path = BENCH_DIR / "layer_metrics" / f"{metric}.py"
    if not path.exists():
        path = path.with_name(metric.split(".")[0] + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark.layer_metrics.{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(manifest: dict, cell_name: str, kind: str) -> list:
    """The `end_to_end` or `per_layer` entries a cell reports: those whose
    `workloads` list it; one without that list, an end-to-end metric in
    every cell, a per-layer one in every cell that reports what it moves."""
    e2e = {m["name"] for m in manifest["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])}
    out = []
    for m in manifest[kind]:
        if "workloads" in m:
            mine = cell_name in m["workloads"]
        else:
            mine = kind == "end_to_end" or m["moves"] in e2e
        if mine:
            out.append(m)
    return out
