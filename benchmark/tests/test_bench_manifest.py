"""BENCHMARK.json against its contract, and the files it names, found by
name; a cell, a configuration and a per-layer metric added as files and
entries alone are picked up."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import manifest

ROOT = manifest.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def man():
    return manifest.load()


def test_top_level_keys_and_limits(man):
    assert set(man) == TOP_KEYS
    assert 1 <= man["run_seconds"] <= 51 and isinstance(man["run_seconds"], int)
    assert 1 <= len(man["paths"]) <= 16 and 1 <= len(man["command"]) <= 32
    for p in man["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/")
        assert ".." not in p.split("/") and not p.endswith("_torch")
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    for word in man["command"][1:]:
        assert not word.startswith("/") and ".." not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in man["paths"])


def test_names_units_and_keys(man):
    names = [c["name"] for c in man["configs"]] + [w["name"] for w in man["workloads"]] \
        + [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_what_it_must(man):
    assert any(m["name"] == "setup_s" for m in man["end_to_end"])
    pairs = {(w["config"], w["traffic"]) for w in man["workloads"]}
    assert len(pairs) == len(man["workloads"])
    assert sum(w["chips"] == 4 for w in man["workloads"]) <= max(1, len(man["workloads"]) // 4)
    for w in man["workloads"]:
        e2e = {m["name"] for m in manifest.metrics_of(man, w["name"], "end_to_end")}
        layer = manifest.metrics_of(man, w["name"], "per_layer")
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        for m in layer:
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_every_name_resolves_to_its_files(man):
    for c in man["configs"]:
        f = manifest.config_file(man, c["name"])
        assert c["file"].startswith("benchmark/") and f["name"] == c["name"]
        assert sorted(f["reduced"]) == sorted(c["reduced"])
    for w in man["workloads"]:
        mix = manifest.traffic(w["traffic"])
        assert hasattr(manifest.driver(mix["kind"]), "Driver")
        assert manifest.limits(w["name"])["limits"]
    for m in man["per_layer"]:
        assert callable(manifest.reader(m["name"]))


def test_config_files_are_the_presets_they_name(man):
    """Each configuration file's `config` is the port's preset with its
    overrides on top, and nothing else."""
    import dataclasses

    from cone_tpu_torch import config as presets

    for c in man["configs"]:
        f = manifest.config_file(man, c["name"])
        cfg = getattr(presets, f["preset"])()
        for section, vals in f["overrides"].items():
            cfg = cfg.replace(**{section: dataclasses.replace(getattr(cfg, section), **vals)})
        assert json.loads(cfg.to_json()) == f["config"]


def test_a_cell_added_as_files_alone_is_picked_up(tmp_path):
    """Copy the benchmark, add a configuration, a traffic mix, a cell's
    limits and a per-layer metric as new files and manifest entries, and
    run the new cell on the CPU from the copy: no file of the benchmark
    changes."""
    dst = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "benchmark/configs/cone_ego4d.json").read_text())
    cfg["name"] = "cone_ego4d_tiny"
    cfg["config"]["model"].update({"hidden_dim": 32, "dim_feedforward": 64, "nheads": 4,
                                   "t_feat_dim": 32, "v_motion_feat_dim": 32,
                                   "v_appear_feat_dim": 32})
    (dst / "benchmark/configs/cone_ego4d_tiny.json").write_text(json.dumps(cfg))
    mix = json.loads((ROOT / "benchmark/workloads/nlq-val.json").read_text())
    mix.update(videos=3, frames=[1000, 1100], queries_per_video=[2, 3], check_queries=6)
    (dst / "benchmark/workloads/tiny-val.json").write_text(json.dumps(mix))
    lim = json.loads((ROOT / "benchmark/limits/ego4d-nlq-val.json").read_text())
    (dst / "benchmark/limits/tiny-cell.json").write_text(json.dumps(lim))
    (dst / "benchmark/layer_metrics/passes_read.py").write_text(
        "def read(trace, work):\n    return float(work['passes'])\n")
    man["configs"].append({"name": "cone_ego4d_tiny", "source": "https://example.org/tiny",
                           "file": "benchmark/configs/cone_ego4d_tiny.json", "reduced": [],
                           "why": "test"})
    man["workloads"].append({"name": "tiny-cell", "config": "cone_ego4d_tiny",
                             "traffic": "tiny-val", "chips": 1, "why": "test"})
    man["end_to_end"][0]["workloads"].append("tiny-cell")
    man["per_layer"].append({"name": "passes_read", "unit": "passes", "better": "higher",
                             "source": "host_clock", "layer": "test",
                             "moves": "queries_per_s", "workloads": ["tiny-cell"]})
    (dst / "BENCHMARK.json").write_text(json.dumps(man))
    code = ("import time, torch, json; torch.set_num_threads(2)\n"
            "from benchmark.harness import run_cell\n"
            "r = run_cell('tiny-cell', 7, 0.5, True, torch.device('cpu'), time.perf_counter(),"
            " log=lambda *a, **k: None)\n"
            "print(json.dumps(r))\n")
    env = dict(os.environ, PYTHONPATH=f"{dst}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", code], cwd=dst, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["metrics"]["passes_read"]["value"] >= 1
