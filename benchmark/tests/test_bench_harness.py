"""Whole runs on the CPU at a test's size, past the harness's look for a
card: each cell comes out correct, and comes out not correct with its
timed path broken underneath in each way the cell can break. The command
itself refuses to run without a card, or outside a checkout of the
program. On the card: the control at a small size reads past each limit."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import manifest
from benchmark.tests.conftest import TINY, tiny_run

ROOT = manifest.ROOT


@pytest.mark.parametrize("cell", list(TINY))
def test_cell_runs_correct(cell):
    r = tiny_run(cell)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    names = {m["name"] for m in manifest.metrics_of(manifest.load(), cell, "end_to_end")}
    assert set(r["metrics"]) == names


@pytest.mark.parametrize("cell, fault", [
    ("ego4d-nlq-val", "answer"), ("ego4d-nlq-val", "half_batch"),
    ("mad-test", "answer"), ("mad-test", "half_batch"),
    ("ego4d-train", "state_unchanged"), ("ego4d-train", "half_batch"),
    ("ego4d-train", "moments_reset"),
    ("mad-search", "answer"),
])
def test_broken_timed_path_is_not_correct(cell, fault):
    assert tiny_run(cell, fault=fault)["correct"] is False


def test_traced_run_reports_per_layer_metrics():
    r = tiny_run("ego4d-train", trace=True)
    assert "loader_wait_ms" in r["metrics"] and "mfu.train" in r["metrics"]
    assert r["device"]["window_s"] > 0 and "breakdown" in r


def test_moments_reset_passes_the_start_and_fails_the_window():
    """A step whose AdamW state starts over at every update reads as the
    sound program at the first step (its update is lr times about the
    sign of the gradient either way); the step judged in the window
    catches it."""
    checks = tiny_run("ego4d-train", fault="moments_reset")["checks"]
    lim = manifest.limits("ego4d-train")["limits"]
    assert all(checks[k]["value"] <= lim[k]["limit"] for k in ("loss_gap", "median_change_gap"))
    assert checks["window_median_change_gap"]["value"] > lim["window_median_change_gap"]["limit"]


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "ego4d-nlq-val",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd,
                          capture_output=True, text=True, timeout=300, env=env)


def test_command_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(ROOT, env)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_command_refuses_without_the_program(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _run(tmp_path, env)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "cone_tpu_torch" in out.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(TINY))
def test_control_fails_each_cell(card, cell):
    """The reference in TF32 in the program's place reads past a limit;
    the program itself reads within every limit."""
    from benchmark.control import readings

    over, mix = TINY[cell]
    program, control, _ = readings(cell, 2**33 + 9, 1.0, card, over, mix)
    lim = manifest.limits(cell)["limits"]
    assert all(program[k] <= lim[k]["limit"] for k in lim)
    assert any(control[k] > lim[k]["limit"] for k in lim), json.dumps(control)
