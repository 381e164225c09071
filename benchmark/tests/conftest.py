"""Shared fixtures of the benchmark's own tests (`python -m pytest
benchmark/tests -q` from the repository's root; the card's tests carry the
`cuda` marker and skip without one)."""

from __future__ import annotations

import time

import pytest
import torch

# every width cut to a CPU test's size; the cells' own files are untouched
TINY_MODEL = {"hidden_dim": 32, "dim_feedforward": 64, "nheads": 4, "t_feat_dim": 32,
              "v_motion_feat_dim": 32, "v_appear_feat_dim": 32}
TINY = {
    "ego4d-nlq-val": ({"model": TINY_MODEL},
                      {"videos": 5, "frames": [1100, 1300], "queries_per_video": [2, 5],
                       "check_queries": 12}),
    "mad-test": ({"model": TINY_MODEL, "eval": {"ctx_buckets": [800, 1200]},
                  "data": {"max_ctx_l": 2048}},
                 {"videos": 3, "frames": [700, 1100], "queries_per_video": [33, 33],
                  "check_queries": 12}),
    "ego4d-train": ({"model": TINY_MODEL, "train": {"bsz": 8}},
                    {"videos": 10, "frames": [300, 400], "queries_per_video": [6, 10],
                     "trace_seconds": 1}),
    "mad-search": ({"model": TINY_MODEL, "eval": {"ctx_buckets": [800, 1200]},
                    "data": {"max_ctx_l": 2048}},
                   {"videos": 4, "frames": [700, 1100], "queries_per_video": [8, 8],
                    "rate": 4.0, "check_requests": 6, "trace_seconds": 1}),
}


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_run(cell, seed=2**33 + 5, trace=False, fault=None, overrides=None, seconds=1.0):
    """One whole run of `cell` on the CPU at a test's size."""
    from benchmark.harness import run_cell

    over, mix = TINY[cell]
    over = {k: dict(v) for k, v in over.items()}
    for section, vals in (overrides or {}).items():
        over.setdefault(section, {}).update(vals)
    return run_cell(cell, seed, seconds, trace, torch.device("cpu"), time.perf_counter(),
                    overrides=over, mix_overrides=mix, fault=fault,
                    log=lambda *a, **k: None)


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)
