"""The benchmark's 2D-TAN cell (`tan-mad-test`) and data-parallel cell
(`ego4d-train-dp4`) on the CPU at a tiny size: the port's TAN pipeline
against the plain reference `benchmark/reference/tan.py`, the grid's IoU
ties decided as the program decides them, the TAN FLOP count against
torch's own counter at full width, and both cells' drivers run whole
through `run_cell`, correct as they are and not correct with each of their
planted faults."""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import manifest, tan_counts
from benchmark.harness import build_config, run_cell
from benchmark.reference import grounding
from benchmark.reference import tan as ref
from benchmark.traffic import tan_eval
from cone_tpu_torch.config import tan_mad_config
from cone_tpu_torch.eval.tan_pipeline import TanInferencePipeline
from cone_tpu_torch.models.tan import ConeTanModel

# every width cut to a CPU test's size, the map's geometry kept whole: a
# 16-cell sparse map of three scales from 32 frames pooled by 2, four 3 x 3
# convolutions whose first padding brings the map back to 16 cells; 10
# windows a query, chunks of 8 with a last chunk of one
TAN_TINY = ({"model": {"t_feat_dim": 32, "v_motion_feat_dim": 32, "v_appear_feat_dim": 32},
             "tan": {"num_clips": 16, "hidden_size": 32, "v_feat_dim": 32, "t_feat_dim": 32,
                     "txt_hidden_size": 16, "num_scale_layers": [4, 2, 2],
                     "map_hidden_sizes": [32, 32, 32, 32], "map_kernel_sizes": [3, 3, 3, 3],
                     "map_paddings": [4, 0, 0, 0]},
             "data": {"max_v_l": 32, "max_ctx_l": 2048, "topk_window": 10},
             "eval": {"ctx_buckets": [800, 1200], "query_chunk": 8}},
            {"videos": 2, "frames": [700, 1100], "queries_per_video": [9, 9],
             "check_queries": 12})
DP_TINY = ({"model": {"hidden_dim": 32, "dim_feedforward": 64, "nheads": 4, "t_feat_dim": 32,
                      "v_motion_feat_dim": 32, "v_appear_feat_dim": 32},
            "train": {"bsz": 8}},
           {"videos": 10, "frames": [300, 400], "queries_per_video": [6, 10], "ranks": 2})


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(cell, tiny, fault=None):
    return run_cell(cell, 2**33 + 7, 0.3, False, torch.device("cpu"), time.perf_counter(),
                    overrides=tiny[0], mix_overrides=tiny[1], fault=fault,
                    log=lambda *a, **k: None)


@pytest.mark.parametrize("fault", [None, "answer", "half_batch"])
def test_tan_cell_runs_whole(fault):
    """Sound, the timed path's kept moments equal the reference's (spans
    within 1e-3 s, scores within 2e-3) for every checked query, and its
    window ranking is the reference's; an answer moved, or half of each
    query's windows run, reads not correct."""
    r = _run("tan-mad-test", TAN_TINY, fault)
    if fault is None:
        # every pass runs all 18 queries; how many passes fill the window
        # depends on the host's speed
        assert r["correct"] is True and r["failed"] == 0
        assert r["attempted"] >= 18 and r["attempted"] % 18 == 0
        assert r["checks"]["moment_mismatch"]["value"] == 0.0
        assert r["checks"]["rank_gap"]["value"] <= 1e-6
    else:
        assert r["correct"] is False


@pytest.mark.parametrize("fault", [None, "state_unchanged", "half_batch", "no_allreduce"])
def test_dp_cell_runs_whole(fault):
    """Two gloo ranks, rank 0 in this process: sound, the group's steps are
    the reference's one-process steps over the global batch; unchanged
    weights, half of each rank's rows, or the gradient all-reduce left out
    read not correct."""
    r = _run("ego4d-train-dp4", DP_TINY, fault)
    assert r["correct"] is (fault is None)
    assert r["attempted"] > 0 and r["failed"] == 0


def test_tan_score_map_against_reference():
    """The port's ConeTanModel on seeded weights against the reference's
    map, LSTM and fusion: cell probabilities within 1e-5, and the same
    cells kept by the within-window NMS."""
    cfg = build_config(manifest.config_file(manifest.load(), "tan_mad"), TAN_TINY[0])
    t = cfg.tan
    params = tan_eval.seeded_state_dict(t, 11, "cpu")
    model = ConeTanModel(t, device="cpu").eval()
    model.load_state_dict(params)
    g = torch.Generator().manual_seed(3)
    win = grounding.l2n(torch.randn(4, cfg.data.max_v_l, t.v_feat_dim, generator=g))
    tok = grounding.l2n(torch.randn(9, t.t_feat_dim, generator=g))
    toks = torch.zeros(4, cfg.data.max_q_l, t.t_feat_dim)
    toks[:, :9] = tok
    tmask = (torch.arange(cfg.data.max_q_l) < 9).float().expand(4, -1)
    with torch.no_grad():
        scores, mask = model(toks, tmask, win)
        got = torch.sigmoid(scores) * mask
        txt = ref.lstm_last(params, t, tok) @ params["fusion_layer.tex_linear.weight"].T \
            + params["fusion_layer.tex_linear.bias"]
        want = ref.score_maps(params, t, win, txt.expand(4, -1),
                              ref.map_mask(t.num_clips, t.num_scale_layers, "cpu"))
    assert torch.equal(mask, ref.map_mask(t.num_clips, t.num_scale_layers, "cpu"))
    assert (got - want).abs().max() <= 1e-5
    for j in range(4):
        kept = ref.window_nms(want[j].reshape(-1), t.num_clips, t.proposal_top_k)
        assert [c[:2] for c in ref.window_nms(got[j].reshape(-1), t.num_clips,
                                              t.proposal_top_k)] == [c[:2] for c in kept]


def _grid_pairs(first_window: int, n_windows: int):
    """(window start frame, cells of A, cells of B) of pairs on the map's
    grid whose IoU is exactly 1/2: A = [s, s + 2L), B = [s + L, s + 2L)."""
    for w in range(first_window, first_window + n_windows):
        for s in range(0, 40):
            for length in range(1, 13):
                if s + 2 * length <= 64:
                    yield (w - 1) * 64, [[s, s + 2 * length], [s + length, s + 2 * length]]


def _published_kept(cells, ws):
    """The published decoding of one such pair in float64 (Python 4-dp
    rounding of float64 seconds, IoU over the standard union): how many of
    the two are kept at NMS 0.5."""
    sp = [[grounding.r4((c * 2 + ws) * 0.2) for c in pair] for pair in cells]
    (s1, e1), (s2, e2) = sp
    inter = max(0.0, min(e1, e2) - max(s1, s2))
    return 1 if inter / ((e1 - s1) + (e2 - s2) - inter) > 0.5 else 2


def test_grid_ties_decided_as_the_program_decides():
    """Candidate pairs whose IoU is exactly 1/2 on the 0.4 s grid at MAD's
    magnitudes (window starts near 7 000 s): the program's device post
    (`_post`, standard union) and the reference's `post` keep the same
    moments for every pair, while the float64 decoding keeps another count
    for a tenth of them or more."""
    cfg = tan_mad_config()
    pairs = list(_grid_pairs(545, 2))
    n = len(pairs)
    cells = torch.tensor([c for _, c in pairs], dtype=torch.float32)      # (n, 2, 2)
    ws = torch.tensor([w for w, _ in pairs], dtype=torch.int32)
    # the program's seconds: (cell * frame_stride + window start) * clip_length
    sec = (cells * cfg.tan.frame_stride + ws[:, None, None]) * cfg.data.clip_length
    prob = torch.tensor([0.9, 0.8]).expand(n, 2)
    match = torch.tensor([0.7, 0.6]).expand(n, 2)
    fake = SimpleNamespace(cfg=cfg, nms_hull=False)
    k_sp, k_sc, k_va = TanInferencePipeline._post(
        fake, torch.ones(1, n, 1, dtype=torch.bool), sec[None, :, None], prob[None, :, None],
        match[None, :, None], torch.ones(1, n, 1, 2, dtype=torch.bool))
    differ = 0
    for i, (w, c) in enumerate(pairs):
        r_sec = ref.seconds(cells[i, :, 0], cells[i, :, 1], cfg.tan, float(w),
                            cfg.data.clip_length)
        assert torch.equal(r_sec, sec[i])
        want = ref.post(r_sec[None].numpy(), prob[i][None].numpy(), match[i][None].numpy(),
                        np.ones((1, 2), bool), cfg.eval, "cpu")
        for m, name in enumerate(grounding.MODALITIES):
            kept = int(k_va[m, 0, i].sum())
            got = [[float(k_sp[m, 0, i, j, 0]), float(k_sp[m, 0, i, j, 1]),
                    float(k_sc[m, 0, i, j])] for j in range(kept)]
            assert got == want[name], (w, c, name)
        differ += _published_kept(c, w) != len(want["fusion"])
    assert differ >= n // 10, (differ, n)


def test_tan_counts_match_flop_counter():
    """One window of the port's ConeTanModel at tan_mad's full width on the
    meta device, counted by FlopCounterMode, against the count's map and
    text (at the 20 tokens the model is handed): within 1 %."""
    t = tan_mad_config().tan
    model = ConeTanModel(t, device="meta").eval()
    args = (torch.empty(1, 20, t.t_feat_dim, device="meta"), torch.ones(1, 20, device="meta"),
            torch.empty(1, t.num_clips * t.frame_stride, t.v_feat_dim, device="meta"))
    with FlopCounterMode(display=False) as fc:
        model(*args)
    want = tan_counts.map_flops(t) + tan_counts.text_flops(t, 20)
    assert abs(fc.get_total_flops() / want - 1) <= 0.01
    assert 249e9 <= tan_counts.map_flops(t) <= 249.3e9
