"""The plain reference against the port at a small size on the CPU, and
the port in bfloat16 failing the comparison that decides `correct`."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.data import seeded_state_dict
from benchmark.reference import cone, grounding
from benchmark.tests.conftest import TINY_MODEL, tiny_run


def small_model_cfg():
    import dataclasses

    from cone_tpu_torch.config import ego4d_config

    return dataclasses.replace(ego4d_config().model, **TINY_MODEL)


def test_forward_matches_the_port():
    from cone_tpu_torch.models.cone import ConeModel

    m = small_model_cfg()
    params = seeded_state_dict(m, 9, "cpu")
    port = ConeModel(m, device="cpu")
    port.load_state_dict(params, strict=True)
    port.eval()
    g = torch.Generator().manual_seed(0)
    txt = torch.randn(6, 20, m.t_feat_dim, generator=g)
    tmask = (torch.arange(20) < torch.tensor([[5], [9], [20], [12], [7], [3]])).float()
    vid = torch.randn(6, 90, m.v_motion_feat_dim, generator=g)
    vmask = (torch.arange(90) < torch.tensor([[90], [60], [45], [90], [11], [89]])).float()
    with torch.no_grad():
        got = port(txt, tmask, vid, vmask)
        want = cone.forward(params, m, txt, tmask, vid, vmask)
        cls = torch.randn(6, m.v_appear_feat_dim, generator=g)
        gm = port.clip_matching_pred(cls, vid, vmask, got["pred_spans"])
        wm = cone.matching_pred(params, m, cls, vid, vmask, want["pred_spans"])
    for a, b in ((got["pred_logits"], want["pred_logits"]), (got["pred_spans"], want["pred_spans"]),
                 (got["saliency_scores"], want["saliency"]), (gm, wm)):
        assert torch.allclose(a, b, atol=2e-5, rtol=1e-5)
    for (gl, gs), aux in zip(((a["pred_logits"], a["pred_spans"]) for a in got["aux_outputs"]),
                             want["aux"]):
        assert torch.allclose(gl, aux[0], atol=2e-5) and torch.allclose(gs, aux[1], atol=2e-5)


def test_param_table_is_the_ports():
    from cone_tpu_torch.models.cone import ConeModel

    m = small_model_cfg()
    port = {k: tuple(v.shape) for k, v in ConeModel(m, device="cpu").state_dict().items()}
    assert dict(cone.param_shapes(m)) == port


def test_window_scores_and_ranking_match_the_port():
    from cone_tpu_torch.ops.windows import num_windows, window_scores_from_frame_scores

    g = torch.Generator().manual_seed(1)
    fs = torch.randn(3, 1000, generator=g)
    want = grounding.window_scores(fs, 45)
    got, valid = window_scores_from_frame_scores(fs, 1000, 45, num_windows(1000, 45))
    assert torch.equal(got[:, : want.shape[1]], want) and valid.sum(-1).eq(want.shape[1]).all()


def test_ranklist_gap_and_moment_compare():
    s = np.array([0.1, 0.5, 0.5, 0.3])
    assert grounding.ranklist_gap(s, [1, 2, 3, 0]) == 0.0
    assert grounding.ranklist_gap(s, [2, 1, 3, 0]) == 0.0          # a tie either way
    assert grounding.ranklist_gap(s, [1, 3, 2, 0]) == pytest.approx(0.2)
    assert grounding.ranklist_gap(s, [1, 2, 3]) == float("inf")
    a = [[1.0, 2.0, 0.5]]
    assert not grounding.moments_differ(a, [[1.0005, 2.0, 0.501]], 1e-3, 2e-3)
    assert grounding.moments_differ(a, [[1.01, 2.0, 0.5]], 1e-3, 2e-3)
    assert grounding.moments_differ(a, [], 1e-3, 2e-3)


def test_nms_matches_the_port():
    from cone_tpu_torch.ops.nms import temporal_nms_host

    rng = np.random.default_rng(4)
    for _ in range(20):
        st = rng.uniform(0, 50, 30)
        preds = [[float(a), float(a + b), float(s)] for a, b, s in
                 zip(st, rng.uniform(1, 20, 30), rng.uniform(0, 1, 30))]
        assert grounding.nms(preds, 0.5, 5) == temporal_nms_host(preds, 0.5, 5)


@pytest.mark.parametrize("cell", ["ego4d-nlq-val", "ego4d-train"])
def test_port_in_bfloat16_fails(cell):
    """The nearest lower precision the port has of its own (bfloat16
    compute) put on the timed path: `correct` reads false."""
    r = tiny_run(cell, overrides={"model": {"compute_dtype": "bfloat16"}})
    assert r["correct"] is False
