"""The port's InferencePipeline (cone_tpu_torch/eval/pipeline.py) end to end
on the CPU.

  * the reference-generated fixtures tests/golden/e2e_inference.npz and
    e2e_inference_mad.npz (the latter with ctx_buckets (416, 512)): window
    ranklists exact, all three modalities within the tolerances of
    tests/test_e2e_inference_parity.py, through the fused and the staged
    paths, with the coarse kernel switch off and on;
  * edge_inference.npz (ragged short videos, nms on and off) through both
    paths, and postproc.npz / postproc_mad.npz through the host and device
    post-processing;
  * the port's run_fused against cone_tpu's on one synthetic corpus with
    converted params, coarse kernel off and on (the Pallas kernel in
    interpret mode), for the float32, bfloat16 and int8 corpus dtypes.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from cone_tpu.config import ConeConfig as JConeConfig
from cone_tpu.data import make_synthetic_dataset as j_make_synthetic
from cone_tpu.eval.pipeline import InferencePipeline as JInferencePipeline
from cone_tpu.models.init import build_model_and_params
from cone_tpu_torch.config import ConeConfig, DataConfig, EvalConfig, ModelConfig
from cone_tpu_torch.convert import load_reference_state_dict, params_from_jax
from cone_tpu_torch.data import (
    GroundingDataset,
    InMemoryArrayStore,
    QueryExample,
    TextFeatureStore,
    make_synthetic_dataset,
)
from cone_tpu_torch.eval.pipeline import InferencePipeline, make_pipeline
from cone_tpu_torch.models.cone import ConeModel

_DIR = os.path.join(os.path.dirname(__file__), "golden")
GOLDEN = {
    "base": dict(fname="e2e_inference.npz", max_ctx_l=160, ctx_buckets=()),
    "mad": dict(fname="e2e_inference_mad.npz", max_ctx_l=512, ctx_buckets=(416, 512)),
}
SPAN_ATOL, SCORE_ATOL = 1e-3, 2e-3  # tests/test_e2e_inference_parity.py:110-113
MODALITIES = ("fusion", "proposal", "matching")


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    # cone_tpu's Pallas coarse kernel runs in interpret mode on the CPU
    orig = pl.pallas_call
    monkeypatch.setattr(
        pl, "pallas_call", lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    yield


def _with_eval(cfg, **kw):
    return cfg.replace(eval=dataclasses.replace(cfg.eval, **kw))


@pytest.fixture(scope="module", params=sorted(GOLDEN))
def golden(request):
    spec = GOLDEN[request.param]
    g = dict(np.load(os.path.join(_DIR, spec["fname"])).items())
    max_v_l, topk_window, dim = g["meta"].tolist()
    cfg = ConeConfig(
        model=ModelConfig(t_feat_dim=dim, v_motion_feat_dim=dim, v_appear_feat_dim=dim,
                          max_q_l=8, max_v_l=max_v_l),
        data=DataConfig(max_v_l=max_v_l, max_q_l=8, clip_length=float(g["clip_len"]),
                        topk_window=topk_window, max_ctx_l=spec["max_ctx_l"],
                        normalize_v=False, normalize_t=False),
        eval=EvalConfig(nms_thd=0.5, max_after_nms=5, max_before_nms=200,
                        query_chunk=3, ctx_buckets=spec["ctx_buckets"]))
    qids = sorted(k[4:] for k in g if k.startswith("tok_"))
    ds = GroundingDataset(
        [QueryExample(q, "", q.split("_")[0], q.split("_")[0], [0, 0], 0.0) for q in qids],
        InMemoryArrayStore({k[6:]: g[k] for k in g if k.startswith("video_")}),
        TextFeatureStore(InMemoryArrayStore({q: g[f"tok_{q}"] for q in qids}),
                         InMemoryArrayStore({q: g[f"cls_{q}"][None] for q in qids})),
        cfg.data)
    model = ConeModel(cfg.model, device="cpu")
    model.load_state_dict(load_reference_state_dict(
        {k: v for k, v in g.items() if k.startswith("w::")}))
    return g, cfg, ds, model, qids


@pytest.mark.parametrize("kernel", [False, True], ids=["plain_coarse", "kernel_coarse"])
@pytest.mark.parametrize("path", ["staged", "fused"])
def test_golden_end_to_end(golden, path, kernel):
    g, cfg, ds, model, qids = golden
    pipe = InferencePipeline(model, ds, _with_eval(cfg, use_pallas_coarse=kernel), device="cpu")
    fused = path == "fused"
    subs, ranklists = pipe.run(host_postproc=not fused, fused=fused)
    for q in qids:
        assert ranklists[q] == g[f"{q}_ranklist"].tolist(), q
    # golden rows: st, ed, prop, match, fused; fused-path rows: st, ed, score
    score_col = {"fusion": 4, "proposal": 2, "matching": 3}
    for name in MODALITIES:
        by_qid = {r["query_id"]: r for r in subs[name]}
        for q in qids:
            want = g[f"{q}_{name}"]
            got = np.asarray(by_qid[q]["predicted_times"], np.float64)
            assert got.shape[0] == want.shape[0], (q, name, got.shape, want.shape)
            np.testing.assert_allclose(got[:, :2], want[:, :2], atol=SPAN_ATOL,
                                       err_msg=f"{q} {name} spans")
            if fused:
                np.testing.assert_allclose(got[:, 2], want[:, score_col[name]],
                                           atol=SCORE_ATOL, err_msg=f"{q} {name} score")
            else:
                np.testing.assert_allclose(got[:, 2:], want[:, 2:], atol=SCORE_ATOL,
                                           err_msg=f"{q} {name} scores")


def test_golden_device_postproc_matches_host(golden):
    """postprocess_device (fusion only) agrees with the host path."""
    _, cfg, ds, model, qids = golden
    pipe = InferencePipeline(model, ds, cfg, device="cpu")
    dev, rank_d = pipe.run(host_postproc=False)
    host, rank_h = pipe.run(host_postproc=True)
    assert rank_d == rank_h
    by_host = {r["query_id"]: np.asarray(r["predicted_times"]) for r in host["fusion"]}
    for r in dev["fusion"]:
        got, want = np.asarray(r["predicted_times"]), by_host[r["query_id"]]
        assert got.shape[0] == want.shape[0]
        np.testing.assert_allclose(got[:, :2], want[:, :2], atol=SPAN_ATOL)
        np.testing.assert_allclose(got[:, 2], want[:, 4], atol=SCORE_ATOL)


@pytest.fixture(scope="module")
def edge():
    """tests/golden/edge_inference.npz: videos shorter than a stride and a
    window, exact stride multiples, duplicate candidates (the fixture of
    tests/test_edge_cases.py)."""
    g = dict(np.load(os.path.join(_DIR, "edge_inference.npz")).items())
    max_v_l, topk_window, dim = g["meta"].tolist()
    cfg = ConeConfig(
        model=ModelConfig(t_feat_dim=dim, v_motion_feat_dim=dim, v_appear_feat_dim=dim,
                          max_q_l=8, max_v_l=max_v_l),
        data=DataConfig(max_v_l=max_v_l, max_q_l=8, clip_length=1.0,
                        topk_window=topk_window, max_ctx_l=128, normalize_v=False,
                        normalize_t=False),
        eval=EvalConfig(nms_thd=0.5, max_after_nms=5, max_before_nms=200, query_chunk=2,
                        video_batch=2, use_pallas_coarse=True))
    qids = sorted(k[4:] for k in g if k.startswith("tok_"))
    ds = GroundingDataset(
        [QueryExample(q, "", q.rsplit("_", 1)[0], q.rsplit("_", 1)[0], [0, 0], 0.0)
         for q in qids],
        InMemoryArrayStore({k[6:]: g[k] for k in g if k.startswith("video_")}),
        TextFeatureStore(InMemoryArrayStore({q: g[f"tok_{q}"] for q in qids}),
                         InMemoryArrayStore({q: g[f"cls_{q}"][None] for q in qids})),
        cfg.data)
    model = ConeModel(cfg.model, device="cpu")
    model.load_state_dict(load_reference_state_dict(
        {k: v for k, v in g.items() if k.startswith("w::")}))
    return g, cfg, ds, model, qids


@pytest.mark.parametrize("nms", ["nms", "nonms"])
@pytest.mark.parametrize("path", ["staged", "fused"])
def test_edge_golden(edge, path, nms):
    g, cfg, ds, model, qids = edge
    if nms == "nonms":
        cfg = _with_eval(cfg, nms_thd=-1.0)
    fused = path == "fused"
    subs, ranklists = InferencePipeline(model, ds, cfg, device="cpu").run(
        host_postproc=not fused, fused=fused)
    for q in qids:
        # the reference sorted with torch.sort, whose tie order is
        # unspecified: equal window scores may come in any order
        got, want, ws = ranklists[q], g[f"{q}_ranklist"], np.round(g[f"{q}_wscores"], 10)
        assert sorted(got) == sorted(want.tolist()), q
        np.testing.assert_array_equal(ws[got], ws[want], err_msg=q)
    score_col = {"fusion": 4, "proposal": 2, "matching": 3}
    for name in MODALITIES:
        by_qid = {r["query_id"]: r for r in subs[name]}
        for q in qids:
            want = g[f"{q}_{name}" + ("_nonms" if nms == "nonms" else "")]
            got = np.asarray(by_qid[q]["predicted_times"], np.float64)
            assert got.shape[0] == want.shape[0], (q, name, got.shape, want.shape)
            np.testing.assert_allclose(got[:, :2], want[:, :2], atol=SPAN_ATOL)
            np.testing.assert_allclose(got[:, 2:], want[:, [score_col[name]] if fused else
                                                        slice(2, None)], atol=SCORE_ATOL)


class _PostprocOnly(InferencePipeline):
    """No model: only the post-processing methods are used."""

    def __init__(self, cfg):
        self.cfg, self.device = cfg, torch.device("cpu")


@pytest.mark.parametrize("fname,thd,tag", [
    ("postproc.npz", 0.5, ""),
    ("postproc_mad.npz", 0.5, "nms_"),    # max_before_nms=200 binds, with ties
    ("postproc_mad.npz", -1.0, "raw_"),   # the no-NMS sentinel
])
def test_postproc_matches_reference_fixture(fname, thd, tag):
    """The reference's own score fusion + NMS outputs (the fixtures of
    tests/test_postproc_parity.py): the host path to 1e-9 as there, the
    device path (fusion modality) within the fused-path tolerances."""
    g = dict(np.load(os.path.join(_DIR, fname)).items())
    cfg = ConeConfig(data=DataConfig(clip_length=1.0),
                     eval=EvalConfig(nms_thd=thd, max_before_nms=200, max_after_nms=5))
    pipe = _PostprocOnly(cfg)
    rows = [dict(example=QueryExample(f"q{i}", "", "v", "v", [0, 0], 0.0),
                 spans_sec=g[f"q{i}_spans"], prob=g[f"q{i}_prob"], match=g[f"q{i}_match"],
                 win_valid=np.ones(g[f"q{i}_prob"].shape[0], bool))
            for i in range(int(g["n_queries"]))]
    host = pipe.postprocess_host(rows)
    device = pipe.postprocess_device(rows)
    for i in range(len(rows)):
        for name in MODALITIES:
            got = np.asarray(host[name][i]["predicted_times"], np.float64)
            want = g[f"q{i}_{tag}{name}"]
            assert got.shape == want.shape, (i, name, got.shape, want.shape)
            np.testing.assert_allclose(got, want, atol=1e-9, err_msg=f"q{i} {name}")
        got = np.asarray(device[i]["predicted_times"], np.float64)
        want = g[f"q{i}_{tag}fusion"]
        assert got.shape[0] == want.shape[0], (i, got.shape, want.shape)
        np.testing.assert_allclose(got[:, :2], want[:, :2], atol=SPAN_ATOL)
        np.testing.assert_allclose(got[:, 2], want[:, 4], atol=SCORE_ATOL)


DIM = 32


@pytest.fixture(scope="module")
def synthetic():
    """One small corpus and one random model, in both packages."""
    cfg = ConeConfig(
        model=ModelConfig(hidden_dim=64, nheads=4, dim_feedforward=128, t_feat_dim=DIM,
                          v_motion_feat_dim=DIM, v_appear_feat_dim=DIM, max_q_l=8,
                          max_v_l=32),
        data=DataConfig(max_v_l=32, max_q_l=8, clip_length=1.0, topk_window=5,
                        max_ctx_l=256, max_windows=5),
        eval=EvalConfig(nms_thd=0.5, max_after_nms=5, query_chunk=4, video_batch=2))
    jcfg = JConeConfig.from_json(cfg.to_json())
    kw = dict(n_videos=3, queries_per_video=3, ctx_l_range=(100, 220), dim=DIM,
              signal=3.0, seed=5)
    jmodel, params = build_model_and_params(jcfg.model, seed=0)
    model = ConeModel(cfg.model, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg.model))
    return (cfg, make_synthetic_dataset(cfg.data, **kw), model,
            jcfg, j_make_synthetic(jcfg.data, **kw), jmodel, params)


def _assert_same_moments(subs, want_subs):
    for name in MODALITIES:
        want = {r["query_id"]: np.asarray(r["predicted_times"]) for r in want_subs[name]}
        for r in subs[name]:
            got = np.asarray(r["predicted_times"])
            w = want[r["query_id"]]
            assert got.shape == w.shape, (name, r["query_id"], got.shape, w.shape)
            np.testing.assert_allclose(got[:, :2], w[:, :2], atol=SPAN_ATOL)
            np.testing.assert_allclose(got[:, 2:], w[:, 2:], atol=SCORE_ATOL)


# the fixture's eval.video_batch 2 over 3 videos: one group holds a padded
# item; "buckets" splits the videos 180 and 122 frames long (192) from the
# one 199 long (256), so each bucket has its own window count and the
# 256 one a padded item beside a 3-query chunk of 4 rows
FUSED_CASES = [pytest.param(kernel, dtype, {}, id=f"{kid}-{dtype}")
               for kernel, kid in ((False, "plain_coarse"), (True, "kernel_coarse"))
               for dtype in ("float32", "bfloat16", "int8")] + [
    pytest.param(True, "float32", dict(ctx_buckets=(192, 256)),
                 id="kernel_coarse-float32-buckets")]


@pytest.mark.parametrize("kernel,corpus_dtype,layout", FUSED_CASES)
def test_run_fused_matches_cone_tpu(synthetic, kernel, corpus_dtype, layout):
    cfg, ds, model, jcfg, jds, jmodel, params = synthetic
    opts = dict(use_pallas_coarse=kernel, corpus_dtype=corpus_dtype, **layout)
    subs, ranklists = InferencePipeline(model, ds, _with_eval(cfg, **opts),
                                        device="cpu").run(host_postproc=False, fused=True)
    jsubs, jranklists = JInferencePipeline(jmodel, params, jds, _with_eval(jcfg, **opts)).run(
        host_postproc=False, fused=True)
    assert ranklists == jranklists
    _assert_same_moments(subs, jsubs)


@pytest.mark.parametrize("corpus_dtype", ["float32", "bfloat16", "int8"])
def test_corpus_encoding_matches_cone_tpu(synthetic, corpus_dtype):
    cfg, ds, model, jcfg, jds, jmodel, params = synthetic
    pipe = InferencePipeline(model, ds, _with_eval(cfg, corpus_dtype=corpus_dtype), device="cpu")
    jpipe = JInferencePipeline(jmodel, params, jds, _with_eval(jcfg, corpus_dtype=corpus_dtype))
    clip_id = ds.examples[0].clip_id
    x, scale = pipe.resident.get(clip_id)[:2]
    jx, jscale = jpipe._encode_corpus(jpipe._padded_video(clip_id)[0])
    np.testing.assert_array_equal(x.float().numpy(), np.asarray(jx).astype(np.float32))
    if corpus_dtype == "int8":
        np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    else:
        assert scale is None and float(np.asarray(jscale)) == 1.0


def test_staged_matches_cone_tpu(synthetic):
    cfg, ds, model, jcfg, jds, jmodel, params = synthetic
    subs, ranklists = InferencePipeline(model, ds, cfg, device="cpu").run(host_postproc=True)
    jsubs, jranklists = JInferencePipeline(jmodel, params, jds, jcfg).run(host_postproc=True)
    assert ranklists == jranklists
    _assert_same_moments(subs, jsubs)


def test_stack_cache_is_byte_bounded(synthetic):
    """A tiny byte cap keeps at most one stacked group, and results do not
    change with the cache on, capped, or off."""
    cfg, ds, model, *_ = synthetic
    pipe = InferencePipeline(model, ds, cfg, device="cpu")
    ref = pipe.run(host_postproc=False, fused=True)
    pipe.stack_cache_bytes = 1
    assert pipe.run(host_postproc=False, fused=True) == ref
    assert len(pipe._stack_cache) == 1
    pipe.stack_cache = False
    pipe.reset()
    assert pipe.run(host_postproc=False, fused=True) == ref
    assert not pipe._stack_cache


def test_tan_family_is_not_ported_yet(synthetic):
    """The 2D-TAN family is ported now (tests/test_torch_tan_pipeline.py
    holds it against cone_tpu): make_pipeline builds its pipeline, which
    refuses a map that does not fit the window."""
    from cone_tpu_torch.eval.tan_pipeline import TanInferencePipeline
    from cone_tpu_torch.models.tan import ConeTanModel

    cfg, ds, model, *_ = synthetic
    tan = cfg.replace(model=dataclasses.replace(cfg.model, model_family="tan"))
    with pytest.raises(ValueError, match="num_clips"):   # 64 map cells, max_v_l 32
        make_pipeline(model, ds, tan, device="cpu")
    tan = tan.replace(tan=dataclasses.replace(
        tan.tan, num_clips=32, hidden_size=8, v_feat_dim=DIM, t_feat_dim=DIM,
        txt_hidden_size=8, lstm_layers=1, map_hidden_sizes=(8,), map_kernel_sizes=(3,),
        map_paddings=(1,)))
    pipe = make_pipeline(ConeTanModel(tan.tan, device="cpu"), ds, tan, device="cpu")
    assert isinstance(pipe, TanInferencePipeline) and not pipe.nms_hull
