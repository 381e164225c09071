"""The port's 2D-TAN inference (cone_tpu_torch/eval/tan_pipeline.py) and
serving against cone_tpu's on one synthetic corpus and the same weights,
on the CPU.

Weights: seeded random CONE_TAN weights (convert.random_reference_tan_state_dict),
carried to the JAX side with convert.tan_params_to_jax. The coarse stage
runs with eval.use_pallas_coarse on: cone_tpu's Pallas kernel in
interpret mode, the port's plain version (a CPU tensor). Limits: window
ranklists exact; kept moments spans atol 1e-3, scores atol 2e-3, for the
three modalities (tests/test_e2e_inference_parity.py:110-113). Covered:
the staged path with host and device post-processing, the fused path,
within-window NMS on and off, the stride-2 (TAN-MAD) geometry, the
reference's tie order, the family's adapter knob gating the coarse stage,
OnlineLocalizer and CorpusRetriever.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from cone_tpu.config import ConeConfig as JConeConfig
from cone_tpu.data import make_synthetic_dataset as j_make_synthetic
from cone_tpu.eval.pipeline import make_pipeline as j_make_pipeline
from cone_tpu.eval.tan_pipeline import TanInferencePipeline as JTanInferencePipeline
from cone_tpu.models.tan import ConeTanModel as JConeTanModel
from cone_tpu.serve.corpus import CorpusRetriever as JCorpusRetriever
from cone_tpu.serve.localizer import OnlineLocalizer as JOnlineLocalizer
from cone_tpu_torch.config import ConeConfig, DataConfig, EvalConfig, ModelConfig, TanConfig
from cone_tpu_torch.convert import (
    load_reference_tan_state_dict,
    random_reference_tan_state_dict,
    tan_params_to_jax,
)
from cone_tpu_torch.data import make_synthetic_dataset
from cone_tpu_torch.eval.pipeline import make_pipeline
from cone_tpu_torch.eval.tan_pipeline import TanInferencePipeline, top_k_ref_order
from cone_tpu_torch.models.tan import ConeTanModel
from cone_tpu_torch.serve.corpus import CorpusRetriever
from cone_tpu_torch.serve.localizer import OnlineLocalizer

DIM, NC = 32, 32
SPAN_ATOL, SCORE_ATOL = 1e-3, 2e-3
MODALITIES = ("fusion", "proposal", "matching")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small eager ops: torch's intra-op pool spins against the other
    test workers (tests/test_torch_train.py has the same fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    # cone_tpu's Pallas coarse kernel runs in interpret mode on the CPU
    orig = pl.pallas_call
    monkeypatch.setattr(
        pl, "pallas_call", lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    yield


def _cfg(stride2=False, **model_kw):
    """tests/test_tan_e2e.py's geometry: a 32x32 map, hidden 48."""
    fs = 2 if stride2 else 1
    return ConeConfig(
        model=ModelConfig(model_family="tan", t_feat_dim=DIM, v_appear_feat_dim=DIM,
                          v_motion_feat_dim=DIM, max_q_l=8, max_v_l=NC * fs, **model_kw),
        tan=TanConfig(num_clips=NC, hidden_size=48, v_feat_dim=DIM, t_feat_dim=DIM,
                      txt_hidden_size=48, lstm_layers=2, num_scale_layers=(8, 4),
                      map_hidden_sizes=(48, 48), map_kernel_sizes=(5, 5),
                      map_paddings=(4, 0), frame_kernel=fs, frame_stride=fs,
                      proposal_top_k=5),
        data=DataConfig(dset_name="synthetic", max_v_l=NC * fs, max_q_l=8,
                        clip_length=0.5 if stride2 else 1.0, topk_window=4,
                        max_ctx_l=512 if stride2 else 256),
        eval=EvalConfig(query_chunk=4, use_pallas_coarse=True))


class _Setup:
    """One geometry: the port's model and dataset, cone_tpu's params and
    dataset, and cone_tpu's runs, computed once each."""

    def __init__(self, stride2):
        self.cfg = _cfg(stride2)
        self.jcfg = JConeConfig.from_json(self.cfg.to_json())
        sd = random_reference_tan_state_dict(self.cfg.tan, seed=3)
        self.model = ConeTanModel(self.cfg.tan, device="cpu")
        self.model.load_state_dict(load_reference_tan_state_dict(sd))
        self.params = tan_params_to_jax(sd, self.cfg.tan)
        kw = (dict(n_videos=3, queries_per_video=4, ctx_l_range=(180, 400), seed=11)
              if stride2 else dict(n_videos=3, queries_per_video=4,
                                   ctx_l_range=(90, 180), seed=9))
        self.ds = make_synthetic_dataset(self.cfg.data, dim=DIM, signal=3.0, **kw)
        self.jds = j_make_synthetic(self.jcfg.data, dim=DIM, signal=3.0, **kw)
        self._jax = {}

    def jax_run(self, path, nms):
        key = (path, nms)
        if key not in self._jax:
            pipe = JTanInferencePipeline(
                JConeTanModel(self.jcfg.tan), self.params, self.jds, self.jcfg, self.jcfg.tan,
                proposal_top_k=5, nms_within_window=nms)
            self._jax[key] = pipe.run(**_RUN[path])
        return self._jax[key]

    def port_run(self, path, nms, cfg=None):
        pipe = TanInferencePipeline(self.model, self.ds, cfg or self.cfg, self.cfg.tan,
                                    proposal_top_k=5, nms_within_window=nms, device="cpu")
        return pipe.run(**_RUN[path])


_RUN = {"staged_host": dict(host_postproc=True), "staged_device": dict(host_postproc=False),
        "fused": dict(host_postproc=False, fused=True)}


@pytest.fixture(scope="module")
def setups():
    return {False: _Setup(False), True: _Setup(True)}


def _assert_runs_close(got, want):
    (subs, ranks), (jsubs, jranks) = got, want
    assert ranks == jranks
    assert set(subs) == set(jsubs)
    for name in subs:
        by_qid = {r["query_id"]: np.asarray(r["predicted_times"], np.float64)
                  for r in jsubs[name]}
        assert len(subs[name]) == len(by_qid)
        for r in subs[name]:
            g, w = np.asarray(r["predicted_times"], np.float64), by_qid[r["query_id"]]
            assert g.shape == w.shape and len(g) >= 1, (name, r["query_id"])
            np.testing.assert_allclose(g[:, :2], w[:, :2], atol=SPAN_ATOL)
            np.testing.assert_allclose(g[:, 2:], w[:, 2:], atol=SCORE_ATOL)


@pytest.mark.parametrize("path,nms,stride2", [
    ("staged_host", True, False), ("fused", True, False), ("staged_device", True, False),
    ("staged_host", False, False), ("fused", False, False),
    ("staged_host", True, True), ("fused", True, True),
])
def test_matches_cone_tpu(setups, path, nms, stride2):
    s = setups[stride2]
    got = s.port_run(path, nms)
    _assert_runs_close(got, s.jax_run(path, nms))
    if path != "staged_device":
        assert set(got[0]) == set(MODALITIES)
    if stride2:  # cell edges decode to multiples of TARGET_STRIDE clips
        for r in got[0]["fusion"]:
            for t in r["predicted_times"]:
                assert round(t[0] / s.cfg.data.clip_length) % 2 == 0


@pytest.mark.parametrize("nms", [True, False])
def test_fused_equals_staged(setups, nms):
    """The fused run against the staged run with the device post-processing
    (the same float32 NMS). Against the host's float64 NMS the TAN family can
    legitimately differ: map cells sit on a clip grid, so spans of 32 and 64
    clips from one start have an IoU of exactly 0.5 = eval.nms_thd, and the
    `iou > nms_thd` decision is then the rounding's (cone_tpu's own TAN test
    compares fused with staged device post-processing for this reason)."""
    s = setups[False]
    (fsubs, frank), (dsubs, drank) = s.port_run("fused", nms), s.port_run("staged_device", nms)
    assert frank == drank
    by_qid = {r["query_id"]: np.asarray(r["predicted_times"]) for r in dsubs["fusion"]}
    for r in fsubs["fusion"]:
        g, w = np.asarray(r["predicted_times"]), by_qid[r["query_id"]]
        assert g.shape == w.shape
        np.testing.assert_allclose(g[:, :2], w[:, :2], atol=SPAN_ATOL)
        np.testing.assert_allclose(g[:, 2], w[:, 2], atol=SCORE_ATOL)


def test_top_k_ref_order_prefers_the_highest_cell_on_ties():
    """Equal scores rank the HIGHEST flat cell first, as the reference's
    np.argsort(ravel())[::-1] and cone_tpu's top_k on the reversed row."""
    x = np.array([[0.5, 0.9, 0.5, 0.9, 0.1, 0.9, 0.5, 0.0],
                  [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
                  [0.3, 0.7, 0.7, 0.2, 0.7, 0.3, 0.1, 0.3]], np.float32)
    vals, idx = top_k_ref_order(torch.from_numpy(x), 6)
    ref = np.argsort(x, axis=-1, kind="stable")[:, ::-1][:, :6]
    np.testing.assert_array_equal(idx.numpy(), ref)
    np.testing.assert_array_equal(vals.numpy(), np.take_along_axis(x, ref, -1))
    jv, jr = jax.lax.top_k(x[:, ::-1], 6)
    np.testing.assert_array_equal(idx.numpy(), x.shape[-1] - 1 - np.asarray(jr))
    assert idx[0, :3].tolist() == [5, 3, 1] and idx[1, :3].tolist() == [7, 6, 5]


@pytest.mark.parametrize("model_knob,tan_knob", [("none", "linear"), ("linear", "none")])
def test_coarse_adapter_follows_the_family_knob(setups, model_knob, tan_knob):
    """The coarse stage adapts with the TAN head's adapter exactly when
    tan.adapter_module says so, whatever model.adapter_module says: the
    ranklists equal cone_tpu's on the same config. With the TAN knob on and
    the CONE knob off, gating on the CONE knob would skip the adapter, and
    the adapter does change these ranklists."""
    s = setups[False]
    cfg = s.cfg.replace(model=dataclasses.replace(s.cfg.model, adapter_module=model_knob),
                        tan=dataclasses.replace(s.cfg.tan, adapter_module=tan_knob))
    jcfg = JConeConfig.from_json(cfg.to_json())
    sd = random_reference_tan_state_dict(cfg.tan, seed=3)
    model = ConeTanModel(cfg.tan, device="cpu")
    model.load_state_dict(load_reference_tan_state_dict(sd))
    got = make_pipeline(model, s.ds, cfg, device="cpu").coarse()
    want = j_make_pipeline(JConeTanModel(jcfg.tan), tan_params_to_jax(sd, cfg.tan), s.jds,
                           jcfg).coarse()
    assert got == want
    if tan_knob == "linear":
        skipped = make_pipeline(model, s.ds, cfg.replace(
            tan=dataclasses.replace(cfg.tan, adapter_module="none")), device="cpu").coarse()
        assert skipped != got


def test_online_localizer_matches_cone_tpu(setups):
    s = setups[False]
    t = OnlineLocalizer(s.model, s.cfg, device="cpu")
    j = JOnlineLocalizer(JConeTanModel(s.jcfg.tan), s.params, s.jcfg)
    assert isinstance(t.pipe, TanInferencePipeline)
    for ex in s.ds.examples[:3]:
        feats = s.ds.video_features(ex.clip_id)[0]
        tok, cls = s.ds.query_features(ex.query_id)
        got, want = np.asarray(t.localize(feats, tok, cls)), np.asarray(j.localize(feats, tok, cls))
        assert 1 <= len(got) == len(want) <= s.cfg.eval.max_after_nms
        np.testing.assert_allclose(got[:, :2], want[:, :2], atol=SPAN_ATOL)
        np.testing.assert_allclose(got[:, 2:], want[:, 2:], atol=SCORE_ATOL)


def test_corpus_retriever_matches_cone_tpu(setups):
    s = setups[False]
    t = CorpusRetriever(s.model, s.cfg, device="cpu")
    j = JCorpusRetriever(JConeTanModel(s.jcfg.tan), s.params, s.jcfg)
    for cid in s.ds.video_ids:
        feats = s.ds.video_features(cid)[0]
        t.add_video(cid, feats)
        j.add_video(cid, feats)
    queries = [s.ds.query_features(ex.query_id) for ex in s.ds.examples[:4]]
    got = t.search_batch([q[0] for q in queries], np.stack([q[1] for q in queries]))
    want = j.search_batch([q[0] for q in queries], np.stack([q[1] for q in queries]))
    for g_rows, w_rows in zip(got, want):
        assert g_rows and [m["video_id"] for m in g_rows] == [m["video_id"] for m in w_rows]
        for g, w in zip(g_rows, w_rows):
            np.testing.assert_allclose(g["span"], w["span"], atol=SPAN_ATOL)
            np.testing.assert_allclose([g["prop"], g["match"], g["fused"]],
                                       [w["prop"], w["match"], w["fused"]], atol=SCORE_ATOL)
    cid = s.ds.examples[0].clip_id
    assert [c for c, _ in t.rank_videos(queries[0][1])] == \
        [c for c, _ in j.rank_videos(queries[0][1])]
    assert t.rank_videos(queries[0][1])[0][0] == cid   # the planted video first


@pytest.mark.parametrize("top_p", [5, 40], ids=["every_slot_filled", "empty_slots"])
def test_retriever_cand_valid_divergence_is_pinned(monkeypatch, top_p):
    """The port's CorpusRetriever answers as cone_tpu's at proposal_top_k 5
    and 40, to the spans and scores limits. (The name is kept from when the
    two retrievers answered apart, ROADMAP Queue 3 "Repaired".) The
    within-window NMS keeps at most proposal_top_k cells a window; a slot it
    cannot fill holds a cell it suppressed, marked invalid (cand_valid), in
    both packages. cone_tpu's retriever ignores the mark, so those cells
    enter the min-max fusion and the per-video NMS as candidates, and the
    port's does the same. At top_p 5 every slot is filled; at 40 (a 32-clip
    map keeps fewer survivors) some slots are empty, so the case exercises
    the mark."""
    from cone_tpu_torch.eval import tan_pipeline

    cfg = _cfg()
    cfg = cfg.replace(tan=dataclasses.replace(cfg.tan, proposal_top_k=top_p))
    jcfg = JConeConfig.from_json(cfg.to_json())
    sd = random_reference_tan_state_dict(cfg.tan, seed=3)
    model = ConeTanModel(cfg.tan, device="cpu")
    model.load_state_dict(load_reference_tan_state_dict(sd))
    ds = make_synthetic_dataset(cfg.data, n_videos=3, queries_per_video=4,
                                ctx_l_range=(90, 180), dim=DIM, signal=3.0, seed=9)
    queries = [ds.query_features(ex.query_id) for ex in ds.examples[:2]]
    nms, slots = tan_pipeline.within_window_nms, []

    def counted(*a):
        spans, prob, valid = nms(*a)
        slots.append((int(valid.sum()), valid.numel()))
        return spans, prob, valid

    monkeypatch.setattr(tan_pipeline, "within_window_nms", counted)
    t = CorpusRetriever(model, cfg, device="cpu")
    j = JCorpusRetriever(JConeTanModel(jcfg.tan), tan_params_to_jax(sd, cfg.tan), jcfg)
    for cid in ds.video_ids:
        t.add_video(cid, ds.video_features(cid)[0])
        j.add_video(cid, ds.video_features(cid)[0])
    got = t.search_batch([q[0] for q in queries], np.stack([q[1] for q in queries]))
    want = j.search_batch([q[0] for q in queries], np.stack([q[1] for q in queries]))
    empty = sum(n - v for v, n in slots)
    assert (empty == 0) if top_p == 5 else (empty > 0)
    for g_rows, w_rows in zip(got, want):
        assert g_rows and [m["video_id"] for m in g_rows] == [m["video_id"] for m in w_rows]
        np.testing.assert_allclose([m["span"] for m in g_rows], [m["span"] for m in w_rows],
                                   atol=SPAN_ATOL)
        np.testing.assert_allclose([[m["prop"], m["match"], m["fused"]] for m in g_rows],
                                   [[m["prop"], m["match"], m["fused"]] for m in w_rows],
                                   atol=SCORE_ATOL)


def test_moment_service_serves_a_tan_model(setups):
    """/search, /search_batch and /localize of the HTTP service over a TAN
    model answer as the retriever and the localizer do (which the tests
    above hold against cone_tpu's)."""
    from cone_tpu_torch.serve.server import MomentService

    s = setups[False]
    svc = MomentService(s.model, s.cfg, device="cpu")
    direct = CorpusRetriever(s.model, s.cfg, device="cpu")
    for cid in s.ds.video_ids:
        feats = s.ds.video_features(cid)[0]
        status, body = svc.handle("POST", "/add_video", dict(clip_id=cid, features=feats.tolist()))
        assert status == 200 and body["clips"] == len(feats)
        direct.add_video(cid, feats)
    queries = [dict(zip(("tok", "cls"), s.ds.query_features(ex.query_id)), text=ex.query)
               for ex in s.ds.examples[:3]]

    def as_json(q, **kw):
        return dict(token_features=q["tok"].tolist(), cls_feature=q["cls"].tolist(),
                    query=q["text"], **kw)

    def jsonable(x):
        return json.loads(json.dumps(x))

    q = queries[0]
    status, body = svc.handle("POST", "/search", as_json(q))
    assert status == 200 and body["moments"]
    assert jsonable(body["moments"]) == jsonable(direct.search(q["tok"], q["cls"],
                                                               query=q["text"]))
    status, body = svc.handle("POST", "/search_batch",
                              dict(queries=[as_json(x) for x in queries]))
    assert status == 200 and [jsonable(r["moments"]) for r in body["results"]] == [
        jsonable(direct.search(x["tok"], x["cls"], query=x["text"])) for x in queries]
    feats = s.ds.video_features(s.ds.examples[0].clip_id)[0]
    status, body = svc.handle("POST", "/localize",
                              dict(video_features=feats.tolist(), top_k=3, **as_json(q)))
    loc = OnlineLocalizer(s.model, s.cfg, device="cpu")
    assert status == 200 and body["moments"] == loc.localize(feats, q["tok"], q["cls"], top_k=3)


def test_pre_nms_pool_shortfall_is_shared_with_cone_tpu():
    """The within-window NMS runs over the 128 best cells of a map
    (PRE_NMS_POOL, cone_tpu's pre_nms_pool); the original 2D-TAN scans the
    whole map until it holds proposal_top_k survivors. At the tan_ego4d
    geometry (a 64x64 map of 1 104 valid cells, threshold 0.3, top 10), on
    maps whose mass clusters around one cell, the pool keeps fewer than 10
    moments where the full scan keeps 10: a divergence from the reference
    that the port shares with cone_tpu (ROADMAP Queue 3), pinned here, not
    fixed. What the pool keeps is the head of the full scan's list, and the
    port's kept cells equal cone_tpu's."""
    from cone_tpu.ops.nms import temporal_nms_device as j_nms
    from cone_tpu_torch.config import tan_ego4d_config
    from cone_tpu_torch.eval.tan_pipeline import (
        NMS_THRESH_WITHIN_WINDOW, PRE_NMS_POOL, within_window_nms,
    )
    from cone_tpu_torch.models.tan import sparse_map_mask
    from tests.test_tan_nms_reference import ref_2dtan_nms

    tan = tan_ego4d_config().tan
    nc, top_p = tan.num_clips, tan.proposal_top_k
    mask = sparse_map_mask(nc, tan.num_scale_layers)
    assert int(mask.sum()) == 1104 and (nc, top_p, NMS_THRESH_WITHIN_WINDOW) == (64, 10, 0.3)
    rng = np.random.default_rng(0)
    s, e = np.meshgrid(np.arange(nc), np.arange(nc), indexing="ij")
    valid = np.flatnonzero(mask.ravel())
    maps = []
    for _ in range(64):   # a Gaussian around one planted cell, plus noise of 1e-3
        c = valid[rng.integers(len(valid))]
        width = rng.uniform(2.0, 8.0)
        m = np.exp(-((s - c // nc) ** 2 + (e - c % nc) ** 2) / (2 * width ** 2))
        maps.append(((0.9 * m + 1e-3 * rng.uniform(size=m.shape)) * mask).ravel())
    prob = np.asarray(maps, np.float32)

    spans, _, kept = within_window_nms(torch.from_numpy(prob), nc, top_p)
    spans, kept = spans.numpy(), kept.numpy()
    # cone_tpu's pool (cone_tpu/eval/tan_pipeline.py:83-101)
    v, ridx = jax.lax.top_k(prob[:, ::-1], PRE_NMS_POOL)
    idx = prob.shape[1] - 1 - np.asarray(ridx)
    j_cells = np.stack([idx // nc, idx % nc + 1], -1).astype(np.float32)
    j_spans, _, j_kept = (np.asarray(x) for x in j_nms(
        j_cells, v, v > 0, NMS_THRESH_WITHIN_WINDOW, top_p, hull_union=False))
    np.testing.assert_array_equal(kept, j_kept)
    np.testing.assert_array_equal(spans[kept], j_spans[j_kept])

    short = 0
    for i, p in enumerate(prob):
        order = np.argsort(p)[::-1]           # the reference's tie order (test.py:275-276)
        order = order[p[order] > 0]
        full = ref_2dtan_nms([[o // nc, o % nc + 1] for o in order], 0.3, top_p)
        assert len(full) == top_p
        n = int(kept[i].sum())
        np.testing.assert_array_equal(spans[i, :n], full[:n])
        short += n < top_p
    print(f"pre-NMS pool {PRE_NMS_POOL}: {short} of {len(prob)} clustered maps keep fewer "
          f"than {top_p}; the full scan keeps {top_p} on all")
    assert short > 0
