"""The port's serving path (cone_tpu_torch/serve: OnlineLocalizer,
CorpusRetriever, MomentService and its HTTP server) against cone_tpu's on
the same corpus and the same weights, on the CPU.

Weights are carried with convert.params_from_jax; videos and queries come
from numpy with a seed. Limits: the same video ids and window choice, spans
atol 1e-3, scores atol 2e-3 (tests/test_e2e_inference_parity.py:110-113).
"""

import base64
import dataclasses
import json
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from cone_tpu.config import ConeConfig as JConeConfig
from cone_tpu.models.init import build_model_and_params
from cone_tpu.serve.corpus import CorpusRetriever as JCorpusRetriever
from cone_tpu.serve.localizer import OnlineLocalizer as JOnlineLocalizer
from cone_tpu_torch.config import ConeConfig, DataConfig, EvalConfig, ModelConfig
from cone_tpu_torch.convert import params_from_jax
from cone_tpu_torch.models.cone import ConeModel
from cone_tpu_torch.serve.corpus import CorpusRetriever
from cone_tpu_torch.serve.localizer import OnlineLocalizer
from cone_tpu_torch.serve.server import MomentService, make_server

DIM = 32
SPAN_ATOL, SCORE_ATOL = 1e-3, 2e-3


def _cfg(**eval_kw):
    return ConeConfig(
        model=ModelConfig(hidden_dim=32, nheads=4, enc_layers=1, dec_layers=1,
                          dim_feedforward=64, t_feat_dim=DIM, v_motion_feat_dim=DIM,
                          v_appear_feat_dim=DIM, max_q_l=8, max_v_l=16),
        data=DataConfig(max_v_l=16, max_q_l=8, clip_length=1.0, topk_window=4,
                        max_ctx_l=128),
        eval=EvalConfig(nms_thd=0.5, max_after_nms=5, **eval_kw))


@pytest.fixture(scope="module")
def weights():
    """(jax model, jax params, port model) on one set of weights."""
    cfg = _cfg()
    jcfg = JConeConfig.from_json(cfg.to_json())
    jmodel, params = build_model_and_params(jcfg.model, seed=0)
    params = jax.tree_util.tree_map(np.asarray, params)
    model = ConeModel(cfg.model, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg.model))
    return jmodel, params, model.eval()


@pytest.fixture(scope="module")
def corpus():
    """5 videos of 40-100 clips and 6 queries, each planted in one video."""
    rng = np.random.default_rng(11)
    videos = {f"vid{i}": rng.normal(size=(int(rng.integers(40, 100)), DIM)).astype(np.float32)
              for i in range(5)}
    queries = []
    for qi in range(6):
        cls = rng.normal(size=DIM).astype(np.float32)
        cls /= np.linalg.norm(cls)
        vid = f"vid{qi % 5}"
        st = int(rng.integers(0, len(videos[vid]) - 12))
        videos[vid][st : st + 8] += 3.0 * cls
        tok = rng.normal(size=(int(rng.integers(3, 12)), DIM)).astype(np.float32)
        queries.append(dict(tok=tok, cls=cls, video=vid, text=f"query {qi}"))
    return videos, queries


def _pair(weights, videos, motion=None, **eval_kw):
    """(port retriever, cone_tpu retriever) over the same library."""
    jmodel, params, model = weights
    cfg = _cfg(**eval_kw)
    t = CorpusRetriever(model, cfg, device="cpu")
    j = JCorpusRetriever(jmodel, params, JConeConfig.from_json(cfg.to_json()))
    for cid, feats in videos.items():
        mo = None if motion is None else motion[cid]
        t.add_video(cid, feats, motion_feats=mo)
        j.add_video(cid, feats, motion_feats=mo)
    return t, j


def _assert_moments_close(got, want):
    assert [m["video_id"] for m in got] == [m["video_id"] for m in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["span"], w["span"], atol=SPAN_ATOL)
        np.testing.assert_allclose([g["prop"], g["match"], g["fused"]],
                                   [w["prop"], w["match"], w["fused"]], atol=SCORE_ATOL)
        assert g["query"] == w["query"]


@pytest.fixture(scope="module")
def pair(weights, corpus):
    return _pair(weights, corpus[0])


# ------------------------------------------------------------- localizer

def test_localizer_matches_cone_tpu(weights, corpus):
    jmodel, params, model = weights
    cfg = _cfg()
    t = OnlineLocalizer(model, cfg, device="cpu")
    j = JOnlineLocalizer(jmodel, params, JConeConfig.from_json(cfg.to_json()))
    videos, queries = corpus
    for q in queries[:3]:
        got = t.localize(videos[q["video"]], q["tok"], q["cls"], query=q["text"])
        want = j.localize(videos[q["video"]], q["tok"], q["cls"], query=q["text"])
        assert 1 <= len(got) == len(want) <= cfg.eval.max_after_nms
        got, want = np.asarray(got), np.asarray(want)
        np.testing.assert_allclose(got[:, :2], want[:, :2], atol=SPAN_ATOL)
        np.testing.assert_allclose(got[:, 2:], want[:, 2:], atol=SCORE_ATOL)
    assert len(t.localize(videos["vid0"], q["tok"], q["cls"], top_k=2)) == 2


def test_localizer_truncates_long_queries_and_refuses_long_videos(weights, corpus):
    _, _, model = weights
    t = OnlineLocalizer(model, _cfg(), device="cpu")
    videos, queries = corpus
    q = queries[0]
    long_tok = np.concatenate([q["tok"]] * 4)[:20]
    assert len(long_tok) > 8
    assert (t.localize(videos["vid0"], long_tok, q["cls"])
            == t.localize(videos["vid0"], long_tok[:8], q["cls"]))
    with pytest.raises(AssertionError, match="max_ctx_l"):
        t.localize(np.zeros((129, DIM), np.float32), q["tok"], q["cls"])


# ------------------------------------------------------------- retriever

def test_rank_videos_matches_cone_tpu(pair, corpus):
    t, j = pair
    for q in corpus[1]:
        got, want = t.rank_videos(q["cls"]), j.rank_videos(q["cls"])
        assert [c for c, _ in got] == [c for c, _ in want]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want], atol=1e-5)
        assert got[0][0] == q["video"]  # the planted video ranks first


def test_search_matches_cone_tpu(pair, corpus):
    t, j = pair
    for q in corpus[1]:
        got = t.search(q["tok"], q["cls"], query=q["text"])
        want = j.search(q["tok"], q["cls"], query=q["text"])
        assert got and len(got) == len(want)
        _assert_moments_close(got, want)
        assert [m["fused"] for m in got] == sorted((m["fused"] for m in got), reverse=True)
        assert all(m["span"][1] >= m["span"][0] for m in got)


@pytest.mark.parametrize("kw", [dict(search_windows=9, top_moments=3),
                                dict(search_windows=2, top_moments=10),
                                dict(adaptive_margin=0.05),
                                dict(adaptive_margin=10.0)])
def test_search_options_match_cone_tpu(pair, corpus, kw):
    t, j = pair
    q = corpus[1][1]
    got, want = t.search(q["tok"], q["cls"], **kw), j.search(q["tok"], q["cls"], **kw)
    assert 1 <= len(got) <= kw.get("top_moments", 10)
    _assert_moments_close(got, want)


def test_adaptive_margin_shrinks_the_candidate_set(pair, corpus):
    t, _ = pair
    q = corpus[1][2]
    tight = t.search(q["tok"], q["cls"], adaptive_margin=0.0, top_moments=50)
    loose = t.search(q["tok"], q["cls"], adaptive_margin=10.0, top_moments=50)
    assert loose == t.search(q["tok"], q["cls"], top_moments=50)
    assert 1 <= len(tight) <= len(loose)
    assert {m["video_id"] for m in tight} <= {q["video"]}


def test_search_batch_equals_singles_and_cone_tpu(pair, corpus):
    t, j = pair
    qs = corpus[1]
    args = ([q["tok"] for q in qs], np.stack([q["cls"] for q in qs]))
    texts = [q["text"] for q in qs]
    batch = t.search_batch(*args, queries=texts)
    assert batch == [t.search(q["tok"], q["cls"], query=q["text"]) for q in qs]
    for got, want in zip(batch, j.search_batch(*args, queries=texts)):
        _assert_moments_close(got, want)


def test_append_video_equals_add_of_the_concatenation(weights, corpus):
    _, _, model = weights
    videos, queries = corpus
    q = queries[0]
    full = videos[q["video"]]
    grown = CorpusRetriever(model, _cfg(), device="cpu")
    grown.add_video("live", full[:30])
    grown.add_video("other", videos["vid1"])
    pre = grown.search(q["tok"], q["cls"])  # stacks the pre-append corpus
    assert all(m["span"][1] <= 30.0 + 1e-6 for m in pre if m["video_id"] == "live")
    assert grown.append_video("live", full[30:]) == len(full)
    whole = CorpusRetriever(model, _cfg(), device="cpu")
    whole.add_video("live", full)
    whole.add_video("other", videos["vid1"])
    np.testing.assert_array_equal(grown.pipe.ds.video_features("live")[0],
                                  whole.pipe.ds.video_features("live")[0])
    assert grown.search(q["tok"], q["cls"]) == whole.search(q["tok"], q["cls"])
    with pytest.raises(AssertionError, match="max_ctx_l"):
        grown.append_video("live", np.zeros((128, DIM), np.float32))


def test_remove_video(weights, corpus):
    t, j = _pair(weights, corpus[0])
    q = corpus[1][0]
    assert any(m["video_id"] == q["video"] for m in t.search(q["tok"], q["cls"]))
    t.remove_video(q["video"])
    j.remove_video(q["video"])
    got = t.search(q["tok"], q["cls"])
    assert got and all(m["video_id"] != q["video"] for m in got)
    _assert_moments_close(got, j.search(q["tok"], q["cls"]))
    assert q["video"] not in t.clip_ids and t.pipe.ds.cached_video(q["video"]) is None
    with pytest.raises(ValueError):
        t.remove_video("never-added")


def test_empty_library_is_an_assertion(weights, corpus):
    _, _, model = weights
    q = corpus[1][0]
    with pytest.raises(AssertionError, match="add_video"):
        CorpusRetriever(model, _cfg(), device="cpu").search(q["tok"], q["cls"])


def test_save_and_load_corpus_bit_exact(weights, corpus, tmp_path):
    jmodel, params, model = weights
    rng = np.random.default_rng(5)
    motion = {"vid1": rng.normal(size=corpus[0]["vid1"].shape).astype(np.float32)}
    t = CorpusRetriever(model, _cfg(), device="cpu")
    for cid, feats in corpus[0].items():
        t.add_video(cid, feats, motion_feats=motion.get(cid))
    qs = corpus[1]
    before = [t.search(q["tok"], q["cls"]) for q in qs]
    assert t.save_corpus(str(tmp_path / "lib")) == 5
    fresh = CorpusRetriever(model, _cfg(), device="cpu")
    assert fresh.load_corpus(str(tmp_path / "lib")) == 5
    assert sorted(fresh.clip_ids) == sorted(t.clip_ids)
    for cid in t.clip_ids:
        a, b = t.pipe.ds.video_features(cid), fresh.pipe.ds.video_features(cid)
        assert a[0].tobytes() == b[0].tobytes() and a[1].tobytes() == b[1].tobytes()
        assert (b[1] is b[0]) == (cid != "vid1")  # only vid1 is dual-stream
    assert [fresh.search(q["tok"], q["cls"]) for q in qs] == before
    # the stores are the JAX package's format: its retriever loads them too
    j = JCorpusRetriever(jmodel, params, JConeConfig.from_json(_cfg().to_json()))
    assert j.load_corpus(str(tmp_path / "lib")) == 5
    _assert_moments_close(before[0], j.search(qs[0]["tok"], qs[0]["cls"]))


def test_dual_stream_videos_match_cone_tpu(weights, corpus):
    rng = np.random.default_rng(6)
    videos, queries = corpus
    motion = {c: rng.normal(size=v.shape).astype(np.float32) for c, v in videos.items()}
    t, j = _pair(weights, videos, motion=motion)
    single, _ = _pair(weights, videos)
    q = queries[3]
    got = t.search(q["tok"], q["cls"])
    _assert_moments_close(got, j.search(q["tok"], q["cls"]))
    assert got != single.search(q["tok"], q["cls"])  # the motion stream is used
    with pytest.raises(AssertionError, match="dual-stream"):
        t.append_video("vid0", videos["vid0"][:4])


@pytest.mark.parametrize("kw", [dict(corpus_dtype="int8"), dict(corpus_dtype="bfloat16"),
                                dict(ctx_buckets=(64, 96))],
                         ids=["int8", "bfloat16", "ctx_buckets"])
def test_encoded_and_bucketed_corpus_matches_cone_tpu(weights, corpus, kw):
    t, j = _pair(weights, corpus[0], **kw)
    qs = corpus[1][:3]
    args = ([q["tok"] for q in qs], np.stack([q["cls"] for q in qs]))
    for got, want in zip(t.search_batch(*args), j.search_batch(*args)):
        _assert_moments_close(got, want)
    if "ctx_buckets" in kw:
        assert len(t._stacked) >= 2 and set(t._stacked) <= {64, 96, 128}
    assert not len(t.pipe.resident) and not t.pipe._stack_cache  # the stack holds the corpus once


def test_dataset_backed_retriever(weights):
    from cone_tpu_torch.data import make_synthetic_dataset

    _, _, model = weights
    cfg = _cfg()
    ds = make_synthetic_dataset(cfg.data, n_videos=3, queries_per_video=2,
                                ctx_l_range=(40, 90), dim=DIM, signal=3.0, seed=2)
    t = CorpusRetriever(model, cfg, dataset=ds, device="cpu")
    assert t.clip_ids == sorted(ds.video_ids)
    hits = 0
    for ex in ds.examples:
        tok, cls = ds.query_features(ex.query_id)
        hits += t.rank_videos(cls)[0][0] == ex.clip_id
    assert hits >= len(ds.examples) - 1


# --------------------------------------------------------------- service

def _b64(a):
    return base64.b64encode(np.ascontiguousarray(a, "<f4").tobytes()).decode()


def _json_query(q, **kw):
    return dict(token_features=q["tok"].tolist(), cls_feature=q["cls"].tolist(),
                query=q["text"], **kw)


def _b64_query(q, **kw):
    return dict(token_features_b64=_b64(q["tok"]), token_shape=list(q["tok"].shape),
                cls_feature_b64=_b64(q["cls"]), query=q["text"], **kw)


def _jsonable(moments):
    return json.loads(json.dumps(moments))


def test_service_handles_every_endpoint(weights, corpus, tmp_path):
    _, _, model = weights
    videos, queries = corpus
    svc = MomentService(model, _cfg(), device="cpu")
    direct = CorpusRetriever(model, _cfg(), device="cpu")
    assert svc.handle("GET", "/healthz", None) == (
        200, {"ok": True, "backend": "cpu", "videos": 0})
    status, body = svc.handle("POST", "/search", _json_query(queries[0]))
    assert status == 400 and "add_video" in body["error"]  # empty library

    for cid, feats in videos.items():
        if cid == "vid0":
            continue
        status, body = svc.handle("POST", "/add_video",
                                  dict(clip_id=cid, features=feats.tolist()))
        assert (status, body) == (200, {"ok": True, "clip_id": cid, "clips": len(feats)})
        direct.add_video(cid, feats)
    v0 = videos["vid0"]
    svc.handle("POST", "/add_video", dict(clip_id="vid0", features=v0[:20].tolist()))
    status, body = svc.handle("POST", "/append_video",
                              dict(clip_id="vid0", features=v0[20:].tolist()))
    assert (status, body) == (200, {"ok": True, "clip_id": "vid0", "clips": len(v0)})
    direct.add_video("vid0", v0)
    all_clips = sum(len(v) for v in videos.values())
    assert svc.handle("GET", "/stats", None)[1]["total_clips"] == all_clips

    q = queries[0]
    want = _jsonable(direct.search(q["tok"], q["cls"], query=q["text"]))
    status, body = svc.handle("POST", "/search", _json_query(q))
    assert status == 200 and body["moments"] == want
    status, body = svc.handle("POST", "/search", _b64_query(q))
    assert status == 200 and _jsonable(body["moments"]) == want
    status, body = svc.handle("POST", "/search", _json_query(q, top_moments=2,
                                                             search_windows=6))
    assert status == 200 and _jsonable(body["moments"]) == _jsonable(
        direct.search(q["tok"], q["cls"], query=q["text"], top_moments=2, search_windows=6))

    status, body = svc.handle("POST", "/search_batch", dict(
        queries=[_json_query(x) if i % 2 else _b64_query(x)
                 for i, x in enumerate(queries)]))
    assert status == 200 and len(body["results"]) == len(queries)
    for x, res in zip(queries, body["results"]):
        assert _jsonable(res["moments"]) == _jsonable(
            direct.search(x["tok"], x["cls"], query=x["text"]))

    loc = OnlineLocalizer(model, _cfg(), device="cpu")
    status, body = svc.handle("POST", "/localize", dict(
        video_features=v0.tolist(), top_k=3, **_json_query(q)))
    assert status == 200 and body["moments"] == loc.localize(v0, q["tok"], q["cls"], top_k=3)

    status, body = svc.handle("POST", "/save_corpus", dict(dir=str(tmp_path / "lib")))
    assert (status, body["videos"]) == (200, 5)
    status, body = svc.handle("POST", "/remove_video", dict(clip_id="vid0"))
    assert (status, body) == (200, {"ok": True, "clip_id": "vid0", "videos": 4})
    assert svc.handle("GET", "/stats", None)[1]["total_clips"] == all_clips - len(v0)
    status, body = svc.handle("POST", "/remove_video", dict(clip_id="vid0"))
    assert status == 400
    status, body = svc.handle("POST", "/load_corpus", dict(dir=str(tmp_path / "lib")))
    assert (status, body) == (200, {"ok": True, "videos_loaded": 5, "videos": 5})
    status, body = svc.handle("POST", "/search", _json_query(q))
    assert status == 200 and body["moments"] == want  # save + load: the same answers

    status, body = svc.handle("GET", "/stats", None)
    assert status == 200 and body["videos"] == 5
    assert body["total_clips"] == all_clips
    assert body["requests"]["search"] == 5 and body["requests"]["search_batch"] == 1
    assert body["requests"]["localize"] == 1 and "dynamic_batching" not in body

    assert svc.handle("GET", "/nowhere", None)[0] == 404
    assert svc.handle("POST", "/search", {"query": "text only"})[0] == 400  # no encoder
    assert svc.handle("POST", "/load_corpus", dict(dir=str(tmp_path / "none")))[0] == 400
    bad = dict(_b64_query(q), token_shape=[3, 5])
    assert svc.handle("POST", "/search", bad)[0] == 400


def test_service_text_encoder(weights, corpus):
    _, _, model = weights
    videos, queries = corpus
    q = queries[1]
    svc = MomentService(model, _cfg(), text_encoder=lambda text: (q["tok"], q["cls"]),
                        device="cpu")
    svc.retriever.add_video("vid1", videos["vid1"])
    status, body = svc.handle("POST", "/search", {"query": q["text"]})
    assert status == 200 and body["moments"] == _jsonable(
        svc.retriever.search(q["tok"], q["cls"], query=q["text"]))
    with pytest.raises(AssertionError, match="text encoder"):
        MomentService(model, _cfg(), device="cpu",
                      text_encoder=lambda text: (q["tok"][:, :7], q["cls"]))


def test_http_round_trip_with_micro_batching(weights, corpus):
    _, _, model = weights
    videos, queries = corpus
    svc = MomentService(model, _cfg(), batch_window_ms=150.0, max_batch=8, device="cpu")
    srv = make_server(svc, host="127.0.0.1", port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"

    def call(path, payload=None):
        req = urllib.request.Request(
            base + path, data=None if payload is None else json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    try:
        assert call("/healthz") == {"ok": True, "backend": "cpu", "videos": 0}
        for cid, feats in videos.items():
            assert call("/add_video", dict(clip_id=cid, features=feats.tolist()))["ok"]
        # concurrent single-query requests share one sweep
        results, errors = [None] * 4, []

        def worker(i):
            try:
                results[i] = call("/search", _b64_query(queries[i]))["moments"]
            except Exception as e:  # noqa: BLE001 (reported below)
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert not errors, errors
        for i in range(4):
            q = queries[i]
            assert results[i] == _jsonable(
                svc.retriever.search(q["tok"], q["cls"], query=q["text"]))
        stats = call("/stats")
        assert stats["dynamic_batching"]["batched_queries"] == 4
        assert 1 <= stats["dynamic_batching"]["batches"] <= 4
        try:
            call("/search", {"query": "no features"})
            raise AssertionError("expected HTTP 400")
        except urllib.error.HTTPError as e:
            assert e.code == 400
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_serving_entry_points_default_to_the_card(weights):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    _, _, model = weights
    for make in (lambda: OnlineLocalizer(model, _cfg()),
                 lambda: CorpusRetriever(model, _cfg()),
                 lambda: MomentService(model, _cfg())):
        with pytest.raises(RuntimeError, match="cuda"):
            make()
