"""The port's demo path: MomentPredictor (cone_tpu_torch/serve/predictor.py)
against cone_tpu's with the same weights and the same decoded frames, and
the CLI commands on it (demo, extract-text, extract-video,
serve --text_backend), on the CPU.

Decode is injected at extract/video.decode_frames (the tests need no
ffmpeg); the transformers factories (from_pretrained) are patched to tiny
seeded models and tests/clip_testing's FakeClipTokenizer. Limits: spans
atol 1e-3, scores atol 2e-3 (tests/test_e2e_inference_parity.py:110-113,
PERF.md section 2). The engines pair as tower <-> flax and hf <-> torch.
"""

import dataclasses
import json
import os
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch
import transformers

import cone_tpu.extract.video as jxv
from cone_tpu.config import ConeConfig as JConeConfig
from cone_tpu.models.egovlp import egovlp_state_dict_to_params
from cone_tpu.models.init import build_model_and_params
from cone_tpu.serve.predictor import MomentPredictor as JMomentPredictor
from cone_tpu_torch import cli, convert
from cone_tpu_torch.config import ConeConfig, DataConfig, EvalConfig, ModelConfig
from cone_tpu_torch.data.store import PackedArrayStore
from cone_tpu_torch.extract import egovlp_video, text, video
from cone_tpu_torch.models.cone import ConeModel
from cone_tpu_torch.models.egovlp import EgoVlpConfig
from cone_tpu_torch.serve import server
from cone_tpu_torch.serve.predictor import MomentPredictor
from cone_tpu_torch.utils.io import save_jsonl
from tests.clip_testing import FakeClipTokenizer

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "egovlp_tower.npz")
SPAN_ATOL, SCORE_ATOL = 1e-3, 2e-3
CLIP_DIM = 32          # CLIP hidden and projection: tokens, cls and video
# DistilBERT tokens; EgoVLP projections (cone_tpu's model initialises only
# with equal token and video widths)
EGO_TOKENS = EGO_DIM = 16
QUERY = "find the red cup on the table"


def _cfg(t_dim, v_dim):
    return ConeConfig(
        model=ModelConfig(hidden_dim=32, nheads=4, enc_layers=1, dec_layers=1,
                          dim_feedforward=64, t_feat_dim=t_dim, v_motion_feat_dim=v_dim,
                          v_appear_feat_dim=v_dim, max_q_l=8, max_v_l=16),
        data=DataConfig(dset_name="synthetic", max_v_l=16, max_q_l=8, clip_length=1.0,
                        topk_window=4, max_ctx_l=128),
        eval=EvalConfig(nms_thd=0.5, max_after_nms=5))


def _models(cfg):
    """(jax model, jax params, port model) on one set of weights."""
    jmodel, params = build_model_and_params(JConeConfig.from_json(cfg.to_json()).model, seed=0)
    params = jax.tree_util.tree_map(np.asarray, params)
    model = ConeModel(cfg.model, device="cpu")
    model.load_state_dict(convert.params_from_jax(params, cfg.model))
    return jmodel, params, model.eval()


@pytest.fixture(scope="module")
def clip_models():
    vcfg = transformers.CLIPVisionConfig(
        hidden_size=CLIP_DIM, intermediate_size=64, num_hidden_layers=2, num_attention_heads=2,
        image_size=16, patch_size=8, projection_dim=CLIP_DIM, hidden_act="quick_gelu",
        attn_implementation="eager")
    tcfg = transformers.CLIPTextConfig(
        vocab_size=99, hidden_size=CLIP_DIM, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=2, max_position_embeddings=12, projection_dim=CLIP_DIM,
        hidden_act="quick_gelu", eos_token_id=98, attn_implementation="eager")
    torch.manual_seed(0)
    return {"vision": transformers.CLIPVisionModelWithProjection(vcfg).eval(),
            "text": transformers.CLIPTextModelWithProjection(tcfg).eval(),
            "processor": transformers.CLIPImageProcessor(
                size={"shortest_edge": 16}, crop_size={"height": 16, "width": 16}),
            "tokenizer": FakeClipTokenizer()}


@pytest.fixture(scope="module")
def clip_weights():
    return _models(_cfg(CLIP_DIM, CLIP_DIM))


@pytest.fixture(scope="module")
def egovlp_fixture(tmp_path_factory):
    """The golden EgoVLP tower (3 frames a clip) and a tiny DistilBERT,
    with a checkpoint file holding the tower and a txt_proj."""
    g = dict(np.load(GOLDEN).items())
    img, patch, dim, depth, heads, frames, proj = g["cfg"].tolist()
    cfg = EgoVlpConfig(img_size=img, patch_size=patch, embed_dim=dim, depth=depth,
                       num_heads=heads, num_frames=frames, projection_dim=proj)
    sd = {k[3:]: v for k, v in g.items() if k.startswith("w::")}
    torch.manual_seed(1)
    bert = transformers.DistilBertModel(transformers.DistilBertConfig(
        vocab_size=99, dim=EGO_TOKENS, hidden_dim=64, n_layers=2, n_heads=2,
        max_position_embeddings=24, pad_token_id=0, attn_implementation="eager")).eval()
    ckpt = str(tmp_path_factory.mktemp("ego") / "egovlp.pth")
    torch.manual_seed(2)
    torch.save({"state_dict": {**{k: torch.from_numpy(v) for k, v in sd.items()},
                               "txt_proj.weight": torch.randn(EGO_DIM, EGO_TOKENS),
                               "txt_proj.bias": torch.randn(EGO_DIM)}}, ckpt)
    return cfg, sd, bert, ckpt


def _frames(n, size, seed=7):
    return np.random.default_rng(seed).integers(0, 255, size=(n, size, size, 3), dtype=np.uint8)


def _patch_decode(monkeypatch, frames, calls=None):
    def decode(path, fps, size=224):
        if calls is not None:
            calls.append((path, fps, size))
        return frames
    monkeypatch.setattr(video, "decode_frames", decode)
    monkeypatch.setattr(jxv, "decode_frames", decode)


def _patch_hf(monkeypatch, clip_models=None, bert=None):
    """transformers' factories return the tiny models."""
    def const(obj):
        return staticmethod(lambda *a, **k: obj)
    if clip_models is not None:
        for cls, key in (("CLIPVisionModelWithProjection", "vision"),
                         ("CLIPImageProcessor", "processor"),
                         ("CLIPTextModelWithProjection", "text"),
                         ("CLIPTokenizerFast", "tokenizer")):
            monkeypatch.setattr(getattr(transformers, cls), "from_pretrained",
                                const(clip_models[key]))
    if bert is not None:
        monkeypatch.setattr(transformers.AutoModel, "from_pretrained", const(bert))
        monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                            const(FakeClipTokenizer()))


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and len(got) >= 1
    np.testing.assert_allclose(got[:, :2], want[:, :2], atol=SPAN_ATOL)
    np.testing.assert_allclose(got[:, 2:], want[:, 2:], atol=SCORE_ATOL)


@pytest.mark.parametrize("engine,j_engine", [("tower", "flax"), ("hf", "torch")])
def test_clip_predictor_matches_cone_tpu(engine, j_engine, clip_models, clip_weights,
                                         tmp_path, monkeypatch):
    jmodel, params, model = clip_weights
    cfg = _cfg(CLIP_DIM, CLIP_DIM)
    _patch_decode(monkeypatch, _frames(120, 16))
    pred = MomentPredictor(model, cfg, backend="clip", cache_dir=str(tmp_path / "port"),
                           engine=engine, clip_models=clip_models, device="cpu")
    jpred = JMomentPredictor(jmodel, params, JConeConfig.from_json(cfg.to_json()),
                             backend="clip", cache_dir=str(tmp_path / "jax"),
                             clip_engine=j_engine, clip_models=clip_models)
    vid = str(tmp_path / "vid.mp4")
    _close(pred.localize_moment(vid, QUERY), jpred.localize_moment(vid, QUERY))
    np.testing.assert_allclose(pred.video_features(vid), jpred.video_features(vid), atol=3e-5)
    for a, b in zip(pred.text_features(QUERY), jpred.text_features(QUERY)):
        np.testing.assert_allclose(a, b, atol=3e-5)


def test_egovlp_predictor_matches_cone_tpu(clip_weights, egovlp_fixture, tmp_path,
                                           monkeypatch):
    """backend egovlp: the video tower from a state dict (the port's names)
    against cone_tpu's param tree of the same fixture; text from the
    checkpoint's txt_proj and DistilBERT; frames decoded at fps x 3."""
    ecfg, sd, bert, ckpt = egovlp_fixture
    cfg = _cfg(EGO_TOKENS, EGO_DIM)
    jmodel, params, model = _models(cfg)
    calls = []
    _patch_decode(monkeypatch, _frames(3 * 40 + 2, ecfg.img_size), calls)
    _patch_hf(monkeypatch, bert=bert)
    pred = MomentPredictor(model, cfg, backend="egovlp", cache_dir=str(tmp_path / "port"),
                           egovlp_checkpoint=ckpt, egovlp_cfg=ecfg,
                           egovlp_state_dict=convert.egovlp_state_dict(sd, ecfg),
                           frames_per_clip=3, device="cpu")
    from cone_tpu.models.egovlp import EgoVlpConfig as JEgoVlpConfig

    jcfg = JEgoVlpConfig(**{k: getattr(ecfg, k) for k in ecfg.__dataclass_fields__})
    jpred = JMomentPredictor(jmodel, params, JConeConfig.from_json(cfg.to_json()),
                             backend="egovlp", cache_dir=str(tmp_path / "jax"),
                             egovlp_checkpoint=ckpt, egovlp_cfg=jcfg,
                             egovlp_params=egovlp_state_dict_to_params(sd, depth=ecfg.depth),
                             frames_per_clip=3)
    vid = str(tmp_path / "vid.mp4")
    _close(pred.localize_moment(vid, QUERY), jpred.localize_moment(vid, QUERY))
    assert calls[0] == (vid, 3.0, ecfg.img_size)       # fps x frames_per_clip
    assert pred.video_features(vid).shape == (40, EGO_DIM)
    np.testing.assert_allclose(pred.video_features(vid), jpred.video_features(vid), atol=2e-4)
    tok, cls = pred.text_features(QUERY)
    assert tok.shape == (len(QUERY.split()), EGO_TOKENS) and cls.shape == (EGO_DIM,)


def test_predictor_probes_backbone_dims(clip_weights, clip_models, tmp_path, monkeypatch):
    """A backbone whose dims differ from the model's fails at
    localize_moment with a readable message."""
    _, _, model = clip_weights
    pred = MomentPredictor(model, _cfg(CLIP_DIM, CLIP_DIM), backend="clip",
                           cache_dir=str(tmp_path), clip_models=clip_models, device="cpu")
    monkeypatch.setattr(MomentPredictor, "video_features",
                        lambda self, p: np.zeros((40, 512), np.float32))
    monkeypatch.setattr(MomentPredictor, "text_features",
                        lambda self, q: (np.zeros((6, 512), np.float32),
                                         np.zeros(512, np.float32)))
    with pytest.raises(ValueError, match="backend 'clip' produces 512-d tokens"):
        pred.localize_moment("v.mp4", "where is the cup")
    with pytest.raises(ValueError, match="backend"):
        MomentPredictor(model, _cfg(CLIP_DIM, CLIP_DIM), backend="roberta", device="cpu",
                        cache_dir=str(tmp_path))
    with pytest.raises(ValueError, match="engine"):
        MomentPredictor(model, _cfg(CLIP_DIM, CLIP_DIM), engine="flax", device="cpu",
                        cache_dir=str(tmp_path))


def test_second_call_hits_the_feature_cache(clip_weights, clip_models, tmp_path, monkeypatch):
    """The second query over a video reads the cached features: no decode,
    the same moments; another engine or fps is another cache entry."""
    _, _, model = clip_weights
    cfg = _cfg(CLIP_DIM, CLIP_DIM)
    calls = []
    _patch_decode(monkeypatch, _frames(90, 16), calls)
    pred = MomentPredictor(model, cfg, backend="clip", cache_dir=str(tmp_path),
                           clip_models=clip_models, device="cpu")
    first = pred.localize_moment("v.mp4", QUERY)
    assert pred.localize_moment("v.mp4", QUERY) == first and len(calls) == 1
    assert len(os.listdir(tmp_path)) == 1
    for kw in (dict(engine="hf"), dict(fps=2.0)):
        MomentPredictor(model, cfg, backend="clip", cache_dir=str(tmp_path),
                        clip_models=clip_models, device="cpu", **kw).video_features("v.mp4")
    assert len(calls) == 3 and len(os.listdir(tmp_path)) == 3


# ------------------------------------------------------------------ CLI

@pytest.fixture(scope="module")
def workdirs(tmp_path_factory, clip_weights):
    """Workdirs the port's CLI restores (config.json + model_best.ckpt): the
    CLIP-width model, and one at the EgoVLP widths."""
    root = tmp_path_factory.mktemp("cli")
    out = {}
    for name, cfg, model in (("clip", _cfg(CLIP_DIM, CLIP_DIM), clip_weights[2]),
                             ("egovlp", _cfg(EGO_TOKENS, EGO_DIM), None)):
        wd = root / name
        wd.mkdir()
        cfg.save(str(wd / "config.json"))
        model = model if model is not None else ConeModel(cfg.model, device="cpu")
        torch.save({"model": model.state_dict(), "epoch": 2}, str(wd / "model_best.ckpt"))
        out[name] = str(wd)
    return out


def test_cli_demo(workdirs, clip_models, clip_weights, egovlp_fixture, tmp_path, monkeypatch,
                  capsys):
    """`demo --backend clip` prints the reference's blocks with the
    predictor's moments; `--backend egovlp` runs from a checkpoint file."""
    _patch_decode(monkeypatch, _frames(60, 16))
    _patch_hf(monkeypatch, clip_models=clip_models)
    vid = str(tmp_path / "v.mp4")
    pred = cli.main(["demo", "--workdir", workdirs["clip"], "--video", vid, "--query", QUERY,
                     "--query", "open the door", "--backend", "clip", "--top_k", "3",
                     "--cache_dir", str(tmp_path / "cache"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "restored 'best' (epoch 2)" in out and out.count("text_query: ") == 2
    direct = MomentPredictor(clip_weights[2], _cfg(CLIP_DIM, CLIP_DIM), backend="clip",
                             cache_dir=str(tmp_path / "direct"), clip_models=clip_models,
                             device="cpu").localize_moment(vid, QUERY, top_k=3)
    for i, m in enumerate(direct):
        assert (f"Rank {i + 1}, moment boundary in seconds: {m[0]:.4f} {m[1]:.4f}, "
                f"score: {m[4]:.4f}") in out
    assert isinstance(pred, MomentPredictor) and pred.engine == "tower"

    # the demo builds the default geometry (4 frames a clip): the fixture's at
    # 4 frames, its 3-frame temporal embed zero-filled on load
    ecfg = dataclasses.replace(egovlp_fixture[0], num_frames=4)
    _, _, bert, ckpt = egovlp_fixture
    _patch_decode(monkeypatch, _frames(30, ecfg.img_size))
    _patch_hf(monkeypatch, bert=bert)
    monkeypatch.setattr("cone_tpu_torch.models.egovlp.EgoVlpConfig", lambda: ecfg)
    pred = cli.main(["demo", "--workdir", workdirs["egovlp"], "--video", vid, "--query", QUERY,
                     "--egovlp_checkpoint", ckpt, "--cache_dir", str(tmp_path / "c2"),
                     "--device", "cpu"])
    assert pred.backend == "egovlp" and "Rank 1, moment boundary" in capsys.readouterr().out


@pytest.mark.parametrize("backend", ["clip", "roberta", "egovlp"])
def test_cli_extract_text(backend, clip_models, egovlp_fixture, tmp_path, monkeypatch):
    """`extract-text` writes the stores the extraction function writes."""
    _, _, bert, ckpt = egovlp_fixture
    _patch_hf(monkeypatch, clip_models=clip_models, bert=bert)
    jsonl = str(tmp_path / "q.jsonl")
    save_jsonl([dict(query_id=f"q{i}", query=q) for i, q in
                enumerate(["wash the pepper", QUERY])], jsonl)
    args = ["extract-text", "--input", jsonl, "--out", str(tmp_path / "cli"), "--backend",
            backend, "--device", "cpu"] + (["--checkpoint", ckpt] if backend == "egovlp" else [])
    cli.main(args)
    tok = FakeClipTokenizer()
    if backend == "clip":
        text.extract_clip_text(jsonl, str(tmp_path / "fn"), device="cpu",
                               _model=clip_models["text"], _tokenizer=tok)
    elif backend == "roberta":
        text.extract_roberta_text(jsonl, str(tmp_path / "fn"), device="cpu", _model=bert,
                                  _tokenizer=tok)
    else:
        text.extract_egovlp_text(jsonl, str(tmp_path / "fn"), ckpt, device="cpu", _model=bert,
                                 _tokenizer=tok)
    for store in ("tokens.cfs", "cls.cfs"):
        a, b = (PackedArrayStore(str(tmp_path / d / store)) for d in ("cli", "fn"))
        assert set(a.keys()) == set(b.keys()) == {"q0", "q1"}
        assert all(np.array_equal(a.get(k), b.get(k)) for k in a.keys())
    if backend == "egovlp":
        with pytest.raises(SystemExit, match="--checkpoint"):
            cli.main(args[:-2])


@pytest.mark.parametrize("backend", ["clip", "egovlp"])
def test_cli_extract_video(backend, clip_models, egovlp_fixture, tmp_path, monkeypatch):
    """`extract-video` over clip_id=path and bare-path specs writes the
    store the extraction function writes; a duplicate id is refused."""
    ecfg = dataclasses.replace(egovlp_fixture[0], num_frames=4)   # the default's 4 frames
    ckpt = egovlp_fixture[3]
    size = 16 if backend == "clip" else ecfg.img_size
    _patch_decode(monkeypatch, _frames(12, size))
    _patch_hf(monkeypatch, clip_models=clip_models)
    monkeypatch.setattr(egovlp_video, "EgoVlpConfig", lambda: ecfg)
    out = str(tmp_path / "cli.cfs")
    extra = ["--checkpoint", ckpt, "--batch_size", "2"] if backend == "egovlp" else []
    cli.main(["extract-video", "--videos", "a=x.mp4", "/data/b.mp4", "--out", out,
              "--backend", backend, "--device", "cpu"] + extra)
    store = PackedArrayStore(out)
    assert set(store.keys()) == {"a", "b"}
    if backend == "clip":
        video.extract_clip_video({"a": "x.mp4", "b": "/data/b.mp4"}, str(tmp_path / "fn.cfs"),
                                 device="cpu", _model=clip_models["vision"],
                                 _processor=clip_models["processor"])
        assert store.get("a").shape == (12, CLIP_DIM)
    else:
        egovlp_video.extract_egovlp_video({"a": "x.mp4", "b": "/data/b.mp4"},
                                          str(tmp_path / "fn.cfs"), ckpt, clip_batch=2,
                                          frames_per_clip=4, cfg=ecfg, device="cpu")
        assert store.get("a").shape == (3, EGO_DIM)
    fn = PackedArrayStore(str(tmp_path / "fn.cfs"))
    assert all(np.array_equal(store.get(k), fn.get(k)) for k in ("a", "b"))
    with pytest.raises(SystemExit, match="duplicate clip_id 'a'"):
        cli.main(["extract-video", "--videos", "a=x.mp4", "a=y.mp4", "--out", out,
                  "--device", "cpu"])


@pytest.mark.parametrize("argv,refused", [
    (["extract-video", "--videos", "a.mp4", "--out", "o.cfs", "--backend", "egovlp",
      "--checkpoint", "c.pth", "--engine", "hf"], "--engine"),
    (["extract-video", "--videos", "a.mp4", "--out", "o.cfs", "--backend", "egovlp",
      "--checkpoint", "c.pth", "--model", "m"], "--model"),
    (["extract-video", "--videos", "a.mp4", "--out", "o.cfs", "--checkpoint", "c.pth"],
     "--checkpoint"),
    (["extract-text", "--input", "q.jsonl", "--out", "o", "--backend", "roberta",
      "--engine", "tower"], "--engine"),
    (["extract-text", "--input", "q.jsonl", "--out", "o", "--backend", "egovlp",
      "--checkpoint", "c.pth", "--engine", "hf"], "--engine"),
    (["demo", "--workdir", "w", "--video", "v.mp4", "--query", "q", "--clip_engine", "hf"],
     "--clip_engine"),
    (["demo", "--workdir", "w", "--video", "v.mp4", "--query", "q", "--backend", "clip",
      "--egovlp_checkpoint", "c.pth"], "--egovlp_checkpoint"),
    (["serve", "--workdir", "w", "--text_backend", "egovlp", "--text_engine", "tower"],
     "--text_engine"),
    (["serve", "--workdir", "w", "--text_engine", "hf"], "--text_engine"),
])
def test_cli_refuses_options_the_backend_ignores(argv, refused, tmp_path, monkeypatch):
    """An option that the chosen backend would ignore is refused before
    anything loads (the workdir, checkpoint and videos do not exist)."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match=f"^{refused}: not used with"):
        cli.main(argv + ["--device", "cpu"])


def test_cli_serve_text_backend_over_http(workdirs, clip_models, clip_weights, monkeypatch):
    """`serve --text_backend clip` over HTTP: a raw-text /search answers as
    the same query sent with its features."""
    _patch_hf(monkeypatch, clip_models=clip_models)
    made = []
    real = server.make_server

    def capture(service, host, port):
        srv = real(service, host=host, port=0)
        made.append(srv)
        return srv
    monkeypatch.setattr(server, "make_server", capture)
    thread = threading.Thread(target=cli.main, daemon=True, args=([
        "serve", "--workdir", workdirs["clip"], "--text_backend", "clip", "--device", "cpu"],))
    thread.start()
    try:
        for _ in range(600):
            if made:
                break
            thread.join(0.1)
        assert made, "the server did not start"
        base = f"http://127.0.0.1:{made[0].server_address[1]}"

        def call(path, payload):
            req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                return json.loads(r.read())

        rng = np.random.default_rng(5)
        for i in range(3):
            call("/add_video", dict(clip_id=f"v{i}", features=rng.normal(
                size=(60, CLIP_DIM)).astype(np.float32).tolist()))
        pred = MomentPredictor(clip_weights[2], _cfg(CLIP_DIM, CLIP_DIM), backend="clip",
                               clip_models=clip_models, device="cpu",
                               cache_dir=str(os.path.dirname(workdirs["clip"])))
        tok, cls = pred.text_features(QUERY)
        raw = call("/search", dict(query=QUERY))["moments"]
        feats = call("/search", dict(query=QUERY, token_features=tok.tolist(),
                                     cls_feature=cls.tolist()))["moments"]
        assert raw and raw == feats
    finally:
        if made:
            made[0].shutdown()
        thread.join(timeout=60)
    assert not thread.is_alive()
