"""The port's feature extraction (cone_tpu_torch/extract/) against
cone_tpu's (cone_tpu/extract/) on the same weights and inputs, on the CPU.

Each pair writes its .cfs stores from the same query jsonl or the same
decoded frames (decode injected at extract/video.decode_frames: the tests
need no ffmpeg), and the stores must hold the same keys with the
same shapes and values: 3e-5 for CLIP (tests/test_clip_parity.py's
limit), 1e-4 for RoBERTa and DistilBERT (tests/test_text_flax_engines.py),
2e-4 for EgoVLP (the golden fixture's). The engines pair as
tower <-> flax and hf <-> torch. Tokenizer: tests/clip_testing's
FakeClipTokenizer; models: tiny seeded transformers configs.
"""

import os
import subprocess

import numpy as np
import pytest
import torch
import transformers

import cone_tpu.extract.egovlp_video as jxe
import cone_tpu.extract.video as jxv
from cone_tpu.data.store import PackedArrayStore as JStore
from cone_tpu.extract import text as jtext
from cone_tpu.models.egovlp import EgoVlpConfig as JEgoVlpConfig
from cone_tpu_torch.data.store import PackedArrayStore
from cone_tpu_torch.extract import egovlp_video, text, video
from cone_tpu_torch.models.clip import ClipVisionTower, as_vision_tower
from cone_tpu_torch.models.egovlp import EgoVlpConfig
from cone_tpu_torch.utils.io import save_jsonl
from tests.clip_testing import FakeClipTokenizer

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "egovlp_tower.npz")
QUERIES = ["wash the pepper", "open door", "a much longer query about finding the red "
           "toolbox in the garage shelf"]
ENGINES = [("tower", "flax"), ("hf", "torch")]


@pytest.fixture(scope="module")
def queries(tmp_path_factory):
    path = tmp_path_factory.mktemp("q") / "queries.jsonl"
    save_jsonl([dict(query_id=f"q{i}", query=q) for i, q in enumerate(QUERIES)], str(path))
    return str(path)


@pytest.fixture(scope="module")
def hf_clip():
    vcfg = transformers.CLIPVisionConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=2,
        image_size=16, patch_size=8, projection_dim=24, hidden_act="quick_gelu",
        attn_implementation="eager")
    tcfg = transformers.CLIPTextConfig(
        vocab_size=99, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=2, max_position_embeddings=12, projection_dim=24,
        hidden_act="quick_gelu", eos_token_id=98, attn_implementation="eager")
    torch.manual_seed(0)
    return (transformers.CLIPVisionModelWithProjection(vcfg).eval(),
            transformers.CLIPTextModelWithProjection(tcfg).eval(),
            transformers.CLIPImageProcessor(size={"shortest_edge": 16},
                                            crop_size={"height": 16, "width": 16}))


def _same_stores(got, want, keys, atol):
    a, b = PackedArrayStore(got), JStore(want)
    assert set(a.keys()) == set(b.keys()) == set(keys)
    for k in keys:
        assert a.get(k).shape == b.get(k).shape, k
        np.testing.assert_allclose(a.get(k), b.get(k), atol=atol, err_msg=k)


def _same_text_stores(got_dir, want_dir, atol):
    for store in ("tokens.cfs", "cls.cfs"):
        _same_stores(str(got_dir / store), str(want_dir / store), ["q0", "q1", "q2"], atol)


@pytest.mark.parametrize("engine,j_engine", ENGINES)
def test_clip_text_matches_cone_tpu(engine, j_engine, hf_clip, queries, tmp_path):
    _, model, _ = hf_clip
    tok = FakeClipTokenizer()
    text.extract_clip_text(queries, str(tmp_path / "port"), batch_size=2, device="cpu",
                           engine=engine, _model=model, _tokenizer=tok)
    jtext.extract_clip_text(queries, str(tmp_path / "jax"), batch_size=2, engine=j_engine,
                            _model=model, _tokenizer=tok)
    _same_text_stores(tmp_path / "port", tmp_path / "jax", 3e-5)
    tokens = PackedArrayStore(str(tmp_path / "port" / "tokens.cfs"))
    assert tokens.get("q1").shape == (2, 32)   # "open door": SOT and EOT stripped


@pytest.mark.parametrize("engine,j_engine", ENGINES)
def test_clip_video_matches_cone_tpu(engine, j_engine, hf_clip, tmp_path, monkeypatch):
    """Videos of 5 and 3 frames at batch 4: the tower pads the short batches
    with repeated frames."""
    vision, _, proc = hf_clip
    rng = np.random.default_rng(2)
    frames = {"vidA": rng.integers(0, 255, (5, 16, 16, 3), np.uint8),
              "vidB": rng.integers(0, 255, (3, 16, 16, 3), np.uint8)}
    decode = lambda path, fps, size=224: frames[path]   # noqa: E731
    monkeypatch.setattr(video, "decode_frames", decode)
    monkeypatch.setattr(jxv, "decode_frames", decode)
    videos = {"vidA": "vidA", "vidB": "vidB"}
    video.extract_clip_video(videos, str(tmp_path / "port.cfs"), batch_size=4, device="cpu",
                             engine=engine, _model=vision, _processor=proc)
    jxv.extract_clip_video(videos, str(tmp_path / "jax.cfs"), batch_size=4, engine=j_engine,
                           _model=vision, _processor=proc)
    _same_stores(str(tmp_path / "port.cfs"), str(tmp_path / "jax.cfs"), videos, 3e-5)
    assert PackedArrayStore(str(tmp_path / "port.cfs")).get("vidA").shape == (5, 24)


def test_clip_tower_engine_takes_the_port_module(hf_clip, tmp_path, monkeypatch):
    """A ClipVisionTower passed in runs as it is under the tower engine;
    the hf engine refuses it, and an unknown engine is refused."""
    vision, _, proc = hf_clip
    frames = np.random.default_rng(3).integers(0, 255, (6, 16, 16, 3), np.uint8)
    monkeypatch.setattr(video, "decode_frames", lambda path, fps, size=224: frames)
    tower = as_vision_tower(vision, "cpu")
    assert isinstance(tower, ClipVisionTower)
    for model, out in ((tower, "a.cfs"), (vision, "b.cfs")):
        video.extract_clip_video({"v": "v"}, str(tmp_path / out), batch_size=4, device="cpu",
                                 _model=model, _processor=proc)
    _same_stores(str(tmp_path / "a.cfs"), str(tmp_path / "b.cfs"), ["v"], 0.0)
    with pytest.raises(ValueError, match="transformers model"):
        video.extract_clip_video({"v": "v"}, str(tmp_path / "c.cfs"), device="cpu",
                                 engine="hf", _model=tower, _processor=proc)
    with pytest.raises(ValueError, match="engine 'flax'"):
        video.extract_clip_video({"v": "v"}, str(tmp_path / "c.cfs"), device="cpu",
                                 engine="flax", _model=tower, _processor=proc)


def test_decode_without_a_decoder_raises(tmp_path):
    """No fallback: a missing ffmpeg binary or, where ffmpeg is installed,
    a failed decode raises."""
    with pytest.raises((FileNotFoundError, subprocess.CalledProcessError)):
        video.decode_frames(str(tmp_path / "missing.mp4"), 5.0)


def test_roberta_text_matches_cone_tpu(queries, tmp_path):
    cfg = transformers.RobertaConfig(
        vocab_size=99, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=2, max_position_embeddings=24, pad_token_id=0,
        attn_implementation="eager")
    torch.manual_seed(0)
    model = transformers.RobertaModel(cfg).eval()
    tok = FakeClipTokenizer()
    text.extract_roberta_text(queries, str(tmp_path / "port"), batch_size=2, device="cpu",
                              _model=model, _tokenizer=tok)
    jtext.extract_roberta_text(queries, str(tmp_path / "jax"), batch_size=2, engine="torch",
                               _model=model, _tokenizer=tok)
    _same_text_stores(tmp_path / "port", tmp_path / "jax", 1e-4)


def test_egovlp_text_matches_cone_tpu(queries, tmp_path):
    cfg = transformers.DistilBertConfig(
        vocab_size=99, dim=32, hidden_dim=64, n_layers=2, n_heads=2,
        max_position_embeddings=24, pad_token_id=0, attn_implementation="eager")
    torch.manual_seed(1)
    model = transformers.DistilBertModel(cfg).eval()
    torch.manual_seed(2)
    ckpt = str(tmp_path / "egovlp.pth")
    torch.save({"state_dict": {"module.txt_proj.weight": torch.randn(16, 32),
                               "module.txt_proj.bias": torch.randn(16)}}, ckpt)
    tok = FakeClipTokenizer()
    text.extract_egovlp_text(queries, str(tmp_path / "port"), ckpt, batch_size=2, device="cpu",
                             _model=model, _tokenizer=tok)
    jtext.extract_egovlp_text(queries, str(tmp_path / "jax"), ckpt, batch_size=2,
                              engine="torch", _model=model, _tokenizer=tok)
    _same_text_stores(tmp_path / "port", tmp_path / "jax", 1e-4)
    assert PackedArrayStore(str(tmp_path / "port" / "cls.cfs")).get("q0").shape == (1, 16)


def test_egovlp_video_matches_cone_tpu(tmp_path, monkeypatch, capsys):
    """The golden fixture's tower (3 frames a clip) from one checkpoint
    file, clip_batch 4: 7 frames (2 clips, a ragged frame left out), 20
    frames (6 clips: a full batch and a zero-padded one) and a video
    shorter than one clip, skipped with a warning by both."""
    g = dict(np.load(GOLDEN).items())
    img, patch, dim, depth, heads, frames, proj = g["cfg"].tolist()
    kw = dict(img_size=img, patch_size=patch, embed_dim=dim, depth=depth, num_heads=heads,
              num_frames=frames, projection_dim=proj)
    ckpt = str(tmp_path / "egovlp.pth")
    torch.save({"state_dict": {k[3:]: torch.from_numpy(v) for k, v in g.items()
                               if k.startswith("w::")}}, ckpt)
    rng = np.random.default_rng(4)
    decoded = {"a": rng.integers(0, 255, (7, img, img, 3), np.uint8),
               "b": rng.integers(0, 255, (20, img, img, 3), np.uint8),
               "short": rng.integers(0, 255, (2, img, img, 3), np.uint8)}
    decode = lambda path, fps, size=224: decoded[path]   # noqa: E731
    monkeypatch.setattr(video, "decode_frames", decode)
    monkeypatch.setattr(jxe, "decode_frames", decode)
    videos = {k: k for k in decoded}
    egovlp_video.extract_egovlp_video(videos, str(tmp_path / "port.cfs"), ckpt,
                                      frames_per_clip=3, clip_batch=4,
                                      cfg=EgoVlpConfig(**kw), device="cpu")
    jxe.extract_egovlp_video(videos, str(tmp_path / "jax.cfs"), ckpt, frames_per_clip=3,
                             clip_batch=4, cfg=JEgoVlpConfig(**kw))
    assert capsys.readouterr().out.count("short (short): 2 frames < frames_per_clip=3") == 2
    _same_stores(str(tmp_path / "port.cfs"), str(tmp_path / "jax.cfs"), ["a", "b"], 2e-4)
    store = PackedArrayStore(str(tmp_path / "port.cfs"))
    assert store.get("a").shape == (2, proj) and store.get("b").shape == (6, proj)
