"""The port's EgoVLP video tower (cone_tpu_torch/models/egovlp.py) and its
checkpoint loading (cone_tpu_torch/convert.py): against the reference
fixture tests/golden/egovlp_tower.npz (weights under `w::`, frames
(2, 3, 3, 32, 32)) at 2e-4, as tests/test_egovlp_parity.py holds
cone_tpu; against cone_tpu's flax tower through egovlp_params_from_jax at
2e-5; every temporal-embed inflation case (the bilinear one against
F.interpolate(align_corners=True) at 1e-6), the spatial-mismatch raise,
`module.` stripping, and a checkpoint that pickles a
parse_config.ConfigParser object.
"""

import dataclasses
import os
import pickle
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cone_tpu.models import egovlp as jego
from cone_tpu_torch import convert
from cone_tpu_torch.models import egovlp

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "egovlp_tower.npz")


@pytest.fixture(scope="module")
def golden():
    g = dict(np.load(GOLDEN).items())
    img, patch, dim, depth, heads, frames, proj = g["cfg"].tolist()
    cfg = egovlp.EgoVlpConfig(img_size=img, patch_size=patch, embed_dim=dim, depth=depth,
                              num_heads=heads, num_frames=frames, projection_dim=proj)
    sd = {k[3:]: v for k, v in g.items() if k.startswith("w::")}
    return cfg, sd, g


def _tower(cfg, sd):
    tower = egovlp.EgoVlpVideoTower(cfg, device="cpu").eval()
    tower.load_state_dict(sd)
    return tower


def _forward(tower, frames):
    with torch.no_grad():
        return tower(torch.from_numpy(np.ascontiguousarray(frames))).numpy()


def test_golden_tower(golden):
    cfg, sd, g = golden
    out = _forward(_tower(cfg, convert.egovlp_state_dict(sd, cfg)), g["frames"])
    assert out.shape == g["projected"].shape == (2, cfg.projection_dim)
    np.testing.assert_allclose(out, g["projected"], atol=2e-4)
    with torch.no_grad():
        feat = _tower(cfg, convert.egovlp_state_dict(sd, cfg)).video_model(
            torch.from_numpy(g["frames"])).numpy()
    np.testing.assert_allclose(feat, g["cls_feat"], atol=2e-4)


def test_tower_matches_cone_tpu():
    """Random flax params (nonzero CLS and temporal embeds) through
    egovlp_params_from_jax: the port against cone_tpu's tower at 2e-5."""
    cfg = egovlp.EgoVlpConfig(img_size=32, patch_size=16, embed_dim=64, depth=2, num_heads=4,
                              num_frames=3, projection_dim=16)
    jcfg = jego.EgoVlpConfig(**dataclasses.asdict(cfg))
    rng = np.random.default_rng(0)
    frames = rng.normal(size=(2, 3, 32, 32, 3)).astype(np.float32)
    jt = jego.EgoVlpVideoTower(jcfg)
    params = jt.init(jax.random.PRNGKey(0), jnp.asarray(frames))["params"]
    params = jax.tree.map(np.asarray, params)
    vm = params["video_model"]
    vm["cls_token"] = (0.1 * rng.normal(size=vm["cls_token"].shape)).astype(np.float32)
    vm["temporal_embed"] = (0.1 * rng.normal(size=vm["temporal_embed"].shape)).astype(np.float32)
    want = np.asarray(jt.apply({"params": params}, jnp.asarray(frames)))
    got = _forward(_tower(cfg, convert.egovlp_params_from_jax(params)),
                   frames.transpose(0, 1, 4, 2, 3))
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_inflate_truncate_more_frames(golden):
    """More frames in the checkpoint: the extra rows are dropped
    (egovlp/model.py:147-150) and the forward is the fixture's."""
    cfg, sd, g = golden
    key = "video_model.temporal_embed"
    more = dict(sd, **{key: np.concatenate(
        [sd[key], np.full((1, 3, cfg.embed_dim), 7.25, np.float32)], axis=1)})
    got = convert.egovlp_state_dict(more, cfg)
    np.testing.assert_array_equal(got[key].numpy(), sd[key])
    np.testing.assert_allclose(_forward(_tower(cfg, got), g["frames"]), g["projected"],
                               atol=2e-4)


def test_inflate_zeros_fewer_frames(golden):
    """Fewer frames + 'zeros' (the reference default): the loaded rows,
    the rest zero (egovlp/model.py:154-156)."""
    cfg, sd, _ = golden
    key = "video_model.temporal_embed"
    te = convert.egovlp_state_dict(dict(sd, **{key: sd[key][:, :1]}), cfg, "zeros")[key].numpy()
    assert te.shape == (1, cfg.num_frames, cfg.embed_dim)
    np.testing.assert_array_equal(te[:, :1], sd[key][:, :1])
    np.testing.assert_array_equal(te[:, 1:], 0.0)


@pytest.mark.parametrize("f_ckpt,f_new", [(4, 7), (2, 16), (3, 4), (1, 5)])
def test_inflate_bilinear_matches_torch(f_ckpt, f_new):
    """'bilinear' is F.interpolate(mode='bilinear', align_corners=True),
    the op the reference calls (egovlp/model.py:157-166), at 1e-6; and the
    same numbers as cone_tpu's."""
    emb = np.random.default_rng(f_new).standard_normal((1, f_ckpt, 24)).astype(np.float32)
    want = F.interpolate(torch.from_numpy(emb)[None], (f_new, 24), mode="bilinear",
                         align_corners=True)[0].numpy()
    got = egovlp.inflate_temporal_embed(emb, f_new, "bilinear")
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_array_equal(got, jego.inflate_temporal_embed(emb, f_new, "bilinear"))


def test_inflate_interp_and_unknown_raise():
    """'interp' is the reference's mode='nearest' with align_corners=True,
    which torch rejects: the same failure; an unknown fix raises too; an
    equal frame count passes through."""
    emb = np.zeros((1, 2, 8), np.float32)
    with pytest.raises(ValueError, match="interp"):
        egovlp.inflate_temporal_embed(emb, 4, "interp")
    with pytest.raises(NotImplementedError, match="nearest"):
        egovlp.inflate_temporal_embed(emb, 4, "nearest")
    assert egovlp.inflate_temporal_embed(emb, 2, "interp") is emb


def test_spatial_mismatch_raises(golden):
    """A pos_embed of another token count raises NotImplementedError like
    the reference's guard (egovlp/model.py:172-178)."""
    cfg, sd, _ = golden
    with pytest.raises(NotImplementedError, match="spatial"):
        convert.egovlp_state_dict(sd, dataclasses.replace(cfg, img_size=48))


def test_module_prefix_and_sequential_projection(golden):
    """nn.DataParallel's leading `module.` is stripped (not an inner one),
    the released `vid_proj.0.*` maps to `vid_proj.*`, and the text model's
    keys are left out."""
    cfg, sd, _ = golden
    wrapped = {"module." + k.replace("vid_proj.", "vid_proj.0."): v for k, v in sd.items()}
    wrapped["module.text_model.embeddings.module.weight"] = np.zeros(3, np.float32)
    got = convert.egovlp_state_dict(wrapped, cfg)
    want = convert.egovlp_state_dict(sd, cfg)
    names = egovlp.EgoVlpVideoTower(cfg, device="meta").state_dict()
    assert set(got) == set(want) == set(names)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_checkpoint_with_a_pickled_config_object_loads(golden, tmp_path, monkeypatch):
    """The released checkpoint pickles a parse_config.ConfigParser object
    beside its state dict: load_egovlp_state_dict unpickles it through the
    parse_config stand-in, with no parse_config module of its own."""
    cfg, sd, g = golden
    saved = types.ModuleType("parse_config")

    class ConfigParser:
        def __init__(self):
            self.config = {"arch": {"type": "FrozenInTime"}}

    ConfigParser.__module__, ConfigParser.__qualname__ = "parse_config", "ConfigParser"
    saved.ConfigParser = ConfigParser
    monkeypatch.setitem(sys.modules, "parse_config", saved)
    path = str(tmp_path / "egovlp.pth")
    torch.save({"config": ConfigParser(), "epoch": 3,
                "state_dict": {"module." + k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    monkeypatch.delitem(sys.modules, "parse_config")
    with pytest.raises(pickle.UnpicklingError):   # torch's weights_only load refuses it
        torch.load(path, weights_only=True)
    got = convert.load_egovlp_state_dict(path, cfg)
    assert sys.modules["parse_config"] is not saved
    np.testing.assert_allclose(_forward(_tower(cfg, got), g["frames"]), g["projected"],
                               atol=2e-4)
    raw = convert.read_egovlp_checkpoint(path)   # the tensors as saved, the config left out
    assert set(raw) == {"module." + k for k in sd}


def test_seeded_weights(golden):
    """Seeded weights load strictly and repeat with the seed (at the
    fixture's width); at full width (ViT-B/16, 4 frames, projection 256,
    the card's smoke run) the names and shapes are the reference's."""
    cfg = golden[0]
    sd = convert.random_egovlp_state_dict(cfg, seed=0)
    meta = egovlp.EgoVlpVideoTower(cfg, device="meta")
    meta.load_state_dict(convert.load_reference_state_dict(sd), assign=True)
    assert all(np.isfinite(v).all() for v in sd.values())
    again = convert.random_egovlp_state_dict(cfg, seed=0)
    assert all(np.array_equal(sd[k], again[k]) for k in sd)
    assert set(sd) == set(golden[1])
    full = egovlp.EgoVlpVideoTower(egovlp.EgoVlpConfig(), device="meta").state_dict()
    assert tuple(full["video_model.pos_embed"].shape) == (1, 197, 768)
    assert tuple(full["vid_proj.weight"].shape) == (256, 768)
