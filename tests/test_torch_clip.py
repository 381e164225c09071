"""The port's CLIP towers (cone_tpu_torch/models/clip.py) against
cone_tpu's flax towers and against HuggingFace's torch CLIP, at the tiny
configs of tests/test_clip_parity.py.

Weights: a seeded HF model; cone_tpu's tower takes them through its own
converter, the port's through convert.clip_*_params_from_jax (from the
flax tree) and, separately, through load_state_dict of the HF state dict
itself (the released layout). Limits: 2e-5 absolute against both (float32
sums in another order); padding invariance 1e-5.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from cone_tpu.models import clip as jclip
from cone_tpu_torch import convert
from cone_tpu_torch.models import clip

ATOL = 2e-5


@pytest.fixture(scope="module")
def hf_vision():
    cfg = transformers.CLIPVisionConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=2,
        image_size=16, patch_size=8, projection_dim=24, hidden_act="quick_gelu",
        attn_implementation="eager")
    torch.manual_seed(0)
    return cfg, transformers.CLIPVisionModelWithProjection(cfg).eval()


@pytest.fixture(scope="module")
def hf_text():
    cfg = transformers.CLIPTextConfig(
        vocab_size=99, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=2, max_position_embeddings=12, projection_dim=24,
        hidden_act="quick_gelu", eos_token_id=98, attn_implementation="eager")
    torch.manual_seed(1)
    return cfg, transformers.CLIPTextModelWithProjection(cfg).eval()


def _text_tower(hf_text):
    cfg, model = hf_text
    params = jclip.clip_text_state_dict_to_params(model.state_dict(), cfg.num_hidden_layers)
    tower = clip.ClipTextTower(clip.text_config_from_hf(cfg), device="cpu").eval()
    tower.load_state_dict(convert.clip_text_params_from_jax(params))
    return params, tower


def test_vision_tower_matches_cone_tpu_and_hf(hf_vision):
    cfg, model = hf_vision
    pixels = np.random.default_rng(0).normal(size=(3, 3, 16, 16)).astype(np.float32)  # NCHW
    with torch.no_grad():
        want_hf = model(pixel_values=torch.from_numpy(pixels)).image_embeds.numpy()
    params = jclip.clip_vision_state_dict_to_params(model.state_dict(), cfg.num_hidden_layers)
    want_jax = np.asarray(jclip.ClipVisionTower(jclip.vision_config_from_hf(cfg)).apply(
        {"params": params}, jnp.asarray(pixels.transpose(0, 2, 3, 1))))

    tower = clip.ClipVisionTower(clip.vision_config_from_hf(cfg), device="cpu").eval()
    tower.load_state_dict(convert.clip_vision_params_from_jax(params))
    released = clip.ClipVisionTower(clip.vision_config_from_hf(cfg), device="cpu").eval()
    released.load_state_dict(model.state_dict())     # HF's names, no converter
    with torch.no_grad():
        got = tower(torch.from_numpy(pixels)).numpy()
        got_released = released(torch.from_numpy(pixels)).numpy()
    assert got.shape == (3, 24)
    np.testing.assert_allclose(got, want_jax, atol=ATOL)
    np.testing.assert_allclose(got_released, want_hf, atol=ATOL)
    np.testing.assert_allclose(got, want_hf, atol=ATOL)


def test_text_tower_matches_cone_tpu_and_hf(hf_text):
    """Ragged lengths padded to the context (the reference tokenizes at a
    fixed context, clip_extractor.py:47): the EOT cls and the valid token
    rows (final_layer_norm once) against both."""
    cfg, model = hf_text
    rng = np.random.default_rng(1)
    lengths = [5, 12, 3]
    ids = np.zeros((3, 12), np.int64)
    for i, n in enumerate(lengths):
        ids[i, 0], ids[i, n - 1] = 97, 98
        ids[i, 1 : n - 1] = rng.integers(1, 97, n - 2)
    attn = (np.arange(12)[None] < np.asarray(lengths)[:, None]).astype(np.int64)
    eot = np.asarray(lengths) - 1
    with torch.no_grad():
        out = model(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(attn))
    params, tower = _text_tower(hf_text)
    want_tok, want_cls = jclip.ClipTextTower(jclip.text_config_from_hf(cfg)).apply(
        {"params": params}, jnp.asarray(ids), jnp.asarray(eot), jnp.asarray(attn, bool))
    released = clip.ClipTextTower(clip.text_config_from_hf(cfg), device="cpu").eval()
    released.load_state_dict(model.state_dict())
    with torch.no_grad():
        args = (torch.from_numpy(ids), torch.from_numpy(eot), torch.from_numpy(attn).bool())
        got_tok, got_cls = (x.numpy() for x in tower(*args))
        rel_tok, rel_cls = (x.numpy() for x in released(*args))
    np.testing.assert_allclose(got_cls, np.asarray(want_cls), atol=ATOL)
    np.testing.assert_allclose(rel_cls, out.text_embeds.numpy(), atol=ATOL)
    for i, n in enumerate(lengths):   # padded positions are garbage on every side
        np.testing.assert_allclose(got_tok[i, :n], np.asarray(want_tok)[i, :n], atol=ATOL)
        np.testing.assert_allclose(rel_tok[i, :n], out.last_hidden_state.numpy()[i, :n],
                                   atol=ATOL)


def test_text_tower_padding_invariance(hf_text):
    """Causal attention: padding never leaks into real positions, so the
    fixed-context batch gives the per-example forward (1e-5)."""
    _, tower = _text_tower(hf_text)
    ids = torch.tensor([[97, 5, 6, 98] + [0] * 8])
    with torch.no_grad():
        tok_p, cls_p = tower(ids, torch.tensor([3]), ids != 0)
        tok_u, cls_u = tower(ids, torch.tensor([3]))      # causal mask only
        tok_e, cls_e = tower(ids[:, :4], torch.tensor([3]))
    for tok, cls in ((tok_p, cls_p), (tok_u, cls_u)):
        np.testing.assert_allclose(tok[:, :4].numpy(), tok_e.numpy(), atol=1e-5)
        np.testing.assert_allclose(cls.numpy(), cls_e.numpy(), atol=1e-5)


def test_configs_from_hf_and_seeded_weights(hf_vision, hf_text):
    """The HF configs map field for field, a non-CLIP activation is
    refused, and the seeded random weights load strictly at full width
    (the card's smoke run uses them)."""
    vcfg, tcfg = clip.vision_config_from_hf(hf_vision[0]), clip.text_config_from_hf(hf_text[0])
    assert dataclasses.asdict(vcfg) == dataclasses.asdict(
        jclip.vision_config_from_hf(hf_vision[0]))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jclip.text_config_from_hf(hf_text[0]))
    with pytest.raises(NotImplementedError, match="quick_gelu"):
        clip.vision_config_from_hf(transformers.CLIPVisionConfig(hidden_act="gelu"))
    small_v, small_t = clip.vision_config_from_hf(hf_vision[0]), clip.text_config_from_hf(
        hf_text[0])
    for cfg, make, tower in ((small_v, convert.random_clip_vision_state_dict,
                              clip.ClipVisionTower),
                             (small_t, convert.random_clip_text_state_dict, clip.ClipTextTower)):
        sd = make(cfg, seed=0)
        meta = tower(cfg, device="meta")
        meta.load_state_dict(convert.load_reference_state_dict(sd), assign=True)
        assert {k: v.shape for k, v in sd.items()} == {
            k: tuple(v.shape) for k, v in meta.state_dict().items()}
        assert all(np.isfinite(v).all() for v in sd.values())
        again = make(cfg, seed=0)
        assert all(np.array_equal(sd[k], again[k]) for k in sd)
    # the full widths the card's smoke run draws: ViT-B/32 with its projection,
    # and CLIP's text vocabulary
    full_v = clip.ClipVisionTower(clip.ClipVisionConfig(), device="meta")
    assert sum(p.numel() for p in full_v.parameters()) == 87_849_216
    full_t = clip.ClipTextTower(clip.ClipTextConfig(), device="meta").state_dict()
    assert tuple(full_t["text_model.embeddings.token_embedding.weight"].shape) == (49408, 512)


def test_as_tower_builds_the_port_module_from_a_hf_model(hf_vision, hf_text):
    v = clip.as_vision_tower(hf_vision[1], "cpu")
    t = clip.as_text_tower(hf_text[1], "cpu")
    assert isinstance(v, clip.ClipVisionTower) and isinstance(t, clip.ClipTextTower)
    assert not v.training and not t.training
    assert clip.as_vision_tower(v, "cpu") is v
