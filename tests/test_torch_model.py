"""The port's ConeModel (cone_tpu_torch/models) against the reference
golden fixture and against cone_tpu's flax ConeModel on the same weights.

  * tests/golden/cone_forward.npz: the reference model's weights (`w::`,
    loaded with a strict load_state_dict) and outputs, at the tolerances of
    tests/test_model_parity.py;
  * cone_tpu's ConeModel on converted params for post-norm, pre-norm,
    use_txt_pos and the TPU layout pad seq_pad_multiple: atol 1e-5 (fp32
    sums in another order).
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cone_tpu.config import ModelConfig as JModelConfig
from cone_tpu.models.cone import ConeModel as JConeModel
from cone_tpu.models.cone import sine_position_embedding as jsine
from cone_tpu.models.init import build_model_and_params
from cone_tpu_torch.config import ModelConfig
from cone_tpu_torch.convert import load_reference_state_dict, params_from_jax
from cone_tpu_torch.models.cone import ConeModel, sine_position_embedding

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "cone_forward.npz")


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN).items())


@pytest.fixture(scope="module")
def golden_model(golden):
    cfg = ModelConfig(t_feat_dim=36, v_motion_feat_dim=40, v_appear_feat_dim=36,
                      hidden_dim=256, nheads=8, enc_layers=2, dec_layers=2,
                      dim_feedforward=1024, max_q_l=20, max_v_l=20)
    model = ConeModel(cfg, device="cpu").eval()
    sd = load_reference_state_dict({k: v for k, v in golden.items() if k.startswith("w::")})
    model.load_state_dict(sd, strict=True)
    return model


@pytest.fixture(scope="module")
def golden_out(golden, golden_model):
    g = golden
    with torch.no_grad():
        return golden_model(*(torch.from_numpy(g[k]) for k in
                              ("src_txt", "src_txt_mask", "src_vid", "src_vid_mask")))


def test_reference_state_dict_loads_strict(golden, golden_model):
    names = {k[3:] for k in golden if k.startswith("w::")}
    assert len(names) == 96 and set(golden_model.state_dict()) == names


@pytest.mark.parametrize("key,atol", [("pred_spans", 2e-5), ("pred_logits", 2e-4),
                                      ("saliency_scores", 5e-4)])
def test_forward_matches_golden(golden, golden_out, key, atol):
    np.testing.assert_allclose(golden_out[key].numpy(), golden[key], atol=atol)


@pytest.mark.parametrize("key,atol", [("pred_spans", 2e-5), ("pred_logits", 2e-4)])
def test_aux_outputs_match_golden(golden, golden_out, key, atol):
    assert len(golden_out["aux_outputs"]) == 1
    np.testing.assert_allclose(golden_out["aux_outputs"][0][key].numpy(),
                               golden[f"aux0_{key}"], atol=atol)


def test_matching_heads_match_golden(golden, golden_model, golden_out):
    g = golden
    with torch.no_grad():
        gt = golden_model.clip_matching_gt(
            torch.from_numpy(g["cls_txt"]), torch.from_numpy(g["vid_appear"]),
            torch.from_numpy(g["prop_start"]), torch.from_numpy(g["prop_end"]))
        pred = golden_model.clip_matching_pred(
            torch.from_numpy(g["cls_txt"]), torch.from_numpy(g["vid_appear"]),
            torch.from_numpy(g["vid_appear_mask"]), golden_out["pred_spans"])
    np.testing.assert_allclose(gt.numpy(), g["logits_per_video"], atol=1e-4)
    np.testing.assert_allclose(pred.numpy(), g["matching_pred"], atol=1e-4)


def test_sine_position_embedding_matches_jax(rng):
    mask = np.zeros((3, 17), np.float32)
    for i, n in enumerate([17, 9, 1]):
        mask[i, :n] = 1
    np.testing.assert_allclose(sine_position_embedding(torch.from_numpy(mask), 64).numpy(),
                               np.asarray(jsine(jnp.asarray(mask), 64)), atol=1e-5)


VARIANTS = {
    "post_norm": {},
    "pre_norm": {"pre_norm": True},
    "use_txt_pos": {"use_txt_pos": True},
    "seq_pad_16": {"seq_pad_multiple": 16},
    "no_adapter_3proj": {"adapter_module": "none", "n_input_proj": 3},
}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def pair(request):
    """(jax model, jax params, port model, config) on the same weights."""
    fields = dict(hidden_dim=64, nheads=4, enc_layers=2, dec_layers=2,
                  dim_feedforward=128, t_feat_dim=24, v_motion_feat_dim=20,
                  v_appear_feat_dim=24, max_q_l=8, max_v_l=16, **VARIANTS[request.param])
    jcfg = JModelConfig(**fields)
    jmodel, params = build_model_and_params(jcfg, seed=3)
    cfg = ModelConfig(**fields)
    model = ConeModel(cfg, device="cpu").eval()
    model.load_state_dict(params_from_jax(params, cfg), strict=True)
    return jmodel, params, model, cfg


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    b = 5
    txt = rng.normal(size=(b, cfg.max_q_l, cfg.t_feat_dim)).astype(np.float32)
    vid = rng.normal(size=(b, cfg.max_v_l, cfg.v_motion_feat_dim)).astype(np.float32)
    app = rng.normal(size=(b, cfg.max_v_l, cfg.v_appear_feat_dim)).astype(np.float32)
    tmask = np.zeros((b, cfg.max_q_l), np.float32)
    vmask = np.zeros((b, cfg.max_v_l), np.float32)
    for i in range(b):
        tmask[i, : 1 + i * cfg.max_q_l // b] = 1
        vmask[i, : cfg.max_v_l - 3 * i] = 1
    cls = rng.normal(size=(b, cfg.v_appear_feat_dim)).astype(np.float32)
    return txt, tmask, vid, vmask, app, cls


def test_forward_matches_cone_tpu(pair):
    jmodel, params, model, cfg = pair
    txt, tmask, vid, vmask, _, _ = _inputs(cfg)
    want = jmodel.apply({"params": params}, *(jnp.asarray(x) for x in (txt, tmask, vid, vmask)),
                        deterministic=True)
    with torch.no_grad():
        got = model(*(torch.from_numpy(x) for x in (txt, tmask, vid, vmask)))
    for key in ("pred_logits", "pred_spans", "saliency_scores"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-5,
                                   err_msg=key)
    for g, w in zip(got["aux_outputs"], want["aux_outputs"]):
        for key in ("pred_logits", "pred_spans"):
            np.testing.assert_allclose(g[key].numpy(), np.asarray(w[key]), atol=1e-5)


def test_adapter_and_matching_match_cone_tpu(pair):
    jmodel, params, model, cfg = pair
    _, _, _, vmask, app, cls = _inputs(cfg, seed=1)
    spans = np.random.default_rng(2).uniform(0, 1, (len(cls), cfg.num_queries, 2)).astype(np.float32)
    v = {"params": params}
    with torch.no_grad():
        got_adapt = model.adapt(torch.from_numpy(app))
        got_pred = model.clip_matching_pred(torch.from_numpy(cls), torch.from_numpy(app),
                                            torch.from_numpy(vmask), torch.from_numpy(spans))
        st, ed = torch.tensor([0, 2, 5, 1, 3]), torch.tensor([3, 9, 12, 2, 16])
        got_gt = model.clip_matching_gt(torch.from_numpy(cls), torch.from_numpy(app), st, ed)
    np.testing.assert_allclose(
        got_adapt.numpy(),
        np.asarray(jmodel.apply(v, jnp.asarray(app), method=JConeModel.adapt)), atol=1e-5)
    np.testing.assert_allclose(got_pred.numpy(), np.asarray(jmodel.apply(
        v, jnp.asarray(cls), jnp.asarray(app), jnp.asarray(vmask), jnp.asarray(spans),
        method=JConeModel.clip_matching_pred)), atol=1e-5)
    np.testing.assert_allclose(got_gt.numpy(), np.asarray(jmodel.apply(
        v, jnp.asarray(cls), jnp.asarray(app), jnp.asarray(st.numpy()),
        jnp.asarray(ed.numpy()), method=JConeModel.clip_matching_gt)), atol=1e-5)


def test_model_rejects_compute_dtype_it_does_not_run():
    with pytest.raises(NotImplementedError):
        ConeModel(dataclasses.replace(ModelConfig(), compute_dtype="bfloat16"), device="cpu")
