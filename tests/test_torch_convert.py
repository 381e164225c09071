"""Weights across packages (cone_tpu_torch/convert.py): the JAX param tree
-> the port's state dict -> the JAX param tree is exact, the port's
converter agrees with tools/convert_ckpt.py on reference checkpoints, and
the seeded random reference weights load strictly."""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from cone_tpu.config import ModelConfig as JModelConfig
from cone_tpu.models.init import build_model_and_params
from cone_tpu_torch.config import ModelConfig
from cone_tpu_torch.convert import (
    load_reference_state_dict,
    params_from_jax,
    params_to_jax,
    random_reference_state_dict,
)
from cone_tpu_torch.models.cone import ConeModel

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from convert_ckpt import params_to_torch_state_dict, torch_state_dict_to_params  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "cone_forward.npz")
SMALL = dict(hidden_dim=32, nheads=4, dim_feedforward=64, t_feat_dim=12,
             v_motion_feat_dim=10, v_appear_feat_dim=12, max_q_l=6, max_v_l=8)
VARIANTS = {"post_norm": {}, "pre_norm": {"pre_norm": True},
            "use_txt_pos": {"use_txt_pos": True},
            "no_adapter": {"adapter_module": "none", "n_input_proj": 1}}


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_trees_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert set(fa) == set(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_jax_params_round_trip_exact(variant):
    fields = {**SMALL, **VARIANTS[variant]}
    _, params = build_model_and_params(JModelConfig(**fields), seed=1)
    cfg = ModelConfig(**fields)
    sd = params_from_jax(params, cfg)
    model = ConeModel(cfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    _assert_trees_equal(params_to_jax(model.state_dict(), cfg), jax.device_get(params))


def test_reference_checkpoint_agrees_with_tools_converter():
    """On the golden's reference weights: the port's inverse converter
    builds the same JAX tree as tools/convert_ckpt.py, and its forward
    converter gives back the reference tensors."""
    g = np.load(GOLDEN)
    sd_np = {k[3:]: g[k] for k in g.files if k.startswith("w::")}
    cfg = ModelConfig(t_feat_dim=36, v_motion_feat_dim=40, v_appear_feat_dim=36, max_q_l=20,
                      max_v_l=20)
    jcfg = JModelConfig(t_feat_dim=36, v_motion_feat_dim=40, v_appear_feat_dim=36,
                        max_q_l=20, max_v_l=20)
    sd = load_reference_state_dict({f"w::{k}": v for k, v in sd_np.items()})
    assert set(sd) == set(sd_np) and all(v.dtype == torch.float32 for v in sd.values())
    want_tree = torch_state_dict_to_params(sd_np, jcfg)
    _assert_trees_equal(params_to_jax(sd, cfg), want_tree)
    back = params_from_jax(want_tree, cfg)
    exported = params_to_torch_state_dict(want_tree, jcfg)
    assert set(back) == set(exported) == set(sd_np)
    for k in sd_np:
        if not k.startswith("txt_position_embed"):  # unused with use_txt_pos=False
            np.testing.assert_array_equal(back[k].numpy(), sd_np[k], err_msg=k)
        np.testing.assert_array_equal(back[k].numpy(), exported[k], err_msg=k)


def test_checkpoint_container_and_tensors_load():
    g = np.load(GOLDEN)
    sd = {k[3:]: torch.from_numpy(g[k]) for k in g.files if k.startswith("w::")}
    out = load_reference_state_dict({"model": sd, "epoch": 3})
    assert set(out) == set(sd)
    assert all(torch.equal(out[k], sd[k]) for k in sd)


def test_random_reference_state_dict_is_seeded_and_loads_strict():
    cfg = ModelConfig(**SMALL)
    a, b = random_reference_state_dict(cfg, seed=7), random_reference_state_dict(cfg, seed=7)
    c = random_reference_state_dict(cfg, seed=8)
    assert set(a) == set(ConeModel(cfg, device="cpu").state_dict())
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not all(np.array_equal(a[k], c[k]) for k in a)
    ConeModel(cfg, device="cpu").load_state_dict(load_reference_state_dict(a), strict=True)
