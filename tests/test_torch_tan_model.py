"""The port's 2D-TAN model (cone_tpu_torch/models/tan.py) and its weight
converters (cone_tpu_torch/convert.py) on the CPU:

  * the reference-generated fixtures tests/golden/tan_forward.npz and
    tan_forward_stride2.npz, with the limits of tests/test_tan_parity.py
    (scores atol 3e-4, map mask exact, the stride-2 top-1 decode atol
    1e-5) and the fixture's intermediates;
  * cone_tpu's ConeTanModel on the same weights (tan_params_to_jax) at atol
    1e-5 for every frame, proposal and adapter variant, and the matching
    branch;
  * sparse_map_layout against cone_tpu's over tests/test_tan_variants.py's
    fuzz geometries;
  * the converters: JAX params both ways, the real CONE_TAN names with and
    without `module.`, the fixtures' compact names, and equality with
    tools/convert_tan_ckpt.py;
  * the float32 scope: the model leaves the process-global TF32 flags as it
    found them, and a zero map cell gets no NaN gradient.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cone_tpu.models import tan as jtan
from cone_tpu.config import TanConfig as JTanConfig
from cone_tpu_torch.config import TanConfig
from cone_tpu_torch.convert import (
    load_reference_tan_state_dict,
    random_reference_tan_state_dict,
    tan_params_from_jax,
    tan_params_to_jax,
)
from cone_tpu_torch.eval.tan_pipeline import top_k_ref_order
from cone_tpu_torch.models.tan import (
    ConeTanModel,
    bce_rescale_loss,
    iou_target_map,
    sparse_map_layout,
    sparse_map_mask,
)

_DIR = os.path.join(os.path.dirname(__file__), "golden")
GOLDEN_ATOL = 3e-4   # tests/test_tan_parity.py
JAX_ATOL = 1e-5      # fp32 on both sides, sums in another order
GOLDEN_CFG = dict(num_clips=64, hidden_size=64, v_feat_dim=64, t_feat_dim=48,
                  txt_hidden_size=64, map_hidden_sizes=(64, 64, 64, 64))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small eager ops: torch's intra-op pool spins against the other
    test workers (tests/test_torch_train.py has the same fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name):
    return dict(np.load(os.path.join(_DIR, name)).items())


def _golden_model(g, **kw):
    model = ConeTanModel(TanConfig(**GOLDEN_CFG, **kw), device="cpu")
    model.load_state_dict(load_reference_tan_state_dict(
        {k: v for k, v in g.items() if k.startswith("w::")}))
    return model


@pytest.fixture(scope="module")
def golden():
    return _load("tan_forward.npz")


@pytest.fixture(scope="module")
def golden_s2():
    return _load("tan_forward_stride2.npz")


def test_golden_forward_and_intermediates(golden):
    g = golden
    model = _golden_model(g)
    tok, mask, vis = (torch.from_numpy(g[k]) for k in ("tok", "tok_mask", "vis"))
    with torch.no_grad():
        scores, map_mask = model(tok, mask, vis)
        vis_h = model.frame_layer(vis.transpose(1, 2))
        map_h, _ = model.prop_layer(vis_h)
        fused = model.fusion_layer(tok, mask, map_h, map_mask)
        conved = model.map_layer(fused)
    np.testing.assert_array_equal(map_mask.numpy(), g["map_mask"])
    np.testing.assert_array_equal(sparse_map_mask(64, (16, 8, 8)), g["map_mask"])
    np.testing.assert_allclose(scores.numpy(), g["scores"], atol=GOLDEN_ATOL)
    # the fixture's intermediates are the reference's channel-first tensors
    for name, got in (("vis_h", vis_h), ("map_h", map_h), ("fused", fused),
                      ("conved", conved)):
        np.testing.assert_allclose(got.numpy(), g[name], atol=GOLDEN_ATOL, err_msg=name)


def test_golden_loss_and_targets(golden):
    g = golden
    for i, (s, e) in enumerate([(3.2, 17.9), (40.0, 63.5), (0.0, 5.0)]):
        np.testing.assert_allclose(iou_target_map(64, s, e), g["targets"][i], atol=1e-6)
    loss, joint = bce_rescale_loss(torch.from_numpy(g["scores"]),
                                   torch.from_numpy(g["map_mask"]),
                                   torch.from_numpy(g["targets"]))
    assert abs(float(loss) - float(g["loss"])) < 2e-5   # tests/test_tan_parity.py
    assert joint.shape == g["scores"].shape


def test_golden_stride2_forward_and_decode(golden_s2):
    """The raw 128-clip window through stride-2 frame pooling, and the
    cell -> seconds decode scaled by TARGET_STRIDE (test.py:293-297)."""
    g = golden_s2
    model = _golden_model(g, frame_kernel=2, frame_stride=2, adapter_module="none")
    with torch.no_grad():
        scores, map_mask = model(*(torch.from_numpy(g[k]) for k in ("tok", "tok_mask", "vis")))
    np.testing.assert_array_equal(map_mask.numpy(), g["map_mask"])
    np.testing.assert_allclose(scores.numpy(), g["scores"], atol=GOLDEN_ATOL)
    # the decode, on the fixture's scores as tests/test_tan_parity.py does it:
    # this random-weight map is flat to 1e-8, so the port's own scores would
    # pick among near-ties. The pipeline's top-1 cell, then its cell ->
    # seconds formula
    masked = torch.where(torch.from_numpy(g["map_mask"]) > 0,
                         torch.from_numpy(g["scores"]), -torch.inf).reshape(3, -1)
    _, idx = top_k_ref_order(masked, 1)
    cells = torch.stack([idx // 64, idx % 64 + 1], dim=-1).float()
    got = (cells * 2 + int(g["video_start"])) * float(g["clip_len"])
    np.testing.assert_allclose(got[:, 0].numpy(), g["decoded_top1"], atol=1e-5)


VARIANTS = {
    "avg-sparse_pool-linear": dict(),
    "max2-sparse_pool-linear": dict(frame_module="max", frame_stride=2),
    "avg2-sparse_conv-linear": dict(prop_module="sparse_conv", frame_kernel=2, frame_stride=2),
    "avg-dense_pool-none": dict(prop_module="dense_pool", dense_num_layers=4,
                                adapter_module="none"),
    "max-sparse_conv-none": dict(frame_module="max", prop_module="sparse_conv",
                                 adapter_module="none"),
}
SMALL = dict(num_clips=32, hidden_size=48, v_feat_dim=32, t_feat_dim=24, txt_hidden_size=40,
             lstm_layers=2, num_scale_layers=(8, 4), map_hidden_sizes=(48, 48),
             map_kernel_sizes=(5, 5), map_paddings=(4, 0))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_model_matches_cone_tpu(variant):
    kw = {**SMALL, **VARIANTS[variant]}
    cfg, jcfg = TanConfig(**kw), JTanConfig(**kw)
    sd = random_reference_tan_state_dict(cfg, seed=1)
    model = ConeTanModel(cfg, device="cpu")
    model.load_state_dict(load_reference_tan_state_dict(sd))
    params = tan_params_to_jax(sd, cfg)
    jm = jtan.ConeTanModel(jcfg)

    rng = np.random.default_rng(2)
    b, lq, win = 3, 8, cfg.num_clips * cfg.frame_stride
    tok = rng.normal(size=(b, lq, cfg.t_feat_dim)).astype(np.float32)
    mask = np.ones((b, lq), np.float32)
    mask[1, 5:] = 0
    mask[2, 2:] = 0
    vis = rng.normal(size=(b, win, cfg.v_feat_dim)).astype(np.float32)
    cls = rng.normal(size=(b, cfg.v_feat_dim)).astype(np.float32)
    appear = rng.normal(size=(b, win, cfg.v_feat_dim)).astype(np.float32)
    st = np.array([[0, 3, 10], [5, 5, 1], [2, 30, 0]], np.int64)
    ed = np.array([[4, 9, 11], [5, 8, 40], [6, 34, 1]], np.int64)  # empty, past the end

    want, want_mask = jax.jit(jm.apply)({"params": params}, tok, mask, vis)
    want_pred = jm.apply({"params": params}, cls, appear, st, ed,
                         method=jtan.ConeTanModel.clip_matching_pred)
    want_gt = jm.apply({"params": params}, cls, appear, st[:, 0], st[:, 0] + 4,
                       method=jtan.ConeTanModel.clip_matching_gt)
    t = torch.from_numpy
    with torch.no_grad():
        got, got_mask = model(t(tok), t(mask), t(vis))
        got_pred = model.clip_matching_pred(t(cls), t(appear), t(st), t(ed))
        got_gt = model.clip_matching_gt(t(cls), t(appear), t(st[:, 0]), t(st[:, 0] + 4))
    assert float(np.abs(np.asarray(want)).max()) > 1e3 * JAX_ATOL   # a test with teeth
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=JAX_ATOL)
    np.testing.assert_allclose(got_pred.numpy(), np.asarray(want_pred), atol=JAX_ATOL)
    np.testing.assert_allclose(got_gt.numpy(), np.asarray(want_gt), atol=JAX_ATOL)


@pytest.mark.parametrize("nc,scales", [
    (64, (16, 8, 8)), (64, (8, 8)), (32, (16, 8, 8)), (16, (8, 4, 4)), (16, (16, 8, 8)),
    (8, (4, 4)), (128, (16, 8, 8)),
])
def test_sparse_layout_matches_cone_tpu(nc, scales):
    """tests/test_tan_variants.py's fuzz geometries, degenerate stacks
    included: the same records, the same mask, and a module that builds."""
    assert sparse_map_layout(nc, scales) == jtan.sparse_map_layout(nc, scales)
    np.testing.assert_array_equal(sparse_map_mask(nc, scales), jtan.sparse_map_mask(nc, scales))
    model = ConeTanModel(TanConfig(num_clips=nc, num_scale_layers=scales, hidden_size=8,
                                   v_feat_dim=4, t_feat_dim=4, txt_hidden_size=8,
                                   lstm_layers=1, map_hidden_sizes=(8,),
                                   map_kernel_sizes=(3,), map_paddings=(1,)), device="cpu")
    np.testing.assert_array_equal(model.map_mask.numpy(), jtan.sparse_map_mask(nc, scales))
    with torch.no_grad():
        scores, _ = model(torch.zeros(1, 3, 4), torch.ones(1, 3), torch.randn(1, nc, 4))
    assert scores.shape == (1, nc, nc)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_converter_round_trip(variant):
    """JAX params -> port -> JAX params is exact; flax's own init tree
    loads strictly into the port's module."""
    kw = {**SMALL, **VARIANTS[variant]}
    cfg, jcfg = TanConfig(**kw), JTanConfig(**kw)
    win = cfg.num_clips * cfg.frame_stride
    # flax's own param tree (shapes by tracing, values from numpy)
    shapes = jax.eval_shape(lambda: jtan.ConeTanModel(jcfg).init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((2, 4, cfg.t_feat_dim)),
        jnp.ones((2, 4)), jnp.zeros((2, win, cfg.v_feat_dim)),
        jnp.zeros((2, cfg.v_feat_dim)), jnp.zeros((2, win, cfg.v_feat_dim)),
        method=jtan.ConeTanModel.init_all))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), shapes)
    sd = tan_params_from_jax(params, cfg)
    ConeTanModel(cfg, device="cpu").load_state_dict(sd)   # strict
    back = tan_params_to_jax(sd, cfg)
    a, b = _flat(params), _flat(back)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # the LSTM bias sum sits in bias_ih, bias_hh is zero
    assert all(float(v.abs().max()) == 0 for k, v in sd.items() if "bias_hh" in k)


def test_reference_name_schemes(golden):
    """The fixture's compact names, the real CONE_TAN names, `module.`
    prefixes and the {"model"} / {"state_dict"} wrappers all load to the
    same tensors; the JAX tree they make equals tools/convert_tan_ckpt.py's."""
    compact = {k[3:]: v for k, v in golden.items() if k.startswith("w::")}
    ref = load_reference_tan_state_dict(compact)
    model = ConeTanModel(TanConfig(**GOLDEN_CFG), device="cpu")
    assert set(ref) == set(model.state_dict())
    assert not any(k.startswith(("frame.", "mapconv.", "pred.")) for k in ref)
    real = {k: v.numpy() for k, v in ref.items()}
    for raw in (real, {f"module.{k}": v for k, v in real.items()},
                {"model": real}, {"state_dict": {f"module.{k}": v for k, v in compact.items()}}):
        got = load_reference_tan_state_dict(raw)
        assert set(got) == set(ref)
        for k in ref:
            assert torch.equal(got[k], ref[k]), k

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    from convert_tan_ckpt import tan_state_dict_to_params

    want = _flat(tan_state_dict_to_params(dict(compact)))
    got = _flat(tan_params_to_jax(ref, TanConfig(**GOLDEN_CFG)))
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-7, err_msg=k)


def test_forward_keeps_the_global_tf32_flags_and_zero_cells_get_finite_grads(golden):
    """On the CPU the forward leaves the global TF32 flags as it found them
    (only resolving a CUDA device switches them off); zero cells of the
    fused map (every masked cell once the 1x1 conv has no bias) give finite
    gradients."""
    model = _golden_model(golden)
    with torch.no_grad():   # masked map cells now fuse to exact zeros
        model.fusion_layer.vis_conv.bias.zero_()
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tok = torch.from_numpy(golden["tok"])
        mask = torch.from_numpy(golden["tok_mask"])
        vis = torch.from_numpy(golden["vis"]).requires_grad_()
        scores, map_mask = model(tok, mask, vis)
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
        fused = model.fusion_layer(tok, mask, model.prop_layer(
            model.frame_layer(vis.transpose(1, 2)))[0], map_mask)
        assert int((fused.abs().sum(1) == 0).sum()) >= 3 * int((map_mask == 0).sum())
        (scores.sum() + fused.sum()).backward()
        grads = [p.grad for p in model.parameters() if p.grad is not None] + [vis.grad]
        assert all(torch.isfinite(g).all() for g in grads)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


def test_resolving_the_card_switches_tf32_off(monkeypatch):
    """The float32 guarantee of the convolution family: resolving a CUDA
    device turns cuDNN's and cuBLAS's TF32 off, whatever they were; a CPU
    device leaves them alone. (tests/test_torch_cuda.py shows the forward
    on the card.)"""
    from cone_tpu_torch.utils.device import resolve_device

    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        assert resolve_device("cpu") == torch.device("cpu")
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        assert resolve_device("cuda") == torch.device("cuda")
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before
