"""The port's coarse stage (cone_tpu_torch/ops/coarse.py) on the CPU: the
plain version against cone_tpu's Pallas kernel run in interpret mode, the
window combine, the video-batch axis, and the wrapper's routing, checks
and launch counter. The CUDA kernel itself is held against the plain
version on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import cone_tpu.ops.pallas_coarse as pc
from cone_tpu_torch.ops import coarse as co
from cone_tpu_torch.ops.windows import num_windows, window_scores_from_frame_scores


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    # CPU has no Mosaic backend: run the Pallas kernel in interpret mode,
    # exactly as tests/test_pallas_coarse.py does
    orig = pl.pallas_call
    monkeypatch.setattr(
        pl, "pallas_call", lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    yield


def _inputs(rng, ctx_l, stride, d=64, q=8, extra_seg=3):
    n_seg = -(-ctx_l // stride) + extra_seg
    l_pad = n_seg * stride
    feats = np.zeros((l_pad, d), np.float32)
    feats[:ctx_l] = rng.normal(size=(ctx_l, d))
    cls = rng.normal(size=(q, d)).astype(np.float32)
    return feats, cls


def _plain(feats, cls, ctx_l, stride):
    return co.coarse_segment_max_plain(
        torch.from_numpy(feats)[None], torch.from_numpy(cls)[None],
        torch.tensor([ctx_l], dtype=torch.int32), stride)[0].numpy()


@pytest.mark.parametrize("ctx_l,stride", [(333, 45), (900, 45), (496, 62)])
def test_plain_matches_pallas_interpret(rng, ctx_l, stride):
    feats, cls = _inputs(rng, ctx_l, stride)
    got = _plain(feats, cls, ctx_l, stride)
    want = np.asarray(pc.coarse_segment_max.__wrapped__(
        jnp.asarray(feats), jnp.asarray(cls), jnp.asarray(ctx_l), stride))
    n_seg = got.shape[1]
    assert n_seg == -(-feats.shape[0] // stride) and want.shape[1] >= n_seg
    n_valid = -(-ctx_l // stride)
    np.testing.assert_allclose(got[:, :n_valid], want[:, :n_valid], rtol=1e-5)
    assert (got[:, n_valid:] <= co.NEG_INF / 2).all()
    assert (want[:, n_valid:n_seg] <= pc.NEG_INF / 2).all()


@pytest.mark.parametrize("ctx_l,stride", [(700, 45), (30, 45), (496, 62)])
def test_window_combine_matches_jax(rng, ctx_l, stride):
    feats, cls = _inputs(rng, ctx_l, stride, d=32, extra_seg=2)
    seg = _plain(feats, cls, ctx_l, stride)
    max_w = num_windows(feats.shape[0], stride)
    got_s, got_v = co.window_scores_from_segment_max(torch.from_numpy(seg), ctx_l, stride, max_w)
    want_s, want_v = pc.window_scores_from_segment_max(
        jnp.asarray(seg), jnp.asarray(ctx_l), stride, max_w)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_v[0].numpy(), np.asarray(want_v))

    # and the segment route equals the frame-score route of ops/windows.py
    fs = torch.from_numpy(cls @ feats.T)
    f_s, f_v = window_scores_from_frame_scores(fs, ctx_l, stride, max_w)
    nw = num_windows(ctx_l, stride)
    np.testing.assert_allclose(got_s[:, :nw].numpy(), f_s[:, :nw].numpy(), rtol=1e-5)
    np.testing.assert_array_equal(got_v.numpy(), f_v.numpy())


def test_video_batch_axis_equals_per_video(rng):
    stride, l_pad, d, q = 45, 450, 16, 5
    ctx = [450, 91, 7]
    feats = rng.normal(size=(3, l_pad, d)).astype(np.float32)
    cls = rng.normal(size=(3, q, d)).astype(np.float32)
    got = co.coarse_segment_max(torch.from_numpy(feats), torch.from_numpy(cls),
                                torch.tensor(ctx, dtype=torch.int32), stride).numpy()
    for b in range(3):
        np.testing.assert_array_equal(got[b], _plain(feats[b], cls[b], ctx[b], stride))


def test_cpu_tensors_take_the_plain_version_and_count_no_launch(rng):
    feats, cls = _inputs(rng, 200, 45)
    args = (torch.from_numpy(feats)[None], torch.from_numpy(cls)[None],
            torch.tensor([200], dtype=torch.int32), 45)
    before = co.coarse_segment_max.launches
    np.testing.assert_array_equal(co.coarse_segment_max(*args).numpy(),
                                  co.coarse_segment_max_plain(*args).numpy())
    assert co.coarse_segment_max.launches == before == 0


@pytest.mark.parametrize("bad,err", [
    ("feats_f64", TypeError), ("ctx_i64", TypeError), ("cls_width", ValueError),
    ("ctx_batch", ValueError), ("feats_2d", ValueError), ("stride0", ValueError),
    ("meta_device", ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, err):
    feats = torch.zeros(2, 90, 8)
    cls = torch.zeros(2, 4, 8)
    ctx = torch.tensor([90, 45], dtype=torch.int32)
    stride = 45
    if bad == "feats_f64":
        feats = feats.double()
    elif bad == "ctx_i64":
        ctx = ctx.long()
    elif bad == "cls_width":
        cls = torch.zeros(2, 4, 7)
    elif bad == "ctx_batch":
        ctx = ctx[:1]
    elif bad == "feats_2d":
        feats = feats[0]
    elif bad == "stride0":
        stride = 0
    elif bad == "meta_device":
        # a device with no kernel raises: nothing falls back to the plain version
        feats, cls, ctx = (x.to("meta") for x in (feats, cls, ctx))
    with pytest.raises(err):
        co.coarse_segment_max(feats, cls, ctx, stride)
