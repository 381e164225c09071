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
from cone_tpu_torch.ops import tf32
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


@pytest.mark.parametrize("ctx_l,stride,d,q", [
    (2241, 32, 256, 8),    # Ego4D-TAN: max_v_l 64; segments of two 16-frame tiles
    (4000, 64, 512, 32),   # TAN-MAD: max_v_l 128; segments of four tiles
    (64, 32, 64, 8),       # ctx_l ends exactly on a segment and a tile edge
])
def test_plain_matches_pallas_interpret_at_the_tan_strides(rng, ctx_l, stride, d, q):
    """The 2D-TAN presets' coarse strides, which (unlike 45 and 62) are
    multiples of the kernel's 16-frame tiles: every segment ends on a tile
    edge."""
    feats, cls = _inputs(rng, ctx_l, stride, d=d, q=q, extra_seg=1)
    got = _plain(feats, cls, ctx_l, stride)
    want = np.asarray(pc.coarse_segment_max.__wrapped__(
        jnp.asarray(feats), jnp.asarray(cls), jnp.asarray(ctx_l), stride))
    n_valid = -(-ctx_l // stride)
    assert got.shape == (q, -(-feats.shape[0] // stride))
    np.testing.assert_allclose(got[:, :n_valid], want[:, :n_valid], rtol=1e-5)
    assert (got[:, n_valid:] <= co.NEG_INF / 2).all()
    # each segment's max is the max over its own frames of the scores
    scores = cls @ feats[:ctx_l].T
    seg = [scores[:, i * stride : min((i + 1) * stride, ctx_l)].max(-1) for i in range(n_valid)]
    np.testing.assert_allclose(got[:, :n_valid], np.stack(seg, -1), rtol=1e-5, atol=1e-5)


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


@pytest.mark.parametrize("label,l_pad,stride,b,spb,grid", [
    ("ego4d", 2304, 45, 1, 1, (52, 1)),              # 52 segments do not fill 132 SMs
    ("ego4d-video-batch", 2304, 45, 4, 2, (26, 4)),  # 208 segments: runs of 2
    ("mad", 36864, 62, 1, 5, (119, 1)),              # 595 segments: runs of 5, one block an SM
    ("ctx<stride", 90, 45, 2, 1, (2, 2)),
    ("one-segment", 40, 45, 1, 1, (1, 1)),
    ("long-batch", 36864, 62, 3, 14, (43, 3)),
    ("ego4d-tan", 2304, 32, 1, 1, (72, 1)),          # 72 segments of 32 frames
    ("ego4d-tan-video-batch", 2304, 32, 2, 2, (36, 2)),
    ("tan-mad", 36864, 64, 1, 5, (116, 1)),          # 576 segments: runs of 5 = 20 tiles
])
def test_launch_plan(label, l_pad, stride, b, spb, grid):
    n_seg = -(-l_pad // stride)
    plan = co.plan(n_seg, b)
    assert plan == dict(segs_per_block=spb, grid=grid)
    assert grid[0] * spb >= n_seg > (grid[0] - 1) * spb    # every segment has one owner
    assert grid[0] * grid[1] <= 132                        # the whole grid is resident at once


def test_launch_plan_follows_the_card():
    # a card with fewer SMs gets longer runs; one segment per block is the floor,
    # the whole video the ceiling
    assert co.plan(595, 1, n_sm=66)["segs_per_block"] == 10
    assert co.plan(595, 1, n_sm=1000)["segs_per_block"] == 1
    assert co.plan(3, 500, n_sm=132) == dict(segs_per_block=3, grid=(1, 500))


@pytest.mark.parametrize("label,q,d,l_pad,stride,spb,ntw,warps", [
    # Ego4D: 3 frame tiles x 4 query tiles = 12 items, a warp each
    ("ego4d", 32, 256, 2304, 45, 1, 1, 16),
    ("ego4d-video-batch", 32, 256, 2304, 45, 2, 2, 16),
    # MAD: 20 frame tiles a block, a warp carries all 32 queries of its frames
    ("mad", 32, 512, 36864, 62, 5, 4, 16),
    ("ctx<stride", 8, 64, 90, 45, 1, 1, 16),
    ("q5", 5, 16, 90, 45, 2, 1, 16),
    ("q40", 40, 64, 520, 45, 4, 8, 8),            # five query tiles: the instance of 8
    ("q40-short-run", 40, 64, 520, 45, 1, 1, 16),  # 3 x 5 items on 16 warps
    ("q100", 100, 64, 520, 62, 3, 16, 8),
    ("q128-stride7", 128, 100, 4000, 7, 40, 16, 8),
    # the 2D-TAN strides: a block's run is a whole number of 16-frame tiles
    ("ego4d-tan-q8", 8, 256, 2304, 32, 1, 1, 16),
    ("ego4d-tan-q32", 32, 256, 2304, 32, 1, 1, 16),   # 2 frame tiles x 4 query tiles
    ("tan-mad", 32, 512, 36864, 64, 5, 4, 16),        # 20 frame tiles a block
])
def test_kernel_layout(label, q, d, l_pad, stride, spb, ntw, warps):
    lay = co.layout(q, d, l_pad, stride, spb)
    assert (lay["ntw"], lay["warps"]) == (ntw, warps)
    n_qt, m_tiles = -(-q // 8), -(-min(spb * stride, l_pad) // 16)
    groups = -(-n_qt // ntw)
    assert groups * ntw >= n_qt                            # every query tile has an item
    if ntw < n_qt:                                         # split by queries only while
        assert m_tiles * groups <= warps                   # every item gets its own warp
    qpad, cls_ld = groups * ntw * 8, -(-d // 32) * 32 + 4
    assert lay["smem_bytes"] == 4 * (qpad * cls_ld + spb * qpad + warps * 3 * 16 * 36)
    assert lay["smem_bytes"] <= co.MAX_SMEM_BYTES


def test_kernel_layout_of_what_does_not_fit():
    # 128 queries of 516 floats exceed a block's shared memory: the wrapper raises
    assert co.layout(128, 512, 200, 45, 1)["smem_bytes"] > co.MAX_SMEM_BYTES
    # 64 queries at MAD width fit, on 8 warps: with 16 the rings would not
    lay = co.layout(64, 512, 200, 45, 1)
    assert lay["smem_bytes"] <= co.MAX_SMEM_BYTES and (lay["ntw"], lay["warps"]) == (8, 8)
    assert co.layout(64, 256, 200, 45, 1)["warps"] == 16


@pytest.mark.parametrize("label,l,d,scale", [("mad", 4096, 512, 1.0), ("ego4d", 2304, 256, 1.0),
                                             ("unnormalized", 512, 512, 30.0)])
def test_3xtf32_product_stays_inside_the_kernel_tolerance(rng, label, l, d, scale):
    # the kernel's arithmetic (three TF32 products per dot product) on unit
    # vectors at the coarse stage's widths, Q 32, against float64
    feats = rng.normal(size=(l, d))
    feats[: l // 8] += 4 * rng.normal(size=d)       # a planted direction: scores near 1
    feats = (scale * feats / np.linalg.norm(feats, axis=1, keepdims=True)).astype(np.float32)
    cls = rng.normal(size=(32, d))
    cls[:4] += feats[0] * 40 / scale
    cls = (cls / np.linalg.norm(cls, axis=1, keepdims=True)).astype(np.float32)
    want = cls.astype(np.float64) @ feats.astype(np.float64).T
    got = tf32.matmul_3xtf32(torch.from_numpy(cls), torch.from_numpy(feats).T).numpy()
    tol = 1e-5 * max(1.0, np.abs(want).max())
    assert np.abs(want).max() > 0.5 * scale      # the planted scores are large
    assert np.abs(got - want).max() <= tol / 4
    # a single TF32 product is outside it: the split is what keeps fp32 accuracy
    one = (tf32.round_tf32(torch.from_numpy(cls)).double()
           @ tf32.round_tf32(torch.from_numpy(feats)).double().T).numpy()
    assert np.abs(one - want).max() > tol


def test_tf32_rounding_and_split():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10, -1.0 - 2.0 ** -11, 0.0,
                      3.14159265, -1e-30, 65504.0])
    r = tf32.round_tf32(x)
    assert r.tolist()[:5] == [1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, -1.0 - 2.0 ** -10, 0.0]
    assert (r.view(torch.int32) & 0x1FFF).eq(0).all()          # 10 mantissa bits
    hi, lo = tf32.split_tf32(x)
    assert ((hi + lo) - x).abs().max() <= 2.0 ** -21 * x.abs().max()
    with pytest.raises(TypeError):
        tf32.round_tf32(x.double())


@pytest.mark.parametrize("seen_on, want", [(1, 7.5), (3, 7.5), (None, None)])
def test_device_time_read_retries_a_session_that_missed_the_kernel(monkeypatch, seen_on, want):
    # a profiler session whose trace lacks the kernel is tried again; when
    # every session misses it the device time is "not measured", not an error
    import torch.profiler

    from cone_tpu_torch.tools import bench_kernels

    sessions = []

    class Evt:
        key, count, self_device_time_total = "coarse_segment_max_kernel<1>", 20, 150.0

    class FakeProfile:
        def __init__(self, activities):
            sessions.append(self)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return [Evt()] if len(sessions) == seen_on else []

    calls = []
    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    got = bench_kernels.kernel_device_us(lambda: calls.append(1), "coarse_segment_max_kernel")
    assert got == want
    assert len(sessions) == (seen_on or bench_kernels.PROFILER_SESSIONS)
    assert len(calls) == 1 + 20 * len(sessions)
    assert bench_kernels.fmt_us(got) == ("not measured" if want is None else "7.50us")
