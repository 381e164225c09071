"""The port's ops (cone_tpu_torch/ops) against cone_tpu's on the same
seeded inputs: span geometry, window math, pooling and matching, 4-dp
rounding, host and device NMS. Elementwise math is the same float32 math
in both frameworks, so the tolerance is exact or <= 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cone_tpu.ops import nms as jnms
from cone_tpu.ops import pooling as jpool
from cone_tpu.ops import spans as jspans
from cone_tpu.ops import windows as jwin
from cone_tpu_torch.ops import nms as tnms
from cone_tpu_torch.ops import pooling as tpool
from cone_tpu_torch.ops import spans as tspans
from cone_tpu_torch.ops import windows as twin

ATOL = 1e-6


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


def _spans(rng, n, scale=1.0):
    st = rng.uniform(0, 100, n) * scale
    return np.stack([st, st + rng.uniform(0.5, 20, n) * scale], -1).astype(np.float32)


@pytest.mark.parametrize("fn", ["span_cxw_to_xx", "span_xx_to_cxw"])
def test_span_format_conversions(rng, fn):
    x = _spans(rng, 50)
    _close(getattr(tspans, fn)(_t(x)), getattr(jspans, fn)(jnp.asarray(x)))


@pytest.mark.parametrize("fn", ["temporal_iou", "generalized_temporal_iou"])
def test_pairwise_iou(rng, fn):
    a, b = _spans(rng, 7), _spans(rng, 9)
    got = getattr(tspans, fn)(_t(a), _t(b))
    want = getattr(jspans, fn)(jnp.asarray(a), jnp.asarray(b))
    if fn == "temporal_iou":
        for g, w in zip(got, want):
            _close(g, w)
    else:
        _close(got, want)


@pytest.mark.parametrize("magnitude", [1.0, 100.0, 7000.0])
def test_round4_device_matches_jax(rng, magnitude):
    """Includes MAD-magnitude timestamps (past ~839 s the naive fp32
    round(x * 1e4) loses the .5 boundary) and exact half-quanta."""
    x = (rng.uniform(0, 1, 400) * magnitude).astype(np.float32)
    x[:20] = (np.floor(x[:20] * 1e4) + 0.5).astype(np.float32) / np.float32(1e4)
    got = tspans.round4_device(_t(x)).numpy()
    want = np.asarray(jspans.round4_device(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)


CTX_STRIDE = [(30, 45), (900, 45), (2243, 45), (496, 62), (62, 62)]


@pytest.mark.parametrize("ctx_l,stride", CTX_STRIDE)
def test_num_windows_and_bounds(ctx_l, stride):
    n = twin.num_windows(ctx_l, stride)
    assert n == jwin.num_windows(ctx_l, stride)
    idx = np.arange(n)
    ts, te = twin.window_bounds(_t(idx), stride, 2 * stride, ctx_l)
    js, je = jwin.window_bounds(jnp.asarray(idx), stride, 2 * stride, ctx_l)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert twin.window_bounds(1, stride, 2 * stride, ctx_l) == (0, min(2 * stride, ctx_l))


@pytest.mark.parametrize("ctx_l,stride", CTX_STRIDE)
def test_window_scores_from_frame_scores(rng, ctx_l, stride):
    l_pad = ctx_l + 37
    max_w = twin.num_windows(l_pad, stride)
    fs = rng.normal(size=l_pad).astype(np.float32)
    got_s, got_v = twin.window_scores_from_frame_scores(_t(fs), ctx_l, stride, max_w)
    want_s, want_v = jwin.window_scores_from_frame_scores(
        jnp.asarray(fs), jnp.asarray(ctx_l), stride, max_w)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_window_scores_batched_over_videos_and_queries(rng):
    """A (B, Q, L) batch with per-video ctx_l equals row-by-row calls."""
    stride, l_pad, ctx = 45, 500, [30, 450, 500]
    fs = rng.normal(size=(3, 4, l_pad)).astype(np.float32)
    max_w = twin.num_windows(l_pad, stride)
    got_s, got_v = twin.window_scores_from_frame_scores(
        _t(fs), torch.tensor(ctx)[:, None], stride, max_w)
    for b in range(3):
        for q in range(4):
            s, v = twin.window_scores_from_frame_scores(_t(fs[b, q]), ctx[b], stride, max_w)
            np.testing.assert_array_equal(got_s[b, q].numpy(), s.numpy())
            np.testing.assert_array_equal(got_v[b, q].numpy(), v.numpy())


@pytest.mark.parametrize("ctx_l,stride", CTX_STRIDE)
def test_slice_windows(rng, ctx_l, stride):
    l_pad, d, max_v_l = ctx_l + 20, 6, 2 * stride
    feats = np.zeros((l_pad, d), np.float32)
    feats[:ctx_l] = rng.normal(size=(ctx_l, d))
    idx = np.array([0, 1, twin.num_windows(ctx_l, stride) - 1, 2, 0], np.int64)
    idx = np.minimum(idx, twin.num_windows(ctx_l, stride) - 1)
    got = twin.slice_windows(_t(feats), _t(idx), stride, max_v_l, ctx_l)
    want = jwin.slice_windows(jnp.asarray(feats), jnp.asarray(idx), stride, max_v_l, ctx_l)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_slice_windows_video_batch_equals_per_video(rng):
    stride, l_pad, d = 10, 64, 5
    feats = rng.normal(size=(2, l_pad, d)).astype(np.float32)
    ctx = np.array([64, 37])
    idx = rng.integers(0, 5, (2, 3, 4))
    got = twin.slice_windows(_t(feats), _t(idx), stride, 2 * stride, _t(ctx))
    for b in range(2):
        for j in range(3):
            one = twin.slice_windows(_t(feats[b]), _t(idx[b, j]), stride, 2 * stride, int(ctx[b]))
            for g, w in zip(got, one):
                np.testing.assert_array_equal(g[b, j].numpy(), w.numpy())


def _adapt_np(x):
    return x * 1.5 + 0.1


def test_masked_segment_mean_and_proposal_pool(rng):
    b, l, d, k = 3, 20, 8, 5
    feats = rng.normal(size=(b, l, d)).astype(np.float32)
    start = rng.integers(0, l, (b, k))
    end = start + rng.integers(-2, 8, (b, k))  # includes empty segments
    _close(tpool.masked_segment_mean(_t(feats), _t(start), _t(end)),
           jpool.masked_segment_mean(jnp.asarray(feats), jnp.asarray(start), jnp.asarray(end)))
    mask = np.zeros((b, l), np.float32)
    for i, n in enumerate([20, 13, 1]):
        mask[i, :n] = 1
    spans = rng.uniform(0, 1, (b, k, 2)).astype(np.float32)
    _close(tpool.proposal_mean_pool(_t(feats), _t(mask), _t(spans)),
           jpool.proposal_mean_pool(jnp.asarray(feats), jnp.asarray(mask), jnp.asarray(spans)))


def test_matching_scores(rng):
    b, k, d, l = 4, 5, 8, 12
    cls = rng.normal(size=(b, d)).astype(np.float32)
    pooled = rng.normal(size=(b, k, d)).astype(np.float32)
    pooled[0, 0] = 0  # an empty proposal: the safe normalize scores it 0
    got = tpool.matching_scores_pred(_adapt_np, _t(cls), _t(pooled))
    want = jpool.matching_scores_pred(_adapt_np, jnp.asarray(cls), jnp.asarray(pooled))
    _close(got, want)
    feats = rng.normal(size=(b, l, d)).astype(np.float32)
    st, ed = np.array([0, 2, 5, 1]), np.array([3, 9, 12, 2])
    _close(tpool.matching_sim_gt(_adapt_np, _t(cls), _t(feats), _t(st), _t(ed)),
           jpool.matching_sim_gt(_adapt_np, jnp.asarray(cls), jnp.asarray(feats),
                                 jnp.asarray(st), jnp.asarray(ed)))


@pytest.mark.parametrize("hull", [True, False])
@pytest.mark.parametrize("n,k", [(1, 5), (12, 5), (40, 10)])
def test_temporal_nms_host_matches(rng, n, k, hull):
    preds = [[float(s), float(e), float(sc)] for (s, e), sc in
             zip(_spans(rng, n), rng.uniform(0, 1, n))]
    assert (tnms.temporal_nms_host(preds, 0.5, k, hull_union=hull)
            == jnms.temporal_nms_host(preds, 0.5, k, hull_union=hull))


def test_dedup_spans_device_matches(rng):
    spans = np.round(rng.integers(0, 6, (3, 40, 2)).astype(np.float32), 4)
    s1, s2 = (rng.normal(size=(3, 40)).astype(np.float32) for _ in range(2))
    valid = rng.random((3, 40)) > 0.2
    (g1, g2), gk = tnms.dedup_spans_device(_t(spans), (_t(s1), _t(s2)), _t(valid))
    (w1, w2), wk = jnms.dedup_spans_device(jnp.asarray(spans), (jnp.asarray(s1), jnp.asarray(s2)),
                                           jnp.asarray(valid))
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(g1.numpy(), np.asarray(w1))
    np.testing.assert_array_equal(g2.numpy(), np.asarray(w2))


@pytest.mark.parametrize("nms_thd", [0.5, 0.3, -1])
@pytest.mark.parametrize("hull", [True, False])
@pytest.mark.parametrize("max_before", [None, 7])
@pytest.mark.parametrize("scale", [1.0, 50.0])
def test_temporal_nms_device_matches(rng, nms_thd, hull, max_before, scale):
    """Batched (3, Q, P) like the fused path's three stacked modalities,
    with invalid slots, score ties, the nms_thd == -1 sentinel and
    MAD-magnitude spans (scale 50 -> thousands of seconds)."""
    p, k = 30, 5
    spans = np.round(_spans(rng, 3 * 4 * p, scale).reshape(3, 4, p, 2), 4)
    scores = np.round(rng.uniform(0, 1, (3, 4, p)), 2).astype(np.float32)  # ties
    valid = rng.random((3, 4, p)) > 0.25
    valid[0, 0] = False  # a row with no candidate at all
    got = tnms.temporal_nms_device(_t(spans), _t(scores), _t(valid), nms_thd, k,
                                   hull_union=hull, max_before_nms=max_before)
    want = jnms.temporal_nms_device(jnp.asarray(spans), jnp.asarray(scores),
                                    jnp.asarray(valid), nms_thd, k, hull_union=hull,
                                    max_before_nms=max_before)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
