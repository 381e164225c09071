"""The port's CUDA kernels on the card, each against its plain PyTorch
version. Marked `cuda`: without a card every test here skips. The file
imports neither jax nor cone_tpu, so it runs on a machine with PyTorch
alone, without the JAX-side conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from cone_tpu_torch.ops import coarse as co

pytestmark = pytest.mark.cuda

REL_TOL = 1e-5  # fp32 dot products summed in another order than the matmul


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(card, b, q, l_pad, d, seed=0):
    rng = np.random.default_rng(seed)
    feats = torch.from_numpy(rng.normal(size=(b, l_pad, d)).astype(np.float32)).to(card)
    cls = torch.from_numpy(rng.normal(size=(b, q, d)).astype(np.float32)).to(card)
    return feats, cls


@pytest.mark.parametrize("ctx,q,d,stride", [
    ([333], 8, 64, 45),            # tests/test_pallas_coarse.py cases
    ([900], 32, 64, 45),
    ([496], 32, 512, 62),          # MAD width and stride, 64 KB of staged queries
    ([7, 90, 45], 5, 16, 45),      # ctx_l < stride, exact multiples, full length
    ([89], 40, 128, 45),           # Q above one warp, ragged tail
])
def test_coarse_kernel_matches_plain(card, ctx, q, d, stride):
    l_pad = max(ctx) + 2 * stride + 1  # not a multiple of the stride
    feats, cls = _inputs(card, len(ctx), q, l_pad, d)
    ctx_t = torch.tensor(ctx, dtype=torch.int32, device=card)
    before = co.coarse_segment_max.launches
    got = co.coarse_segment_max(feats, cls, ctx_t, stride)
    torch.cuda.synchronize()
    assert co.coarse_segment_max.launches == before + 1
    want = co.coarse_segment_max_plain(feats, cls, ctx_t, stride)
    assert got.shape == want.shape == (len(ctx), q, -(-l_pad // stride))
    valid = (torch.arange(got.shape[-1], device=card)[None]
             < (ctx_t[:, None] + stride - 1) // stride)[:, None].expand_as(got)
    torch.testing.assert_close(got[valid], want[valid], rtol=REL_TOL,
                               atol=REL_TOL * want[valid].abs().max().item())
    assert (got[~valid] <= co.NEG_INF / 2).all()


@pytest.mark.parametrize("bad", ["d_not_mult_4", "too_many_queries", "not_contiguous"])
def test_coarse_kernel_raises_instead_of_falling_back(card, bad):
    q, d = (129, 64) if bad == "too_many_queries" else (8, 62 if bad == "d_not_mult_4" else 64)
    feats, cls = _inputs(card, 1, q, 200, d)
    if bad == "not_contiguous":
        feats = feats.transpose(1, 2).contiguous().transpose(1, 2)
    before = co.coarse_segment_max.launches
    with pytest.raises(ValueError):
        co.coarse_segment_max(feats, cls, torch.tensor([150], dtype=torch.int32, device=card), 45)
    assert co.coarse_segment_max.launches == before
