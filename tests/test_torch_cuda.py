"""The port's CUDA kernels (coarse segment max, masked attention) on the
card, each against its plain PyTorch version, the training step on the
card (against the same step on the CPU, and the reference's golden
trajectories; a multiscale step too, and two multiscale gloo ranks on the
card against one process; a bfloat16 forward and step), the
native .cfs reader built on the
card's host, the 2D-TAN model's float32 guarantee and tie order on
the card, and the feature towers (CLIP, EgoVLP) at full width on the card
against the CPU, with the golden EgoVLP tower, and utils/perf.py's fused
device time and MFU. Marked `cuda`: without a card every test here skips. The file
imports neither jax nor cone_tpu, so it runs on a machine with PyTorch
alone, without the JAX-side conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q
"""

import copy

import numpy as np
import pytest
import torch

from cone_tpu_torch.ops import attention as at
from cone_tpu_torch.ops import coarse as co
from cone_tpu_torch.tools import bench_attn, golden_tan_train, golden_train

pytestmark = pytest.mark.cuda

REL_TOL = 1e-5  # fp32 dot products summed in another order than the matmul
# a multiscale step's weight change per leaf, card vs CPU, relative in norm:
# a card that skipped the update reads 1
MULTISCALE_DW_RTOL = 0.1


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
    _coarse_against_plain(card, ctx, q, d, stride, l_pad)


def _coarse_against_plain(card, ctx, q, d, stride, l_pad, segs_per_block=None):
    feats, cls = _inputs(card, len(ctx), q, l_pad, d)
    ctx_t = torch.tensor(ctx, dtype=torch.int32, device=card)
    before = co.coarse_segment_max.launches
    got = co.coarse_segment_max(feats, cls, ctx_t, stride, segs_per_block)
    torch.cuda.synchronize()
    assert co.coarse_segment_max.launches == before + 1
    want = co.coarse_segment_max_plain(feats, cls, ctx_t, stride)
    assert got.shape == want.shape == (len(ctx), q, -(-l_pad // stride))
    valid = (torch.arange(got.shape[-1], device=card)[None]
             < (ctx_t[:, None] + stride - 1) // stride)[:, None].expand_as(got)
    torch.testing.assert_close(got[valid], want[valid], rtol=REL_TOL,
                               atol=REL_TOL * want[valid].abs().max().item())
    assert (got[~valid] <= co.NEG_INF / 2).all()


@pytest.mark.parametrize("ctx,q,d,stride,l_pad,spb", [
    ([2243], 32, 256, 45, 2304, None),     # Ego4D: one segment per block
    ([36000], 32, 512, 62, 36864, None),   # MAD: the plan's runs of segments
    ([700], 32, 64, 45, 720, 3),           # segments straddle the 16-frame tiles of a run
    ([8 * 45 - 20], 32, 64, 45, 720, 4),   # a block's run ends at ctx_l, mid-segment
    ([8 * 45], 32, 64, 45, 720, 4),        # ... and exactly at its last frame
    ([700], 32, 64, 45, 720, 5),           # n_seg 16 is no multiple of the run
    ([700], 32, 64, 45, 720, 16),          # the whole video in one block
    ([500, 90, 1], 5, 64, 45, 520, 2),     # Q 5: one ragged query tile
    ([500], 40, 64, 45, 520, 4),           # Q 40, a long run: the instance of eight query tiles
    ([500], 40, 64, 45, 520, 1),           # ... a short one: its queries spread over the warps
    ([500], 100, 64, 62, 520, 3),          # Q 100: sixteen per item, the last tiles ragged
    ([300], 128, 128, 62, 330, 2),         # Q 128: the limit
    ([1500, 707, 62], 32, 512, 62, 1600, 4),   # B 3 with unequal ctx_l at D 512
    ([300], 16, 64, 7, 330, 9),            # a stride below 16: several segments per tile
    ([100], 8, 64, 1, 120, 50),            # stride 1
    ([300], 32, 100, 45, 330, 2),          # D no multiple of the 32-column tile
    ([300], 8, 16, 45, 330, 1),            # D below one tile
    ([0, 300], 8, 64, 45, 330, 2),         # a video with no valid frame
])
def test_coarse_kernel_seams(card, ctx, q, d, stride, l_pad, spb):
    _coarse_against_plain(card, ctx, q, d, stride, l_pad, spb)


@pytest.mark.parametrize("bad", ["d_not_mult_4", "too_many_queries", "not_contiguous",
                                 "run_too_long", "run_zero", "smem"])
def test_coarse_kernel_raises_instead_of_falling_back(card, bad):
    q, d = (129, 64) if bad == "too_many_queries" else (8, 62 if bad == "d_not_mult_4" else 64)
    if bad == "smem":
        q, d = 128, 512      # 128 x 516 floats of queries alone exceed a block's 227 KB
    feats, cls = _inputs(card, 1, q, 200, d)
    if bad == "not_contiguous":
        feats = feats.transpose(1, 2).contiguous().transpose(1, 2)
    spb = {"run_too_long": 6, "run_zero": 0}.get(bad)   # n_seg is 5
    before = co.coarse_segment_max.launches
    with pytest.raises(ValueError):
        co.coarse_segment_max(feats, cls, torch.tensor([150], dtype=torch.int32, device=card),
                              45, spb)
    assert co.coarse_segment_max.launches == before


# ---------------------------------------------------------------- attention

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,lq,lk,d,h", [
    (640, 110, 110, 256, 8),   # the fine stage's serving shape
    (16, 5, 110, 256, 8),      # the decoder's cross-attention: Lq != Lk
    (3, 110, 110, 128, 8),     # head width 16, B a multiple of nothing
    (3, 37, 70, 256, 4),       # head width 64
    (2, 1, 1, 64, 2),          # L 1
    (2, 9, 128, 512, 4),       # head width 128, eight key tiles: float32's limit there
    (2, 300, 256, 256, 8),     # three query chunks of 128 rows, the key limit
    (2, 130, 40, 48, 3),       # head width 48: a 32-column step and a 16-column half
])
def test_attention_kernel_matches_plain(card, dtype, b, lq, lk, d, h):
    q, k, v, mask = bench_attn.make_inputs(b, lq, lk, d, dtype, card, seed=1)
    before = at.masked_attention.launches
    err, tol, got = bench_attn.compare(q, k, v, mask, h)
    assert at.masked_attention.launches == before + 1
    assert got.shape == (b, lq, d) and got.dtype == dtype and err <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("l", [15, 16, 17, 111, 112, 113, 256])
def test_attention_kernel_tile_seams(card, dtype, hd, l):
    # Lq and Lk on either side of the 16-row tiles, at every head width; two
    # heads, so that head groups of one and of several heads both occur
    if at.smem_bytes(l, l, hd, 2, 4 if dtype == torch.float32 else 2) > at.MAX_SMEM_BYTES:
        with pytest.raises(ValueError):   # float32, more than 128 keys of width 128
            at.masked_attention(*bench_attn.make_inputs(2, l, l, 2 * hd, dtype, card), 2)
        return
    for lq, lk in ((l, l), (l, 110), (110, l)):
        q, k, v, mask = bench_attn.make_inputs(3, lq, lk, 2 * hd, dtype, card, seed=l,
                                               min_len=1)
        mask[2] = True    # a fully masked window among the others
        err, tol, got = bench_attn.compare(q, k, v, mask, 2)
        assert got.shape == (3, lq, 2 * hd) and err <= tol
        want = v[2].float().mean(0).expand(lq, 2 * hd)
        torch.testing.assert_close(got[2].float(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["fully_masked_row", "nothing_masked", "no_mask"])
def test_attention_kernel_mask_edges(card, dtype, case):
    q, k, v, mask = bench_attn.make_inputs(4, 110, 110, 256, dtype, card, seed=2)
    if case == "fully_masked_row":
        mask[1] = True            # every key of window 1 is padding
    elif case == "nothing_masked":
        mask[:] = False
    else:
        mask = None
    err, tol, got = bench_attn.compare(q, k, v, mask, 8)
    assert torch.isfinite(got).all() and err <= tol
    if case == "fully_masked_row":
        # uniform weights: every query row of the window is the mean of v
        want = v[1].float().mean(0).expand(110, 256)
        torch.testing.assert_close(got[1].float(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("bad", ["keys", "head_dim", "head_dim_multiple", "smem",
                                 "not_contiguous", "misaligned", "mixed_dtype", "float16",
                                 "heads", "mask_dtype"])
def test_attention_kernel_raises_instead_of_falling_back(card, bad):
    b, lq, lk, d, h, dtype = 2, 8, 8, 64, 4, torch.float32
    if bad == "keys":
        lk = at.MAX_KEYS + 1
    elif bad == "head_dim":
        d, h = 512, 2
    elif bad == "head_dim_multiple":
        d, h = 96, 4               # head width 24
    elif bad == "smem":
        lk, d, h = 129, 512, 4     # 2 * 256 staged key rows of 528 bytes > 227 KB
    elif bad == "heads":
        h = 5
    elif bad == "float16":
        dtype = torch.float16
    q, k, v, mask = bench_attn.make_inputs(b, lq, lk, d, torch.float32, card)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    if bad == "not_contiguous":
        k = k.transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "misaligned":
        k = torch.cat([k.flatten(), k.new_zeros(1)])[1:].view(k.shape)   # 4 bytes off
    elif bad == "mixed_dtype":
        v = v.to(torch.bfloat16)
    elif bad == "mask_dtype":
        mask = mask.to(torch.uint8)
    before = at.masked_attention.launches
    with pytest.raises((ValueError, TypeError)):
        at.masked_attention(q, k, v, mask, h)
    assert at.masked_attention.launches == before


def test_golden_train_trajectory_on_the_card(card):
    """tests/golden/train_trajectory.npz replayed on the card within
    tests/test_train_parity.py's limits (golden_train.LIMITS)."""
    worst = golden_train.check(device="cuda")
    print(f"golden trajectory on the card, worst errors: {worst}")


def test_train_step_on_the_card_equals_the_cpu(card):
    """One step of the matcher, the criterion and the AdamW update at a
    narrow width, on the card and on the CPU from the same weights and
    batch: equal assignments, losses and grad norm within 1e-4 relative,
    weights within lr absolute (Adam's division by sqrt(v) can turn an
    ULP-level gradient difference into an update difference of up to lr)."""
    from cone_tpu_torch.config import ConeConfig, DataConfig, ModelConfig, TrainConfig
    from cone_tpu_torch.data import TrainLoader, make_synthetic_dataset
    from cone_tpu_torch.models import losses
    from cone_tpu_torch.train.loop import build_family
    from cone_tpu_torch.train.optim import make_optimizer
    from cone_tpu_torch.train.step import batch_to_device, make_train_step, to_floats

    cfg = ConeConfig(
        model=ModelConfig(hidden_dim=64, nheads=4, dim_feedforward=128, t_feat_dim=32,
                          v_motion_feat_dim=32, v_appear_feat_dim=32, max_q_l=8, max_v_l=32,
                          dropout=0.0, input_dropout=0.0),
        data=DataConfig(max_v_l=32, max_q_l=8, clip_length=1.0, max_windows=5),
        train=TrainConfig(lr=1e-4))
    ds = make_synthetic_dataset(cfg.data, n_videos=4, queries_per_video=4,
                                ctx_l_range=(100, 200), dim=32, seed=2)
    batch = next(TrainLoader(ds, bsz=16, seed=0).epoch(0))
    base = build_family(cfg, seed=0, device="cpu")
    got = {}
    for dev in ("cpu", "cuda"):
        model = copy.deepcopy(base).to(dev)
        b = batch_to_device(batch, dev)
        with torch.no_grad():
            out = model(b["query_tokens"], b["query_mask"], b["pos_motion"], b["pos_mask"])
            assign = [losses._match_layer(o, b["span_labels"], b["span_mask"], cfg.loss)
                      for o in [out] + out["aux_outputs"]]
        opt, sched = make_optimizer(model, cfg.train, steps_per_epoch=1)
        metrics = to_floats(make_train_step(model, opt, sched, cfg)(batch, True))
        got[dev] = ([a.cpu() for a in assign], metrics,
                    {k: v.cpu() for k, v in model.state_dict().items()})
    (a_cpu, m_cpu, w_cpu), (a_gpu, m_gpu, w_gpu) = got["cpu"], got["cuda"]
    for x, y in zip(a_cpu, a_gpu):
        assert torch.equal(x, y)
    for k, v in m_cpu.items():
        assert abs(m_gpu[k] - v) <= 1e-4 * max(1.0, abs(v)), (k, m_gpu[k], v)
    for k, v in w_cpu.items():
        assert float((w_gpu[k] - v).abs().max()) <= cfg.train.lr, k


def test_multiscale_step_on_the_card_equals_the_cpu(card):
    """One multiscale step (4B motion rows of 2 * max_v_l, B appearance
    rows, the adapter on) at a narrow width, on the card and on the CPU
    from the same weights and batch: losses and grad norm within the limits
    of the test above; each leaf's weight change within MULTISCALE_DW_RTOL
    of the CPU's in norm (a card that skipped the update reads 1), where
    the leaf's gradient is above float32 rounding."""
    from cone_tpu_torch.config import ConeConfig, DataConfig, ModelConfig, TrainConfig
    from cone_tpu_torch.data import make_synthetic_dataset
    from cone_tpu_torch.data.multiscale import MultiscaleTrainLoader
    from cone_tpu_torch.train.loop import build_family
    from cone_tpu_torch.train.optim import make_optimizer
    from cone_tpu_torch.train.step import make_train_step, to_floats

    cfg = ConeConfig(
        model=ModelConfig(hidden_dim=64, nheads=4, dim_feedforward=128, t_feat_dim=32,
                          v_motion_feat_dim=32, v_appear_feat_dim=32, max_q_l=8, max_v_l=32,
                          dropout=0.0, input_dropout=0.0),
        data=DataConfig(max_v_l=32, max_q_l=8, clip_length=1.0, max_windows=5),
        train=TrainConfig(lr=1e-4, multiscale=True))
    ds = make_synthetic_dataset(cfg.data, n_videos=4, queries_per_video=4,
                                ctx_l_range=(40, 200), dim=32, seed=2)
    batch = next(MultiscaleTrainLoader(ds, bsz=8, seed=0).epoch(0))
    assert batch["pos_motion"].shape == (32, 64, 32) and batch["pos_appear"].shape[0] == 8
    base = build_family(cfg, seed=0, device="cpu")
    w0 = {k: v.detach().double() for k, v in base.named_parameters()}
    got = {}
    for dev in ("cpu", "cuda"):
        model = copy.deepcopy(base).to(dev)
        opt, sched = make_optimizer(model, cfg.train, steps_per_epoch=1)
        metrics = to_floats(make_train_step(model, opt, sched, cfg)(batch, True))
        got[dev] = (metrics, {k: v.detach().cpu().double() - w0[k]
                              for k, v in model.named_parameters()},
                    {k: v.grad.norm().item() for k, v in model.named_parameters()
                     if v.grad is not None})
    (m_cpu, dw_cpu, g_cpu), (m_gpu, dw_gpu, _) = got["cpu"], got["cuda"]
    assert "loss_adapter" in m_cpu
    for k, v in m_cpu.items():
        assert abs(m_gpu[k] - v) <= 1e-4 * max(1.0, abs(v)), (k, m_gpu[k], v)
    # not held: a leaf whose gradient is float32 rounding (chip_smoke.py's
    # DATA_GRAD_FLOOR), where Adam turns noise into a step of up to lr
    g_all = sum(g * g for g in g_cpu.values()) ** 0.5
    compared = [k for k, d in dw_cpu.items()
                if d.norm() > 0 and g_cpu.get(k, 0.0) >= 1e-6 * g_all]
    assert len(compared) > len(dw_cpu) // 2
    for k in compared:
        err = float((dw_gpu[k] - dw_cpu[k]).norm() / dw_cpu[k].norm())
        assert err <= MULTISCALE_DW_RTOL, (k, err)


# bfloat16 compute (model.compute_dtype), card vs CPU: chip_smoke.py's limits
BF16_FWD_RTOL = 2.0 ** -7   # each forward output, relative in norm: two bf16 steps
BF16_RTOL = 3e-3            # losses, terms, grad norm, relative to max(1, |v|)
BF16_DW_RTOL = 0.3          # the weight change of all leaves together: a skipped update reads 1


def _bf16_cfg():
    from cone_tpu_torch.config import ConeConfig, DataConfig, ModelConfig, TrainConfig

    return ConeConfig(
        model=ModelConfig(hidden_dim=64, nheads=2, dim_feedforward=128, t_feat_dim=32,
                          v_motion_feat_dim=32, v_appear_feat_dim=32, max_q_l=8, max_v_l=32,
                          dropout=0.0, input_dropout=0.0, compute_dtype="bfloat16"),
        data=DataConfig(max_v_l=32, max_q_l=8, clip_length=1.0, max_windows=5),
        train=TrainConfig(lr=1e-4))


def test_bf16_forward_on_the_card_equals_the_cpu(card):
    """One bfloat16 forward (2 heads) of 16 windows on the card and on the
    CPU from the same weights: float32 outputs, each within BF16_FWD_RTOL
    relative in norm (cuBLAS sums in another order, which flips a bfloat16
    rounding now and then)."""
    from cone_tpu_torch.train.loop import build_family

    cfg = _bf16_cfg()
    base = build_family(cfg, seed=0, device="cpu").eval()
    rng = np.random.default_rng(4)
    m = cfg.model
    x = [rng.normal(size=(16, m.max_q_l, m.t_feat_dim)),
         np.arange(m.max_q_l)[None] < rng.integers(2, m.max_q_l + 1, 16)[:, None],
         rng.normal(size=(16, m.max_v_l, m.v_motion_feat_dim)),
         np.arange(m.max_v_l)[None] < rng.integers(8, m.max_v_l + 1, 16)[:, None]]
    x = [torch.from_numpy(np.asarray(a, np.float32)) for a in x]
    with torch.no_grad():
        want = base(*x)
        got = copy.deepcopy(base).to(card)(*(a.to(card) for a in x))
    for k in ("pred_logits", "pred_spans", "saliency_scores"):
        assert got[k].dtype == torch.float32, k
        err = float((got[k].cpu().double() - want[k].double()).norm() / want[k].double().norm())
        assert err <= BF16_FWD_RTOL, (k, err)


def test_bf16_train_step_on_the_card_equals_the_cpu(card):
    """One bfloat16 train step at dropout 0, adapter on, on the card and on
    the CPU from the same weights and batch: losses, terms and grad norm
    within BF16_RTOL (class_error, an argmax count, is not held), the
    weight change of all leaves within BF16_DW_RTOL in norm, every
    gradient and parameter float32."""
    from cone_tpu_torch.data import TrainLoader, make_synthetic_dataset
    from cone_tpu_torch.train.loop import build_family
    from cone_tpu_torch.train.optim import make_optimizer
    from cone_tpu_torch.train.step import make_train_step, to_floats

    cfg = _bf16_cfg()
    ds = make_synthetic_dataset(cfg.data, n_videos=4, queries_per_video=4,
                                ctx_l_range=(100, 200), dim=32, seed=2)
    batch = next(TrainLoader(ds, bsz=16, seed=0).epoch(0))
    base = build_family(cfg, seed=0, device="cpu")
    w0 = {k: v.detach().double() for k, v in base.named_parameters()}
    got = {}
    for dev in ("cpu", "cuda"):
        model = copy.deepcopy(base).to(dev)
        opt, sched = make_optimizer(model, cfg.train, steps_per_epoch=1)
        metrics = to_floats(make_train_step(model, opt, sched, cfg)(batch, True))
        assert all(p.dtype == torch.float32 and (p.grad is None or p.grad.dtype == torch.float32)
                   for p in model.parameters())
        got[dev] = (metrics, {k: v.detach().cpu().double() - w0[k]
                              for k, v in model.named_parameters()})
    (m_cpu, dw_cpu), (m_gpu, dw_gpu) = got["cpu"], got["cuda"]
    for k, v in m_cpu.items():   # class_error moves in steps of 100 / bsz: not a loss
        if not k.startswith("class_error"):
            assert abs(m_gpu[k] - v) <= BF16_RTOL * max(1.0, abs(v)), (k, m_gpu[k], v)
    err = float(torch.cat([(dw_gpu[k] - d).flatten() for k, d in dw_cpu.items()]).norm()
                / torch.cat([d.flatten() for d in dw_cpu.values()]).norm())
    assert err <= BF16_DW_RTOL, err


@pytest.mark.parametrize("dtype", [np.float32, np.float16], ids=["f32", "f16"])
def test_native_reader_on_the_cards_host(card, tmp_path, dtype):
    """The native .cfs reader built with g++ on the card's machine: get and
    read_batch equal to the pure-numpy reader, exactly."""
    from cone_tpu_torch.data.native_store import NativePackedStore
    from cone_tpu_torch.data.store import PackedArrayStore, write_packed_store

    rng = np.random.default_rng(0)
    items = {f"v{i}": rng.normal(size=(int(rng.integers(1, 300)), 256)).astype(dtype)
             for i in range(40)}
    write_packed_store(str(tmp_path / "f.cfs"), items)
    native, plain = NativePackedStore(str(tmp_path / "f.cfs")), PackedArrayStore(
        str(tmp_path / "f.cfs"))
    for k, v in items.items():
        got = native.get(k)
        assert got.dtype == v.dtype and np.array_equal(got, v) and np.array_equal(got, plain.get(k))
    keys = list(items)[::3] + ["missing"]
    for (a, la), (b, lb) in [(native.read_batch(keys, 180), plain.read_batch(keys, 180))]:
        assert np.array_equal(a, b) and np.array_equal(la, lb) and la[-1] == 0


@pytest.mark.parametrize("ctx,q,d,stride,l_pad,spb", [
    ([2241], 8, 256, 32, 2304, None),      # Ego4D-TAN: a block per 32-frame segment
    ([2241], 32, 256, 32, 2304, None),
    ([2304, 2240], 32, 256, 32, 2304, None),  # video batch; ctx_l on a segment edge
    ([36000], 32, 512, 64, 36864, None),   # TAN-MAD: runs of 5 segments = 20 tiles
    ([64 * 7], 32, 512, 64, 1024, 7),      # a run ends at ctx_l, on a tile edge
    ([64 * 7 - 16], 32, 512, 64, 1024, 3),  # ... one tile short of a segment edge
    ([64, 31], 8, 64, 32, 64, 1),          # the whole video is two segments
])
def test_coarse_kernel_at_the_tan_strides(card, ctx, q, d, stride, l_pad, spb):
    """Strides 32 and 64 are multiples of the kernel's 16-frame tiles, so
    every segment ends on a tile edge and a block's run is whole tiles."""
    _coarse_against_plain(card, ctx, q, d, stride, l_pad, spb)


def test_tan_forward_is_float32_on_the_card_whatever_the_tf32_flags(card):
    """The TAN head's 9x9 convs and LSTM at 128 channels on a 64x64 map,
    with cuDNN's and cuBLAS's TF32 switched ON before the model is built:
    building it on the card resolves the device, which switches both off,
    and the forward lies within 2e-4 of the CPU. The same forward with TF32
    forced back on is printed beside it."""
    from cone_tpu_torch.config import TanConfig
    from cone_tpu_torch.convert import load_reference_tan_state_dict, random_reference_tan_state_dict
    from cone_tpu_torch.models.tan import ConeTanModel

    cfg = TanConfig(hidden_size=128, txt_hidden_size=128, map_hidden_sizes=(128,) * 4)
    sd = load_reference_tan_state_dict(random_reference_tan_state_dict(cfg, seed=0))
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.normal(size=(2, 12, cfg.t_feat_dim)).astype(np.float32))
    mask = torch.ones(2, 12)
    mask[1, 7:] = 0
    vis = torch.from_numpy(rng.normal(size=(2, 64, cfg.v_feat_dim)).astype(np.float32))
    vis = vis / vis.norm(dim=-1, keepdim=True)
    cpu = ConeTanModel(cfg, device="cpu")
    cpu.load_state_dict(sd)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        gpu = ConeTanModel(cfg, device="cuda")
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
        gpu.load_state_dict(sd)
        with torch.no_grad():
            want, _ = cpu(tok, mask, vis)
            inputs = (tok.cuda(), mask.cuda(), vis.cuda())
            got, _ = gpu(*inputs)
            torch.backends.cudnn.allow_tf32 = True
            torch.backends.cuda.matmul.allow_tf32 = True
            tf32, _ = gpu(*inputs)
            torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    assert float(want.std()) > 0.05   # a map with spread, not the prediction bias
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=2e-4)
    print(f"TAN forward vs the CPU: float32 {float((got.cpu() - want).abs().max()):.2e}, "
          f"TF32 {float((tf32.cpu() - want).abs().max()):.2e}")


def test_tan_tie_order_on_the_card(card):
    """top_k_ref_order: equal scores rank the highest flat cell first on the
    card too, where torch.topk promises no order among ties."""
    from cone_tpu_torch.eval.tan_pipeline import top_k_ref_order

    rng = np.random.default_rng(1)
    x = rng.integers(0, 4, size=(160, 4096)).astype(np.float32) / 4   # ties everywhere
    vals, idx = top_k_ref_order(torch.from_numpy(x).cuda(), 128)
    ref = np.argsort(x, axis=-1, kind="stable")[:, ::-1][:, :128]
    np.testing.assert_array_equal(idx.cpu().numpy(), ref)
    np.testing.assert_array_equal(vals.cpu().numpy(), np.take_along_axis(x, ref, -1))


def test_golden_tan_train_trajectory_on_the_card(card):
    """tests/golden/tan_train_trajectory.npz replayed on the card within
    tests/test_tan_train_parity.py's limits and the update limit
    (golden_tan_train.LIMITS)."""
    worst = golden_tan_train.check(device="cuda")
    print(f"golden TAN trajectory on the card, worst errors: {worst}")


def _narrow_step_setup():
    from cone_tpu_torch.config import ConeConfig, DataConfig, ModelConfig, TrainConfig
    from cone_tpu_torch.data import TrainLoader, make_synthetic_dataset

    cfg = ConeConfig(
        model=ModelConfig(hidden_dim=64, nheads=4, dim_feedforward=128, t_feat_dim=32,
                          v_motion_feat_dim=32, v_appear_feat_dim=32, max_q_l=8, max_v_l=32,
                          dropout=0.0, input_dropout=0.0),
        data=DataConfig(max_v_l=32, max_q_l=8, clip_length=1.0, max_windows=5),
        train=TrainConfig(lr=1e-4))
    ds = make_synthetic_dataset(cfg.data, n_videos=4, queries_per_video=4,
                                ctx_l_range=(100, 200), dim=32, seed=2)
    return cfg, next(TrainLoader(ds, bsz=16, seed=0).epoch(0))


def test_world_one_nccl_step_equals_the_plain_step(card):
    """A group of one rank over NCCL (`train --mesh` on one card): the
    gradient all-reduce, the span-count sum and the InfoNCE gather run and
    are exact copies, so the step equals the step with no group."""
    from cone_tpu_torch.parallel import distributed
    from cone_tpu_torch.train.loop import build_family
    from cone_tpu_torch.train.optim import make_optimizer
    from cone_tpu_torch.train.step import make_train_step, to_floats

    cfg, batch = _narrow_step_setup()
    got = []
    for group in (False, True):
        if group:
            assert distributed.initialize(num_processes=1, process_id=0) == torch.device("cuda", 0)
        try:
            assert distributed.backend() == ("nccl" if group else None)
            model = build_family(cfg, seed=0, device="cuda")
            opt, sched = make_optimizer(model, cfg.train, steps_per_epoch=1)
            step = make_train_step(model, opt, sched, cfg, distributed.batch_reduce())
            metrics = [to_floats(step(batch, True)) for _ in range(2)]
            got.append((metrics, {k: v.cpu() for k, v in model.state_dict().items()}))
        finally:
            distributed.shutdown()
    (m0, w0), (m1, w1) = got
    assert m0 == m1
    for k, v in w0.items():
        assert torch.equal(w1[k], v), k


def test_two_gloo_ranks_share_the_card_and_agree(card, tmp_path):
    """Two ranks on cuda:0 (NCCL refuses two ranks on one device, so the
    group is gloo): the narrow data-parallel run of
    cone_tpu_torch/tools/dist_worker.py, both ranks equal, each rank's
    coarse kernel launched once per dispatch of its videos."""
    import json
    import os
    import socket
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = str(tmp_path / "out")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "cone_tpu_torch.tools.dist_worker", "--out", out, "--width",
         "narrow", "--device", "cuda", "--coordinator", f"127.0.0.1:{port}",
         "--num_processes", "2", "--process_id", str(i), "--timeout_s", "120"],
        cwd=repo, env=dict(os.environ, PYTHONPATH=repo), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(2)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    a, b = (json.load(open(f"{out}.{i}.json")) for i in range(2))
    assert a["backend"] == b["backend"] == "gloo" and a["device"] == b["device"] == "cuda:0"
    for k in ("losses", "grad_norms", "terms", "param_sum", "rows", "ranklists",
              "corpus_hits", "tan"):
        assert a[k] == b[k], k
    for r in (a, b):
        assert r["dispatches"] > 0 and r["eval_launches"] == r["train_launches"] == r["dispatches"]


def _tp_ranks(repo, out, argv, world=2):
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "cone_tpu_torch.tools.dist_worker", "--out", out, "--width",
         "narrow", "--device", "cuda", "--coordinator", f"127.0.0.1:{port}",
         "--num_processes", str(world), "--process_id", str(i), "--timeout_s", "120"] + argv,
        cwd=repo, env=dict(os.environ, PYTHONPATH=repo), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(world)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]


@pytest.mark.parametrize("world", [2, 4], ids=["dp1_tp2", "dp2_tp2"])
def test_tp_gloo_ranks_on_the_card_equal_one_process(card, tmp_path, world):
    """Tensor parallel on cuda:0: the narrow width's 3 train steps
    (cone_tpu_torch/tools/dist_worker.py --steps, dropouts 0.1 / 0.5) on a
    (world / 2, 2) grid of gloo ranks sharing the card, against the same
    steps in this process: every metric and the gathered weights within
    tests/test_tp.py's rtol 2e-4, atol 1e-5; the ranks' shards and AdamW
    moments the shard's shape, gathered back to the bit."""
    import dataclasses
    import json
    import os

    from cone_tpu_torch.tools import dist_worker

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg, _ = dist_worker.problem("narrow")
    cfg.replace(train=dataclasses.replace(cfg.train, tp_devices=2)).save(
        str(tmp_path / "cfg.json"))
    out = str(tmp_path / "out")
    _tp_ranks(repo, out, ["--steps", "3", "--config", str(tmp_path / "cfg.json")], world)
    single = dist_worker.train_steps("narrow", card, 3, cfg, state_path=out + ".single.pt")
    ranks = [json.load(open(f"{out}.{i}.json")) for i in range(world)]
    for r in ranks:
        assert (r["backend"], r["device"], r["tp"]) == ("gloo", "cuda:0", 2)
        assert r["roundtrip_exact"] and r["metrics"] == ranks[0]["metrics"]
        assert r["shard_shapes"]["transformer.encoder.layers.0.self_attn.in_proj_weight"] == [
            96, 64]
    for got, want in zip(ranks[0]["metrics"], single["metrics"]):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=1e-5, err_msg=k)
    state = torch.load(out + ".state.pt", weights_only=True)
    for k, w in torch.load(out + ".single.pt", weights_only=True).items():
        np.testing.assert_allclose(state[k].numpy(), w.numpy(), rtol=2e-4, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("tp", [1, 2], ids=["dp2", "dp1_tp2"])
def test_multiscale_gloo_ranks_on_the_card_equal_one_process(card, tmp_path, tp):
    """train.multiscale on two gloo ranks sharing cuda:0 (data parallel: each
    rank its standard rows and their extra rows; or dp 1 x tp 2), the narrow
    width's 3 train steps at its dropouts (cone_tpu_torch/tools/dist_worker.py
    --steps), against the same steps in this process: every metric and the
    gathered weights within rtol 2e-4, atol 1e-5 (the DP and TP limits)."""
    import dataclasses
    import json
    import os

    from cone_tpu_torch.tools import dist_worker

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg, _ = dist_worker.problem("narrow")
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, multiscale=True, tp_devices=tp))
    cfg.save(str(tmp_path / "cfg.json"))
    out = str(tmp_path / "out")
    _tp_ranks(repo, out, ["--steps", "3", "--config", str(tmp_path / "cfg.json")])
    single = dist_worker.train_steps("narrow", card, 3, cfg.replace(
        train=dataclasses.replace(cfg.train, tp_devices=1)), state_path=out + ".single.pt")
    ranks = [json.load(open(f"{out}.{i}.json")) for i in range(2)]
    for r in ranks:
        assert (r["backend"], r["device"], r["tp"], r["dp"]) == ("gloo", "cuda:0", tp, 2 // tp)
        assert r["metrics"] == ranks[0]["metrics"] and "loss_adapter" in r["metrics"][0]
    for got, want in zip(ranks[0]["metrics"], single["metrics"]):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=1e-5, err_msg=k)
    state = torch.load(out + ".state.pt", weights_only=True)
    for k, w in torch.load(out + ".single.pt", weights_only=True).items():
        np.testing.assert_allclose(state[k].numpy(), w.numpy(), rtol=2e-4, atol=1e-5,
                                   err_msg=k)


TOWER_TOL = 1e-4   # card vs CPU, projected features: times max(1, largest |feature|)


def _tower_pair(card, cls, cfg, sd):
    from cone_tpu_torch.convert import load_reference_state_dict

    out = []
    for dev in (card, "cpu"):
        m = cls(cfg, device=dev)
        m.load_state_dict(load_reference_state_dict(sd))
        out.append(m.eval())
    return out


def _close_to_cpu(got, want):
    got, want = got.cpu().numpy(), want.numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOWER_TOL * max(1.0, float(np.abs(want).max())))


def test_clip_towers_on_the_card_equal_the_cpu(card):
    """ViT-B/32 and the CLIP text tower at full width, seeded HF-layout
    weights: 2 frames and 2 ragged queries at context 77."""
    from cone_tpu_torch.convert import random_clip_text_state_dict, random_clip_vision_state_dict
    from cone_tpu_torch.models.clip import (
        ClipTextConfig, ClipTextTower, ClipVisionConfig, ClipVisionTower)

    vcfg, tcfg = ClipVisionConfig(), ClipTextConfig()
    vision, vision_cpu = _tower_pair(card, ClipVisionTower, vcfg,
                                     random_clip_vision_state_dict(vcfg, 0))
    text, text_cpu = _tower_pair(card, ClipTextTower, tcfg, random_clip_text_state_dict(tcfg, 1))
    rng = np.random.default_rng(0)
    px = torch.from_numpy(rng.normal(size=(2, 3, 224, 224)).astype(np.float32))
    ids = torch.zeros(2, 77, dtype=torch.long)
    for i, n in enumerate((9, 77)):
        ids[i, 0], ids[i, n - 1] = 49406, 49407
        ids[i, 1 : n - 1] = torch.from_numpy(rng.integers(1, 49406, n - 2))
    eot = torch.tensor([8, 76])
    with torch.inference_mode():
        _close_to_cpu(vision(px.to(card)), vision_cpu(px))
        for got, want in zip(text(ids.to(card), eot.to(card)), text_cpu(ids, eot)):
            _close_to_cpu(got, want)


def test_egovlp_tower_on_the_card(card):
    """The golden fixture tests/golden/egovlp_tower.npz on the card at
    2e-4, and ViT-B/16 at full width (4 frames, seeded weights) against the
    CPU on one clip."""
    import os

    from cone_tpu_torch.convert import egovlp_state_dict, random_egovlp_state_dict
    from cone_tpu_torch.models.egovlp import EgoVlpConfig, EgoVlpVideoTower

    g = dict(np.load(os.path.join(os.path.dirname(__file__), "golden",
                                  "egovlp_tower.npz")).items())
    img, patch, dim, depth, heads, nf, proj = g["cfg"].tolist()
    gcfg = EgoVlpConfig(img_size=img, patch_size=patch, embed_dim=dim, depth=depth,
                        num_heads=heads, num_frames=nf, projection_dim=proj)
    tower = EgoVlpVideoTower(gcfg, device=card)
    tower.load_state_dict(egovlp_state_dict({k[3:]: v for k, v in g.items()
                                             if k.startswith("w::")}, gcfg))
    with torch.inference_mode():
        got = tower.eval()(torch.from_numpy(g["frames"]).to(card)).cpu().numpy()
    np.testing.assert_allclose(got, g["projected"], atol=2e-4)

    cfg = EgoVlpConfig()
    ego, ego_cpu = _tower_pair(card, EgoVlpVideoTower, cfg, random_egovlp_state_dict(cfg, 2))
    clip = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1, 4, 3, 224, 224)).astype(np.float32))
    with torch.inference_mode():
        _close_to_cpu(ego(clip.to(card)), ego_cpu(clip))


def test_device_time_fused_and_mfu_on_the_card(card):
    """utils/perf.py on the card at a narrow width (hidden 64, 64-d
    features), 2 videos x 32 queries through the coarse kernel: the CUDA
    events give a positive time a query, the kernel launches once per
    dispatch of every pass (one warm pass and `repeats` timed ones), and
    perf_report's MFU and device-memory share lie in (0, 1]."""
    from cone_tpu_torch.config import ConeConfig, DataConfig, EvalConfig, ModelConfig
    from cone_tpu_torch.convert import load_reference_state_dict, random_reference_state_dict
    from cone_tpu_torch.data import make_synthetic_dataset
    from cone_tpu_torch.eval.pipeline import InferencePipeline
    from cone_tpu_torch.models.cone import ConeModel
    from cone_tpu_torch.utils import perf

    dim = 64
    cfg = ConeConfig(
        model=ModelConfig(hidden_dim=64, nheads=4, dim_feedforward=128, t_feat_dim=dim,
                          v_motion_feat_dim=dim, v_appear_feat_dim=dim),
        data=DataConfig(dset_name="synthetic", max_ctx_l=2304),
        eval=EvalConfig(query_chunk=32, use_pallas_coarse=True))
    model = ConeModel(cfg.model, device=card)
    model.load_state_dict(load_reference_state_dict(random_reference_state_dict(cfg.model, 0)))
    ds = make_synthetic_dataset(cfg.data, n_videos=2, queries_per_video=32,
                                ctx_l_range=(2000, 2300), dim=dim, seed=0)
    pipe = InferencePipeline(model, ds, cfg, device=card)
    repeats = 3
    co.coarse_segment_max.launches = 0
    per_q, per_pass = perf.device_time_fused(pipe, len(ds.examples), repeats=repeats)
    assert co.coarse_segment_max.launches == 2 * (repeats + 1)
    assert 0 < per_q and per_pass == pytest.approx(per_q * len(ds.examples))
    rep = perf.perf_report(cfg, cfg.data.max_ctx_l, len(ds.examples), per_q, 1.0)
    assert rep["chip"] == torch.cuda.get_device_name()
    assert 0 < rep["mfu"] <= 1 and 0 < rep["hbm_util"] <= 1, rep
