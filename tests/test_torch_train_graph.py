"""The train step's CUDA graphs (train/step.py): which steps replay them,
and, on the card, that a replayed step is the eager step bit for bit.

The rule is a pure function and runs here on the CPU, as does the eager
step's count. The tests marked `cuda` skip without a card. The file
imports neither jax nor cone_tpu:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_train_graph.py -q
"""

import numpy as np
import pytest
import torch

from cone_tpu_torch.config import ConeConfig, DataConfig, ModelConfig, TrainConfig
from cone_tpu_torch.data import TrainLoader, make_synthetic_dataset
from cone_tpu_torch.parallel.distributed import LOCAL, GroupReduce, TensorParallel
from cone_tpu_torch.train.checkpoint import CheckpointManager
from cone_tpu_torch.train.loop import build_family
from cone_tpu_torch.train.optim import make_optimizer
from cone_tpu_torch.train.step import graphs_apply, make_train_step, to_floats

# two steps an epoch: the adapter's switch falls between the epochs
BSZ, STEPS_PER_EPOCH = 16, 2
ADAPTER = (False, False, True, True)


def _noop(t):
    return None


def _tp(size):
    return TensorParallel(0, size, _noop, lambda t: [t] * size)


@pytest.mark.parametrize("device,reduce,tp,want", [
    ("cpu", LOCAL, None, False),
    (torch.device("cpu"), LOCAL, None, False),
    ("cpu", GroupReduce(0, 2, _noop), None, False),
    ("cuda", LOCAL, None, True),
    ("cuda:0", LOCAL, None, True),
    (torch.device("cuda", 1), LOCAL, None, True),
    ("cuda", GroupReduce(0, 1, _noop), None, True),     # `train --mesh`: a group of one rank
    ("cuda", GroupReduce(0, 2, _noop), None, False),
    ("cuda", GroupReduce(3, 4, _noop), None, False),
    ("cuda", GroupReduce(0, 1, _noop), _tp(2), False),  # dp 1 x tp 2
    ("cuda", LOCAL, _tp(2), False),
    ("cuda", GroupReduce(1, 2, _noop), _tp(2), False),  # dp 2 x tp 2
])
def test_graphs_apply_on_one_card_with_one_rank_and_no_tp(device, reduce, tp, want):
    assert graphs_apply(device, reduce, tp) is want


def _setup(dropout=0.1, input_dropout=0.5):
    cfg = ConeConfig(
        model=ModelConfig(hidden_dim=64, nheads=4, dim_feedforward=128, t_feat_dim=32,
                          v_motion_feat_dim=32, v_appear_feat_dim=32, max_q_l=8, max_v_l=32,
                          dropout=dropout, input_dropout=input_dropout),
        data=DataConfig(max_v_l=32, max_q_l=8, clip_length=1.0, max_windows=5),
        train=TrainConfig(lr=1e-4, bsz=BSZ))
    ds = make_synthetic_dataset(cfg.data, n_videos=4, queries_per_video=BSZ * STEPS_PER_EPOCH // 4,
                                ctx_l_range=(100, 200), dim=32, seed=2)
    loader = TrainLoader(ds, bsz=BSZ, seed=0)
    assert loader.steps_per_epoch() == STEPS_PER_EPOCH
    return cfg, [b for e in range(2) for b in loader.epoch(e)]


def _trainer(cfg, device, graphs=None, seed=0):
    model = build_family(cfg, seed=seed, device=device)
    opt, sched = make_optimizer(model, cfg.train, STEPS_PER_EPOCH)
    return model, opt, sched, make_train_step(model, opt, sched, cfg, graphs=graphs)


@pytest.fixture
def one_intra_op_thread():
    """Thousands of tiny eager ops a step: one thread, as in
    tests/test_torch_train.py, so the test workers' pools do not spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_cpu_step_runs_eagerly(one_intra_op_thread):
    """On the CPU every step is eager: no capture, no replay."""
    cfg, batches = _setup()
    _, _, _, step = _trainer(cfg, "cpu")
    got = [to_floats(step(b, on)) for b, on in zip(batches[:2], ADAPTER)]
    assert step.counts == {"captures": 0, "warmups": 0, "replays": 0, "eager": 2}
    assert all(np.isfinite(m["loss_overall"]) and m["grad_norm"] > 0 for m in got)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _assert_same_state(a, b):
    """Two (model, optimizer) pairs hold equal weights, AdamW moments and
    step counts, bit for bit."""
    (ma, oa), (mb, ob) = a, b
    pa, pb = dict(ma.named_parameters()), dict(mb.named_parameters())
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
        sa, sb = oa.state[pa[k]], ob.state[pb[k]]
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[key], sb[key]), (k, key)


def _assert_same_metrics(got, want):
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), (k, float(got[k]), float(want[k]))


@pytest.mark.cuda
def test_replayed_steps_equal_the_eager_steps(card):
    """Four steps from the same weights and batches, dropout on, the
    adapter switched on after two (two captures), through the graphs and
    through the eager step: every metric, weight, AdamW moment and step
    count equal bit for bit; the metrics a step returned unchanged by the
    steps after it; the graph step's counts."""
    cfg, batches = _setup()
    runs = {}
    for graphs in (True, False):
        model, opt, _, step = _trainer(cfg, card, graphs)
        out, kept = [], []
        for b, on in zip(batches, ADAPTER):
            out.append(step(b, on))
            kept.append({k: v.clone() for k, v in out[-1].items()})
        for m, k in zip(out, kept):   # each step's metrics as it returned them
            _assert_same_metrics(m, k)
        runs[graphs] = (model, opt, step, out)
    (mg, og, sg, outg), (me, oe, se, oute) = runs[True], runs[False]
    assert sg.counts == {"captures": 2, "warmups": 2, "replays": 4, "eager": 0}
    assert se.counts == {"captures": 0, "warmups": 0, "replays": 0, "eager": 4}
    assert "loss_adapter" not in outg[0] and "loss_adapter" in outg[2]
    for g, e in zip(outg, oute):
        _assert_same_metrics(g, e)
    _assert_same_state((mg, og), (me, oe))


@pytest.mark.cuda
def test_replay_after_a_restore_equals_an_eager_step_from_the_checkpoint(card, tmp_path):
    """A graph run saved after two steps (train/checkpoint.py), run on for
    two more, then restored into the same model, AdamW and schedule: the
    next step replays the graph it had and equals an eager step of a model
    of other weights restored from the same checkpoint, so no graph reads
    a stale weight."""
    cfg, batches = _setup()
    ckpt = CheckpointManager(str(tmp_path))
    model, opt, sched, step = _trainer(cfg, card)
    for b in batches[:2]:
        step(b, True)
    ckpt.save("mid", model, opt, sched, epoch=0)
    for b in batches[2:]:
        step(b, True)
    ckpt.restore("mid", model, opt, sched, STEPS_PER_EPOCH)
    got = step(batches[2], True)
    assert step.counts == {"captures": 1, "warmups": 1, "replays": 5, "eager": 0}

    other, opt2, sched2, eager = _trainer(cfg, card, graphs=False, seed=1)
    ckpt.restore("mid", other, opt2, sched2, STEPS_PER_EPOCH)
    _assert_same_metrics(got, eager(batches[2], True))
    _assert_same_state((model, opt), (other, opt2))


@pytest.mark.cuda
def test_weights_moved_to_new_storage_are_captured_again(card):
    """After every parameter's storage is replaced (`param.data = ...`),
    the next step captures again and still equals the eager step."""
    cfg, batches = _setup()
    model, opt, _, step = _trainer(cfg, card)
    ref, ref_opt, _, eager = _trainer(cfg, card, graphs=False)
    for b in batches[:2]:
        _assert_same_metrics(step(b, True), eager(b, True))
    for p in model.parameters():
        p.data = p.data.clone()
    _assert_same_metrics(step(batches[2], True), eager(batches[2], True))
    assert step.counts == {"captures": 2, "warmups": 2, "replays": 3, "eager": 0}
    _assert_same_state((model, opt), (ref, ref_opt))
