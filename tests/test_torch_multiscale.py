"""The port's multiscale training (cone_tpu_torch/data/multiscale.py, the
ECCV'22 leaderboard recipe, and `train.multiscale` in train/loop.py)
against cone_tpu's, on the CPU.

  * the extra windows, the negative windows and every key of every batch
    of two epochs: equal to cone_tpu's MultiscaleTrainLoader, array for
    array (the same draws in the same order);
  * two multiscale steps at dropout 0 (4B motion rows of 2 * max_v_l, B
    appearance rows) against cone_tpu's make_train_step on the same
    converted weights: losses and grad norms within 1e-4 relative, weights
    within n_steps * lr absolute (tests/test_torch_train.py's
    test_train_step_equals_cone_tpu limits);
  * a rank's row slice of a batch: its standard rows and their extra rows
    of the whole batch;
  * `train` with train.multiscale: runs its epochs and evaluation on one
    rank; refused on ranks of two hosts (the CLI after the rendezvous, the
    loop, both before the workdir exists) and for the 2D-TAN family
    (tests/test_torch_multiscale_ranks.py runs it on several ranks).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cone_tpu.config import ConeConfig as JConeConfig
from cone_tpu.config import DataConfig as JDataConfig
from cone_tpu.config import ModelConfig as JModelConfig
from cone_tpu.config import TrainConfig as JTrainConfig
from cone_tpu.data import make_synthetic_dataset as j_make_synthetic_dataset
from cone_tpu.data.multiscale import MultiscaleTrainLoader as JMultiscaleTrainLoader
from cone_tpu.data.multiscale import sample_multiscale_windows as j_sample_windows
from cone_tpu.models.cone import ConeModel as JConeModel
from cone_tpu.train.optim import make_optimizer as j_make_optimizer
from cone_tpu.train.step import make_train_step as j_make_train_step
from cone_tpu_torch import cli
from cone_tpu_torch.config import ConeConfig, DataConfig, EvalConfig, ModelConfig, TrainConfig
from cone_tpu_torch.convert import params_to_jax
from cone_tpu_torch.data import make_synthetic_dataset
from cone_tpu_torch.data.multiscale import MultiscaleTrainLoader, sample_multiscale_windows
from cone_tpu_torch.parallel import distributed
from cone_tpu_torch.train import loop
from cone_tpu_torch.train.optim import make_optimizer
from cone_tpu_torch.train.step import make_train_step, to_floats

DATA = dict(max_v_l=16, max_q_l=8, clip_length=1.0, max_windows=5)
NARROW = dict(hidden_dim=32, nheads=4, enc_layers=1, dec_layers=2, dim_feedforward=64,
              t_feat_dim=16, v_motion_feat_dim=16, v_appear_feat_dim=16, max_q_l=8,
              max_v_l=16, dropout=0.0, input_dropout=0.0)
# short videos (ctx_l below the 2x window) reach the clamp of the extra windows
SYNTH = dict(n_videos=4, queries_per_video=6, ctx_l_range=(16, 50), dim=16, seed=6)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Many small eager ops: torch's intra-op pool spins against the other
    test workers (tests/test_torch_train.py has the same fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def both():
    ds = make_synthetic_dataset(DataConfig(**DATA), **SYNTH)
    jds = j_make_synthetic_dataset(JDataConfig(**DATA), **SYNTH)
    return ds, jds


def test_extra_and_negative_windows_equal_cone_tpu(both):
    ds, jds = both
    clamped = 0
    for i in range(len(ds)):
        rng, jrng = (np.random.default_rng((7, i)) for _ in range(2))
        got, want = sample_multiscale_windows(ds, i, rng), j_sample_windows(jds, i, jrng)
        assert got == want and len(got) == 3
        ctx_l = len(ds.video_features(ds.examples[i].clip_id)[0])
        clamped += sum(n > ctx_l for _, _, n in got)
        assert all(0 <= s <= e <= ctx_l for s, e, _ in got)
        for a, b in zip(ds.sample_negative_window(i, rng), jds.sample_negative_window(i, jrng)):
            assert a.dtype == b.dtype and a.shape == (16,) + a.shape[1:]
            np.testing.assert_array_equal(a, b)
        assert rng.integers(1 << 30) == jrng.integers(1 << 30)   # the same draws consumed
    assert clamped > 0


def test_batches_of_two_epochs_equal_cone_tpu(both):
    ds, jds = both
    bsz = 6
    n = 0
    for epoch in range(2):
        got = list(MultiscaleTrainLoader(ds, bsz=bsz, seed=1).epoch(epoch))
        want = list(JMultiscaleTrainLoader(jds, bsz=bsz, seed=1).epoch(epoch))
        assert len(got) == len(want) == len(ds) // bsz
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            # [standard x B ; extra x 3B] motion rows at 2 * max_v_l, the rest at B
            assert a["pos_motion"].shape == (4 * bsz, 32, 16)
            assert a["pos_appear"].shape == (bsz, 16, 16) and a["query_cls"].shape == (bsz, 16)
            assert a["span_mask"][bsz:, 0].all() and not a["span_mask"][bsz:, 1:].any()
            n += 1
    assert n == 2 * (len(ds) // bsz)


def test_whole_batches_only(both):
    """Every rank builds the whole batch: a row slice lo:hi of it is the
    standard rows lo:hi and their extra rows B + 3 lo : B + 3 hi of the
    whole batch, key by key; an empty or outside slice is refused."""
    ds, _ = both
    loader = MultiscaleTrainLoader(ds, bsz=6, seed=1)
    whole = list(loader.epoch(0))
    assert [b["pos_motion"].shape[0] for b in loader.epoch(0, 0, 6)] == [24] * len(whole)
    for lo, hi in ((0, 3), (3, 6), (2, 4)):
        for part, batch in zip(loader.epoch(0, lo, hi), whole):
            assert part.keys() == batch.keys()
            for k, v in batch.items():
                want = v[lo:hi] if len(v) == 6 else np.concatenate(
                    [v[lo:hi], v[6 + 3 * lo: 6 + 3 * hi]])
                np.testing.assert_array_equal(part[k], want, err_msg=k)
            assert part["pos_motion"].shape[0] == 4 * (hi - lo)
            assert part["query_cls"].shape[0] == hi - lo
    for lo, hi in ((3, 3), (0, 7)):
        with pytest.raises(ValueError, match="batch slice"):
            next(loader.epoch(0, lo, hi))


def test_two_multiscale_steps_equal_cone_tpu(both):
    ds, jds = both
    n_steps, lr = 2, 1e-4
    cfg = ConeConfig(model=ModelConfig(**NARROW), data=DataConfig(**DATA),
                     train=TrainConfig(lr=lr, lr_drop=120, multiscale=True))
    jcfg = JConeConfig.from_json(cfg.to_json())
    batches = list(MultiscaleTrainLoader(ds, bsz=4, seed=1).epoch(0))[:n_steps]
    model = loop.build_family(cfg, seed=0, device="cpu")
    params = jax.tree_util.tree_map(jnp.asarray, params_to_jax(model.state_dict(), cfg.model))
    tx = j_make_optimizer(params, jcfg.train, steps_per_epoch=n_steps)
    opt_state = tx.init(params)
    j_step = j_make_train_step(JConeModel(jcfg.model), tx, jcfg)
    opt, sched = make_optimizer(model, cfg.train, steps_per_epoch=n_steps)
    step = make_train_step(model, opt, sched, cfg)
    for batch in batches:   # adapter on: its InfoNCE takes the B standard rows
        got = to_floats(step(batch, True))
        params, opt_state, want = j_step(params, opt_state,
                                         {k: jnp.asarray(v) for k, v in batch.items()},
                                         jax.random.PRNGKey(0), True)
        want = {k: float(v) for k, v in want.items()}
        assert set(got) == set(want) and "loss_adapter" in got
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-4 * max(1.0, abs(want[k])), (k, got[k], want[k])
    keystr = jax.tree_util.keystr
    t_final = {keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(
        params_to_jax(model.state_dict(), cfg.model))}
    j_final = jax.tree_util.tree_leaves_with_path(jax.device_get(params))
    assert len(j_final) == len(t_final)
    for path, v in j_final:
        diff = float(np.abs(t_final[keystr(path)] - np.asarray(v)).max())
        assert diff <= n_steps * lr, (keystr(path), diff)


def _train_cfg(**train_kw):
    return ConeConfig(
        model=ModelConfig(**{**NARROW, "dropout": 0.1, "input_dropout": 0.5}),
        data=DataConfig(dset_name="synthetic", topk_window=4, **DATA),
        train=TrainConfig(bsz=4, n_epoch=2, eval_epoch_interval=2, start_epoch_for_adapter=1,
                          multiscale=True, **train_kw),
        eval=EvalConfig(query_chunk=4))


def test_train_runs_multiscale_epochs_and_evaluates(both, tmp_path):
    ds, _ = both
    cfg = _train_cfg()
    model, history = loop.train(cfg, ds, ds, str(tmp_path / "run"), device="cpu")
    assert len(history) == 2 and all(len(h["step_times"]) == len(ds) // 4 for h in history)
    for h in history:
        assert all(np.isfinite(v) for k, v in h.items() if k.startswith("loss"))
    assert "loss_adapter" in history[1] and "loss_adapter" not in history[0]
    assert history[1]["eval_loss_overall"] > 0   # the eval-loss pass: standard batches
    assert os.path.exists(tmp_path / "run" / "model_latest.ckpt") and model.training


def test_multiscale_refuses_two_ranks_before_the_workdir(both, tmp_path, monkeypatch):
    """Ranks on two hosts: `train --distributed` joins the group, reads the
    host names gathered at the rendezvous (here a host list of two) and
    refuses before the workdir exists, then leaves the group; `train` in
    the loop refuses the same."""
    ds, _ = both
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setattr(distributed, "_gather_hosts",
                        lambda *a, **k: [("node-a", 0), ("node-b", 0)])
    argv = ["train", "--synthetic", "--device", "cpu", "--workdir", str(tmp_path / "cli"),
            "--set", "train.multiscale=true", "--distributed", "--coordinator",
            f"127.0.0.1:{port}", "--num_processes", "1", "--process_id", "0"]
    with pytest.raises(ValueError, match="ranks of one host, not on 2 hosts"):
        cli.main(argv)
    assert not torch.distributed.is_initialized() and not os.path.exists(tmp_path / "cli")
    monkeypatch.setitem(distributed._ctrl, "hosts", [("node-a", 0), ("node-b", 0)])
    with pytest.raises(ValueError, match="ranks of one host, not on 2 hosts"):
        loop.train(_train_cfg(), ds, ds, str(tmp_path / "run"), device="cpu")
    assert not os.path.exists(tmp_path / "run")


def test_multiscale_is_cone_only(both, tmp_path):
    ds, _ = both
    cfg = _train_cfg()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, model_family="tan"),
                      data=dataclasses.replace(cfg.data, max_v_l=64))
    with pytest.raises(ValueError, match="CONE-only"):
        loop.train(cfg, ds, ds, str(tmp_path / "run"), device="cpu")
    assert not os.path.exists(tmp_path / "run")
