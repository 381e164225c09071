"""The port's training path (cone_tpu_torch/data TrainLoader, train/optim,
train/step, train/checkpoint, train/loop, the `train` CLI) against cone_tpu
and the reference, on the CPU.

  * TrainLoader batches: equal to cone_tpu's, array for array, two epochs;
  * tests/golden/train_trajectory.npz, 4 steps of the reference's recipe
    from its `w0::` weights (dropout 0, adapter on), within
    test_train_parity.py's limits: loss 2e-3 relative, pre-clip grad norm
    2e-3 relative, criterion terms 3e-3, final weights 5e-4 absolute;
  * the train step against cone_tpu.train.step.make_train_step on the same
    converted weights and batches, 3 steps at a narrow width: losses and
    grad norms within 1e-4 relative, weights within n_steps * lr absolute
    (Adam divides by sqrt(v): an ULP-level difference in a near-zero
    gradient entry can move that entry's update by up to lr);
  * a train run on a planted-signal synthetic set: losses fall, the
    workdir's files, resume from `latest`, warm start, eval-split losses,
    the model handed back in train mode after each eval;
  * `train --synthetic --debug` then `infer` on what it wrote.
"""

import dataclasses
import json
import os
import shutil
import sys
import types

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
from cone_tpu.data.dataset import TrainLoader as JTrainLoader
from cone_tpu.models.cone import ConeModel as JConeModel
from cone_tpu.train.optim import make_optimizer as j_make_optimizer
from cone_tpu.train.step import make_train_step as j_make_train_step
from cone_tpu_torch.cli import main as t_main
from cone_tpu_torch.config import (
    ConeConfig, DataConfig, EvalConfig, ModelConfig, TrainConfig,
)
from cone_tpu_torch.convert import params_from_jax, params_to_jax
from cone_tpu_torch.data import TrainLoader, make_synthetic_dataset, write_packed_store
from cone_tpu_torch.eval.pipeline import InferencePipeline
from cone_tpu_torch.models.cone import ConeModel
from cone_tpu_torch.serve.corpus import CorpusRetriever
from cone_tpu_torch.serve.localizer import OnlineLocalizer
from cone_tpu_torch.tools import golden_train
from cone_tpu_torch.train.checkpoint import CheckpointManager, load_model
from cone_tpu_torch.train.loop import build_family, eval_criterion_losses, evaluate, train
from cone_tpu_torch.train.optim import make_optimizer
from cone_tpu_torch.train.step import make_eval_loss_step, make_train_step, to_floats
from cone_tpu_torch.utils.io import load_jsonl, save_jsonl

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "train_trajectory.npz")
DIM = 32


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """These models are small: thousands of tiny eager ops a step. With the
    test workers sharing the cores, torch's spinning intra-op thread pool
    made the train loop here two orders of magnitude slower than one thread
    (an 8-epoch run: about 4 s alone, minutes under load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ batches

@pytest.mark.parametrize("txt_drop_ratio", [0.0, 0.3])
def test_train_loader_batches_equal_cone_tpu(txt_drop_ratio):
    kw = dict(max_v_l=16, max_q_l=8, clip_length=1.0, max_windows=5,
              txt_drop_ratio=txt_drop_ratio)
    syn = dict(n_videos=4, queries_per_video=5, ctx_l_range=(60, 120), dim=16, seed=3)
    t_ds = make_synthetic_dataset(DataConfig(**kw), **syn)
    j_ds = j_make_synthetic_dataset(JDataConfig(**kw), **syn)
    t_loader, j_loader = TrainLoader(t_ds, bsz=6, seed=11), JTrainLoader(j_ds, bsz=6, seed=11)
    assert t_loader.steps_per_epoch() == j_loader.steps_per_epoch() == 3
    for epoch in (0, 1):
        t_batches, j_batches = list(t_loader.epoch(epoch)), list(j_loader.epoch(epoch))
        assert len(t_batches) == len(j_batches) == 3
        for tb, jb in zip(t_batches, j_batches):
            assert list(tb) == list(jb)
            for k in jb:
                assert tb[k].dtype == jb[k].dtype, k
                np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    # a row slice equals those rows of the whole batch
    whole = next(t_loader.epoch(0))
    part = next(t_loader.epoch(0, lo=2, hi=5))
    for k in whole:
        np.testing.assert_array_equal(part[k], whole[k][2:5])


# ------------------------------------------------- golden trajectory

@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN).items())


@pytest.fixture(scope="module")
def trajectory(golden):
    """The reference's 4-step recipe through the port's train step from the
    fixture's initial weights; (per-step metrics, final state dict)."""
    return golden_train.replay(golden, device="cpu")


def test_golden_per_step_losses(golden, trajectory):
    steps, _ = trajectory
    for i, m in enumerate(steps):
        ref = float(golden[f"step{i}_loss_overall"])
        assert abs(m["loss_overall"] - ref) < 2e-3 * max(1.0, abs(ref)), (i, m, ref)


def test_golden_per_step_grad_norms(golden, trajectory):
    """The global gradient norm before the clip; the clip engages (the norm
    is far above grad_clip)."""
    steps, _ = trajectory
    for i, m in enumerate(steps):
        ref = float(golden[f"step{i}_grad_norm"])
        assert ref > 10 * float(golden["grad_clip"])
        assert abs(m["grad_norm"] - ref) < 2e-3 * ref, (i, m["grad_norm"], ref)


def test_golden_per_step_criterion_terms(golden, trajectory):
    steps, _ = trajectory
    for i, m in enumerate(steps):
        for key in ["loss_span", "loss_giou", "loss_label", "loss_saliency", "loss_adapter",
                    "loss_span_0", "loss_giou_0", "loss_label_0"]:
            ref = float(golden[f"step{i}_{key}"])
            assert abs(m[key] - ref) < 3e-3 * max(1.0, abs(ref)), (i, key, m[key], ref)


def test_golden_final_weights(golden, trajectory):
    _, final = trajectory
    want = {k[len("w::"):]: v for k, v in golden.items() if k.startswith("w::")}
    assert set(final) == set(want)
    worst = ("", 0.0)
    for k, v in want.items():
        diff = float(np.abs(final[k] - v).max())
        if diff > worst[1]:
            worst = (k, diff)
        assert diff < 5e-4, (k, diff)
    print(f"worst weight difference after 4 steps: {worst[0]} {worst[1]:.2e}")
    report = golden_train.worst_errors(golden, *trajectory)
    assert report["weights"] == worst[1] and all(
        report[k] < lim for k, lim in golden_train.LIMITS.items())


# ----------------------------------------------- against cone_tpu's step

NARROW = dict(hidden_dim=32, nheads=4, enc_layers=1, dec_layers=2, dim_feedforward=64,
              t_feat_dim=16, v_motion_feat_dim=16, v_appear_feat_dim=16, max_q_l=8,
              max_v_l=16, dropout=0.0, input_dropout=0.0)
NARROW_DATA = dict(max_v_l=16, max_q_l=8, clip_length=1.0, max_windows=5)


def test_train_step_equals_cone_tpu():
    n_steps, lr = 3, 1e-4
    jcfg = JConeConfig(model=JModelConfig(**NARROW), data=JDataConfig(**NARROW_DATA),
                       train=JTrainConfig(lr=lr, lr_drop=120))
    cfg = ConeConfig(model=ModelConfig(**NARROW), data=DataConfig(**NARROW_DATA),
                     train=TrainConfig(lr=lr, lr_drop=120))
    ds = make_synthetic_dataset(cfg.data, n_videos=3, queries_per_video=6,
                                ctx_l_range=(60, 120), dim=16, seed=5)
    batches = list(TrainLoader(ds, bsz=6, seed=1).epoch(0))
    assert len(batches) == n_steps

    # the port's fresh model, its weights carried over to cone_tpu's
    model = build_family(cfg, seed=0, device="cpu")
    params = jax.tree_util.tree_map(jnp.asarray, params_to_jax(model.state_dict(), cfg.model))
    jmodel = JConeModel(jcfg.model)
    tx = j_make_optimizer(params, jcfg.train, steps_per_epoch=n_steps)
    opt_state = tx.init(params)
    j_step = j_make_train_step(jmodel, tx, jcfg)
    opt, sched = make_optimizer(model, cfg.train, steps_per_epoch=n_steps)
    step = make_train_step(model, opt, sched, cfg)
    for batch in batches:
        got = to_floats(step(batch, True))
        params, opt_state, want = j_step(params, opt_state,
                                         {k: jnp.asarray(v) for k, v in batch.items()},
                                         jax.random.PRNGKey(0), True)
        want = {k: float(v) for k, v in want.items()}
        assert set(got) == set(want)
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-4 * max(1.0, abs(want[k])), (k, got[k], want[k])
    j_final = jax.tree_util.tree_leaves_with_path(jax.device_get(params))
    t_final = dict(jax.tree_util.tree_leaves_with_path(params_to_jax(model.state_dict(),
                                                                     cfg.model)))
    t_final = {jax.tree_util.keystr(p): v for p, v in t_final.items()}
    assert len(j_final) == len(t_final)
    for path, v in j_final:
        diff = float(np.abs(t_final[jax.tree_util.keystr(path)] - np.asarray(v)).max())
        assert diff <= n_steps * lr, (jax.tree_util.keystr(path), diff)


ADAPTER_UPDATE_RTOL = 5e-3   # tests/test_torch_tan_train.py's UPDATE_RTOL


def test_adapter_switch_equals_cone_tpu():
    """start_epoch_for_adapter = 1 in steps: 2 steps with the adapter off,
    then 2 with it on, against cone_tpu's step on the same weights and
    batches. While it is off the adapter has no gradient: cone_tpu's optax
    AdamW decays it and advances its step count, so its first updates after
    the switch are bias-corrected as at step 3, not step 1. The port gives
    such a parameter a zero gradient and so takes the same updates (a port
    that skipped it, as torch's AdamW does with no gradient, moves each
    adapter entry about 1.6x as far). Each adapter leaf's update, final
    minus initial weights, is held at its median entry, as
    test_torch_tan_train.py holds TAN's."""
    adapter_steps, lr = (False, False, True, True), 1e-4
    jcfg = JConeConfig(model=JModelConfig(**NARROW), data=JDataConfig(**NARROW_DATA),
                       train=JTrainConfig(lr=lr, lr_drop=120))
    cfg = ConeConfig(model=ModelConfig(**NARROW), data=DataConfig(**NARROW_DATA),
                     train=TrainConfig(lr=lr, lr_drop=120))
    ds = make_synthetic_dataset(cfg.data, n_videos=4, queries_per_video=6,
                                ctx_l_range=(60, 120), dim=16, seed=6)
    batches = list(TrainLoader(ds, bsz=6, seed=1).epoch(0))
    assert len(batches) == len(adapter_steps)
    model = build_family(cfg, seed=0, device="cpu")
    w0 = params_to_jax(model.state_dict(), cfg.model)
    params = jax.tree_util.tree_map(jnp.asarray, w0)
    tx = j_make_optimizer(params, jcfg.train, steps_per_epoch=len(batches))
    opt_state = tx.init(params)
    j_step = j_make_train_step(JConeModel(jcfg.model), tx, jcfg)
    opt, sched = make_optimizer(model, cfg.train, steps_per_epoch=len(batches))
    step = make_train_step(model, opt, sched, cfg)
    for adapter_on, batch in zip(adapter_steps, batches):
        got = to_floats(step(batch, adapter_on))
        params, opt_state, want = j_step(params, opt_state,
                                         {k: jnp.asarray(v) for k, v in batch.items()},
                                         jax.random.PRNGKey(0), adapter_on)
        want = {k: float(v) for k, v in want.items()}
        assert set(got) == set(want) and ("loss_adapter" in got) == adapter_on
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-4 * max(1.0, abs(want[k])), (k, got[k], want[k])
    port = dict(jax.tree_util.tree_leaves_with_path(params_to_jax(model.state_dict(),
                                                                  cfg.model)))
    port = {jax.tree_util.keystr(p): v for p, v in port.items()}
    start = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(w0)}
    n_adapter = 0
    for path, v in jax.tree_util.tree_leaves_with_path(jax.device_get(params)):
        name = jax.tree_util.keystr(path)
        assert float(np.abs(port[name] - np.asarray(v)).max()) <= len(batches) * lr, name
        if "adapter_layer" not in name:
            continue
        n_adapter += 1
        got_upd, want_upd = port[name] - start[name], np.asarray(v) - start[name]
        moved = want_upd != 0
        assert moved.mean() > 0.5, name
        err = np.median(np.abs(got_upd - want_upd)[moved] / np.abs(want_upd)[moved])
        assert err <= ADAPTER_UPDATE_RTOL, (name, err)
    assert n_adapter == 4


# ------------------------------------------------ model and optimizer

def test_xavier_covers_the_transformer_matrices_of_cone_tpu():
    """build_family's model xavier-initialises the same set of tensors as
    cone_tpu's build_model_and_params (every >1-D transformer parameter):
    the names, and values inside the xavier bound with a spread near it."""
    mcfg = ModelConfig(**NARROW)
    jcfg = JModelConfig(**NARROW)
    b, lq, lv = 2, jcfg.max_q_l, jcfg.max_v_l
    # the shapes of build_model_and_params's tree, without running the init
    shapes = jax.eval_shape(
        lambda: JConeModel(jcfg).init(
            {"params": jax.random.PRNGKey(0)}, jnp.ones((b, lq, jcfg.t_feat_dim)),
            jnp.ones((b, lq)), jnp.ones((b, lv, jcfg.v_motion_feat_dim)), jnp.ones((b, lv)),
            jnp.ones((b, jcfg.t_feat_dim)), jnp.ones((b, lv, jcfg.v_appear_feat_dim)),
            jnp.ones((b, lv)), method=JConeModel.init_all)["params"])
    # its rule (cone_tpu/models/init.py): every >1-D leaf under 'transformer'
    marked = jax.tree_util.tree_map_with_path(
        lambda p, x: np.full(x.shape, np.nan if ("'transformer'" in jax.tree_util.keystr(p)
                                                and len(x.shape) > 1) else 0.0, np.float32),
        shapes)
    want = {k for k, v in params_from_jax(marked, mcfg).items() if torch.isnan(v).any()}
    model = build_family(ConeConfig(model=mcfg), seed=0, device="cpu")
    got = {k for k, v in model.named_parameters() if k.startswith("transformer.") and v.dim() > 1}
    assert got == want and len(got) == 16  # 4 per encoder layer, 6 per decoder layer
    for k in got:
        w = dict(model.named_parameters())[k].detach()
        bound = (6.0 / sum(w.shape)) ** 0.5
        assert w.abs().max() <= bound and w.abs().max() > 0.9 * bound, k


def test_optimizer_groups_and_step_lr():
    cfg = TrainConfig(lr=1e-3, coef_lr=0.1, wd=1e-4, lr_drop=2)
    model = ConeModel(ModelConfig(**NARROW), device="cpu")
    opt, sched = make_optimizer(model, cfg, steps_per_epoch=3)
    groups = {g["name"]: g for g in opt.param_groups}
    n_adapter = sum(1 for k, _ in model.named_parameters() if "adapter_layer" in k)
    assert len(groups["adapter"]["params"]) == n_adapter == 4
    assert len(groups["base"]["params"]) + n_adapter == len(list(model.parameters()))
    assert all(g["weight_decay"] == 1e-4 for g in opt.param_groups)
    lrs = []
    for _ in range(7):  # updates 0..6: epochs 0,0,0,1,1,1,2
        lrs.append((groups["base"]["lr"], groups["adapter"]["lr"]))
        opt.step()
        sched.step()
    np.testing.assert_allclose(lrs, [(1e-3, 1e-4)] * 6 + [(1e-4, 1e-5)], rtol=1e-12)


# ------------------------------------------------------- the train loop

@pytest.fixture(scope="module")
def cfg():
    """tests/test_train_loop.py's configuration."""
    return ConeConfig(
        model=ModelConfig(hidden_dim=64, nheads=4, dim_feedforward=128, t_feat_dim=DIM,
                          v_motion_feat_dim=DIM, v_appear_feat_dim=DIM, max_q_l=8,
                          max_v_l=32),
        data=DataConfig(dset_name="synthetic", max_v_l=32, max_q_l=8, clip_length=1.0,
                        topk_window=5, max_ctx_l=256, max_windows=5),
        train=TrainConfig(bsz=8, n_epoch=8, eval_epoch_interval=4, lr=3e-4,
                          start_epoch_for_adapter=1, save_interval=100, max_es_cnt=10),
        eval=EvalConfig(query_chunk=4))


@pytest.fixture(scope="module")
def ds(cfg):
    return make_synthetic_dataset(cfg.data, n_videos=6, queries_per_video=6,
                                  ctx_l_range=(100, 200), dim=DIM, signal=3.0, seed=7)


@pytest.fixture(scope="module")
def trained(cfg, ds, tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("run"))
    generator_state = torch.random.get_rng_state()
    model, history = train(cfg, ds, ds, workdir, device="cpu")
    # dropout drew from a generator of its own: the caller's is untouched
    assert torch.equal(torch.random.get_rng_state(), generator_state)
    return workdir, model, history


def test_losses_fall(trained):
    _, _, history = trained
    assert len(history) == 8 and all(len(h["step_times"]) == 4 for h in history)
    assert all(np.isfinite(h["loss_overall"]) for h in history)
    # the mean of the last two epochs against the first: one epoch's mean
    # over 4 small batches swings with the sampling stream
    assert np.mean([h["loss_overall"] for h in history[-2:]]) < history[0]["loss_overall"]


def test_artifacts_written(trained, cfg):
    workdir, _, history = trained
    for f in ["config.json", "metrics.jsonl", "train.log.txt", "eval_results.txt",
              "model_latest.ckpt", "model_best.ckpt", "best_preds.jsonl",
              "latest_preds.jsonl"]:
        assert os.path.exists(os.path.join(workdir, f)), f
    records = [json.loads(line) for line in open(os.path.join(workdir, "metrics.jsonl"))]
    assert {r["kind"] for r in records} == {"hparams", "train_epoch", "eval"}
    evals = [r for r in records if r["kind"] == "eval"]
    assert len(evals) == 2 and all(np.isfinite(r["stop_score"]) for r in evals)
    assert all(np.isfinite(r["eval_loss_overall"]) for r in evals)
    hp = [r for r in records if r["kind"] == "hparams"]
    assert len(hp) == 1 and hp[0]["config"]["model"]["nheads"] == cfg.model.nheads
    assert [h["epoch"] for h in history if "eval_loss_overall" in h] == [4, 8]
    assert len(open(os.path.join(workdir, "train.log.txt")).read().splitlines()) == 8
    # what train wrote, the inference side reads back
    model, epoch = load_model(workdir, "latest", device="cpu")
    assert epoch == cfg.train.n_epoch - 1 and not model.training


def test_checkpoint_holds_the_trained_state(trained, cfg):
    workdir, model, _ = trained
    fresh = build_family(cfg, seed=99, device="cpu")
    opt, sched = make_optimizer(fresh, cfg.train, steps_per_epoch=4)
    epoch, extra = CheckpointManager(workdir).restore("latest", fresh, opt, sched)
    assert epoch == cfg.train.n_epoch - 1
    assert set(extra) == {"best_score", "es_cnt"} and extra["best_score"] > 0
    for k, v in model.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0)
    assert sched.last_epoch == 32
    assert all(int(s["step"]) in (32, 28) for s in opt.state_dict()["state"].values())


def test_resume_from_latest(trained, cfg, ds, tmp_path):
    """A workdir with a `latest` checkpoint resumes: the next epoch, the
    optimizer's step counts and the lr schedule go on from it, and the
    early-stop counters come back."""
    workdir, _, _ = trained
    wd = str(tmp_path / "resumed")
    shutil.copytree(workdir, wd)
    _, extra0 = CheckpointManager(wd).restore("latest", build_family(cfg, 0, "cpu"))
    cfg9 = cfg.replace(train=dataclasses.replace(cfg.train, n_epoch=9, save_interval=9))
    _, history = train(cfg9, ds, ds, wd, device="cpu")
    assert [h["epoch"] for h in history] == [9]
    raw = torch.load(os.path.join(wd, "model_e0008.ckpt"), weights_only=True)
    assert raw["epoch"] == 8 and raw["extra"] == extra0
    assert raw["lr_scheduler"]["last_epoch"] == 36
    # every parameter counts every step, the adapter's 4 steps without a
    # gradient (epoch 0, before start_epoch_for_adapter) included, as
    # cone_tpu's shared optax count does
    assert {int(s["step"]) for s in raw["optimizer"]["state"].values()} == {36}
    assert len(raw["optimizer"]["state"]) == len(list(build_family(cfg, 0, "cpu").parameters()))


def test_warm_start_init_ckpt(trained, cfg, ds, tmp_path):
    """--init_ckpt loads the weights only: one epoch from the trained
    weights starts far below a cold first epoch, at epoch 1."""
    workdir, _, history0 = trained
    cfg1 = cfg.replace(train=dataclasses.replace(cfg.train, n_epoch=1, eval_epoch_interval=100))
    _, history = train(cfg1, ds, ds, str(tmp_path / "warm"), device="cpu",
                       init_ckpt=os.path.join(workdir, "model_best.ckpt"))
    assert [h["epoch"] for h in history] == [1]
    assert history[0]["loss_overall"] < history0[0]["loss_overall"]


def test_eval_criterion_losses(trained, cfg, ds):
    """Deterministic (a fixed window draw, dropout off), finite, with the
    adapter term only when the adapter is on."""
    _, model, _ = trained
    fn = make_eval_loss_step(model, cfg)
    l1 = eval_criterion_losses(fn, ds, cfg, adapter_on=True)
    assert l1 == eval_criterion_losses(fn, ds, cfg, adapter_on=True)
    assert all(np.isfinite(v) for v in l1.values()) and l1["loss_overall"] > 0
    assert "loss_adapter" in l1
    assert "loss_adapter" not in eval_criterion_losses(fn, ds, cfg, adapter_on=False)
    assert model.training


def test_eval_hands_the_model_back_in_train_mode(trained, cfg, ds):
    """The inference pipeline switches its module to eval mode; an eval
    epoch must not leave the trained module there, or every later epoch
    trains with dropout off. After evaluate, a forward with dropout differs
    from the no_grad eval forward; the serving path keeps eval mode."""
    _, model, _ = trained
    assert model.training  # train() ended on an eval epoch
    res = evaluate(model, ds, cfg, device="cpu")
    assert np.isfinite(res["stop_score"]) and model.training
    assert all(m.training for m in model.modules())
    batch = next(TrainLoader(ds, bsz=4, seed=0).epoch(0))
    args = [torch.from_numpy(batch[k]) for k in
            ("query_tokens", "query_mask", "pos_motion", "pos_mask")]
    with torch.no_grad():
        train_out = model(*args)["pred_spans"]
        model.eval()
        eval_out = model(*args)["pred_spans"]
        model.train()
    assert not torch.allclose(train_out, eval_out)
    # the pipeline and the serving classes built on it hold their module in
    # eval mode, as they rely on
    for build in (lambda: InferencePipeline(model, ds, cfg, device="cpu"),
                  lambda: CorpusRetriever(model, cfg, device="cpu"),
                  lambda: OnlineLocalizer(model, cfg, device="cpu")):
        model.train()
        build()
        assert not model.training
    model.train()


def test_tensorboard_writer_on_request(cfg, ds, tmp_path, monkeypatch):
    """train(tensorboard=True) logs through a SummaryWriter: the hparams
    text, Train/ and Eval/ scalars, closed at the end. A recording fake
    stands in for torch.utils.tensorboard, whose import pulls in
    TensorFlow where it is installed. Off by default."""
    calls = []

    class FakeWriter:
        def __init__(self, logdir):
            calls.append(("init", logdir))

        def add_scalar(self, tag, value, step):
            calls.append((tag, step))

        def add_text(self, tag, text):
            calls.append((tag, text))

        def close(self):
            calls.append(("close",))

    fake = types.ModuleType("torch.utils.tensorboard")
    fake.SummaryWriter = FakeWriter
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", fake)
    cfg1 = cfg.replace(train=dataclasses.replace(cfg.train, n_epoch=1, eval_epoch_interval=1))
    train(cfg1, ds, ds, str(tmp_path / "tb"), device="cpu", tensorboard=True)
    tags = [c[0] for c in calls]
    assert calls[0] == ("init", str(tmp_path / "tb" / "tensorboard_log"))
    assert {"hyperparameters", "Train/loss_overall", "Train/step_time", "Eval/stop_score",
            "Eval/loss_overall"} <= set(tags)
    assert tags[-1] == "close"
    calls.clear()
    train(cfg1, ds, ds, str(tmp_path / "no_tb"), device="cpu")
    assert not calls


@pytest.mark.parametrize("section,field,value,item", [
    ("model", "model_family", "tan", "item 10"),
    ("train", "tp_devices", 2, "item 11"),
    ("train", "multiscale", True, "item 14"),
])
def test_unported_training_options_raise(cfg, ds, tmp_path, monkeypatch, section, field,
                                         value, item):
    bad = cfg.replace(**{section: dataclasses.replace(getattr(cfg, section), **{field: value})})
    if item == "item 10":
        # the 2D-TAN family trains now (tests/test_torch_tan_train.py): what
        # raises, before the workdir exists, is a map that does not fit the window
        with pytest.raises(ValueError, match="TAN geometry"):
            train(bad, ds, ds, str(tmp_path / "run"), device="cpu")
    elif item == "item 14":
        # the multiscale loader trains now, on the ranks of one host too
        # (tests/test_torch_multiscale_ranks.py): what raises, before the
        # workdir exists, is ranks on more than one host
        from cone_tpu_torch.parallel import distributed

        monkeypatch.setitem(distributed._ctrl, "hosts", [("node-a", 0), ("node-b", 0)])
        with pytest.raises(ValueError, match="ranks of one host, not on 2 hosts"):
            train(bad, ds, ds, str(tmp_path / "run"), device="cpu")
    else:
        # tensor parallelism trains now (tests/test_torch_tp.py): what raises,
        # before the workdir exists, is a group whose size tp does not divide
        # (here no group: one rank)
        with pytest.raises(ValueError, match="do not divide by train.tp_devices=2"):
            train(bad, ds, ds, str(tmp_path / "run"), device="cpu")
    assert not os.path.exists(tmp_path / "run")


# ------------------------------------------------------------------ CLI

def test_cli_train_then_infer(tmp_path):
    """`train --synthetic --debug` writes a workdir that `infer` reads: the
    ranklists and kept moments of infer's run on the same data equal the
    eval's latest_preds.jsonl from the same checkpoint."""
    wd = str(tmp_path / "run")
    sets = ["model.hidden_dim=32", "model.nheads=4", "model.dim_feedforward=64",
            "model.enc_layers=1", "model.dec_layers=2", "model.t_feat_dim=16",
            "model.v_motion_feat_dim=16", "model.v_appear_feat_dim=16",
            "train.n_epoch=2", "train.eval_epoch_interval=1", "train.bsz=8",
            "data.dset_name=synthetic"]
    argv = ["train", "--synthetic", "--debug", "--device", "cpu", "--workdir", wd]
    for kv in sets:
        argv += ["--set", kv]
    dumped = str(tmp_path / "resolved.json")
    t_main(argv + ["--dump_config", dumped])
    assert not os.path.exists(wd)
    resolved = ConeConfig.load(dumped)
    assert resolved.train.debug and resolved.model.hidden_dim == 32
    t_main(argv)
    for f in ("config.json", "model_latest.ckpt", "latest_preds.jsonl", "metrics.jsonl"):
        assert os.path.exists(os.path.join(wd, f)), f
    assert ConeConfig.load(os.path.join(wd, "config.json")) == resolved
    # tensor parallelism needs a group of ranks (tests/test_torch_tp.py runs one)
    with pytest.raises(SystemExit, match="needs --distributed"):
        t_main(argv + ["--set", "train.tp_devices=2"])
    # --mesh: data parallel over a group of this one rank, the same run
    mesh_wd = wd + "_mesh"
    t_main([mesh_wd if a == wd else a for a in argv] + ["--mesh"])
    assert not torch.distributed.is_initialized()
    runs = [load_jsonl(os.path.join(w, "metrics.jsonl")) for w in (wd, mesh_wd)]
    assert runs[1][0]["parallel"] == {"world_size": 1, "backend": "gloo"}
    assert runs[0][0]["parallel"] == {"world_size": 1, "backend": None}
    assert ([{k: v for k, v in r.items() if k.startswith("loss")} for r in runs[0]
             if r["kind"] == "train_epoch"]
            == [{k: v for k, v in r.items() if k.startswith("loss")} for r in runs[1]
                if r["kind"] == "train_epoch"])
    # the bfloat16 from-scratch preset trains (tests/test_torch_bf16.py holds it
    # against cone_tpu): 2 heads of 16, bfloat16 compute, the same narrow widths
    scratch_wd = wd + "_scratch"
    t_main(["train", "--preset", "ego4d_scratch", "--synthetic", "--debug", "--device", "cpu",
            "--workdir", scratch_wd]
           + [x for kv in sets if kv != "model.nheads=4" for x in ("--set", kv)])
    scratch = ConeConfig.load(os.path.join(scratch_wd, "config.json"))
    assert (scratch.model.compute_dtype, scratch.model.nheads) == ("bfloat16", 2)
    assert all(np.isfinite(r["loss_overall"])
               for r in load_jsonl(os.path.join(scratch_wd, "metrics.jsonl"))
               if r["kind"] == "train_epoch")

    # the same synthetic data as .cfs stores, for infer
    cfg = ConeConfig.load(os.path.join(wd, "config.json"))
    ds = make_synthetic_dataset(cfg.data, n_videos=8, queries_per_video=8, dim=16, seed=0)
    text = tmp_path / "text"
    text.mkdir()
    write_packed_store(str(tmp_path / "video.cfs"), {v: ds.appear.get(v) for v in ds.video_ids})
    write_packed_store(str(text / "tokens.cfs"),
                       {e.query_id: ds.text.get_tokens(e.query_id) for e in ds.examples})
    write_packed_store(str(text / "cls.cfs"),
                       {e.query_id: ds.text.get_cls(e.query_id)[None] for e in ds.examples})
    jsonl = str(tmp_path / "eval.jsonl")
    save_jsonl([dataclasses.asdict(e) for e in ds.examples], jsonl)
    out = str(tmp_path / "results")
    t_main(["infer", "--workdir", wd, "--ckpt", "latest", "--device", "cpu",
            "--eval_path", jsonl, "--results_dir", out,
            "--set", f"data.appearance_feat_dir={tmp_path / 'video.cfs'}",
            "--set", f"data.t_feat_dir={text}"])
    got = {r["query_id"]: r for r in load_jsonl(os.path.join(out, "inference_latest_preds.jsonl"))}
    want = load_jsonl(os.path.join(wd, "latest_preds.jsonl"))
    assert want and len(got) >= len(want)
    for r in want:  # the debug eval scored a prefix of the queries
        np.testing.assert_allclose(got[r["query_id"]]["predicted_times"],
                                   r["predicted_times"], rtol=0, atol=1e-6)


def test_debug_nans_raises_at_the_op(cfg, ds, tmp_path, monkeypatch):
    """`--debug_nans` (cone_tpu's flag; the 2D-TAN reference's
    set_detect_anomaly) runs the command under torch's anomaly mode with
    its NaN check: a train step fed a NaN feature (one frame of the
    negative window) raises at the backward op that first produces a NaN,
    where without the flag the step returns NaN losses. The mode ends with
    the command."""
    from cone_tpu_torch.train import loop

    def one_nan_step(cfg, train_ds, eval_ds, workdir, **kw):
        model = build_family(cfg, seed=0, device="cpu")
        opt, sched = make_optimizer(model, cfg.train, steps_per_epoch=1)
        batch = dict(next(iter(TrainLoader(train_ds, bsz=8, seed=0).epoch(0))))
        batch["neg_motion"] = batch["neg_motion"].copy()
        batch["neg_motion"][0, 0, 0] = np.nan
        return to_floats(make_train_step(model, opt, sched, cfg)(batch, True))

    monkeypatch.setattr(loop, "train", one_nan_step)
    argv = ["train", "--synthetic", "--device", "cpu", "--workdir", str(tmp_path / "w"),
            "--set", "model.hidden_dim=32", "--set", "model.dim_feedforward=64",
            "--set", "model.enc_layers=1", "--set", "model.dec_layers=1"]
    metrics = t_main(argv)
    assert np.isnan(metrics["loss_overall"]) and not torch.is_anomaly_enabled()
    with pytest.raises(RuntimeError, match="Backward0' returned nan values"):
        t_main(["--debug_nans"] + argv)
    assert not torch.is_anomaly_enabled()
