"""The port's 2D-TAN training (cone_tpu_torch/train/tan_step.py, the TAN
optimizer and plateau controller of train/optim.py, the TAN branch of
train/loop.py, `train --preset tan_*`) against cone_tpu and the reference,
on the CPU.

  * tests/golden/tan_train_trajectory.npz, 4 steps of the reference recipe
    from its `w0::` weights, within tests/test_tan_train_parity.py's
    limits: each loss and the pre-clip grad norm 2e-3 relative, final
    weights 5e-4 absolute, and each parameter's update 1e-3 in norm;
  * the train step against cone_tpu's make_tan_train_step on the same
    weights and batches: losses and grad norms within 1e-4 relative, each
    leaf's update (final minus initial weights) within 5e-3 relative at
    its median entry, three
    steps with the adapter on from the first, and one step with it off
    (the adapter, with no gradient, moved by the L2 decay alone as
    cone_tpu's chain moves it);
  * the plateau controller: the same lr sequence as cone_tpu's over one
    score sequence; its state and the early-stop counters surviving a
    resume;
  * `train --preset tan_ego4d --synthetic --debug --device cpu`, narrowed,
    then `infer` on the workdir it wrote.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from cone_tpu.config import ConeConfig as JConeConfig
from cone_tpu.config import TrainConfig as JTrainConfig
from cone_tpu.data import make_synthetic_dataset as j_make_synthetic
from cone_tpu.data.dataset import TrainLoader as JTrainLoader
from cone_tpu.models.tan import ConeTanModel as JConeTanModel
from cone_tpu.train.optim import ReduceLROnPlateau as JReduceLROnPlateau
from cone_tpu.train.optim import make_tan_optimizer as j_make_tan_optimizer
from cone_tpu.train.tan_step import make_tan_train_step as j_make_tan_train_step
from cone_tpu_torch import cli
from cone_tpu_torch.config import (
    ConeConfig, DataConfig, EvalConfig, ModelConfig, TanConfig, TrainConfig,
)
from cone_tpu_torch.convert import (
    load_reference_tan_state_dict,
    random_reference_tan_state_dict,
    tan_params_to_jax,
)
from cone_tpu_torch.data import TrainLoader, make_synthetic_dataset, write_packed_store
from cone_tpu_torch.models.tan import ConeTanModel
from cone_tpu_torch.tools import golden_tan_train
from cone_tpu_torch.train.checkpoint import CheckpointManager, load_model
from cone_tpu_torch.train.optim import make_tan_optimizer
from cone_tpu_torch.train.step import to_floats
from cone_tpu_torch.train.tan_step import make_tan_train_step
from cone_tpu_torch.utils.io import load_jsonl, save_jsonl

DIM, NC = 32, 32
STEP_RTOL = 1e-4
UPDATE_RTOL = 5e-3   # median entry of a leaf's update; 8.3e-4 at worst on the CPU


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small eager ops: torch's intra-op pool spins against the other
    test workers (tests/test_torch_train.py has the same fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**train_kw):
    """tests/test_tan_loop.py's geometry: a 32x32 map, hidden 48."""
    return ConeConfig(
        model=ModelConfig(model_family="tan", t_feat_dim=DIM, v_appear_feat_dim=DIM,
                          v_motion_feat_dim=DIM, max_q_l=8, max_v_l=NC),
        tan=TanConfig(num_clips=NC, hidden_size=48, v_feat_dim=DIM, t_feat_dim=DIM,
                      txt_hidden_size=48, lstm_layers=2, num_scale_layers=(8, 4),
                      map_hidden_sizes=(48, 48), map_kernel_sizes=(5, 5),
                      map_paddings=(4, 0), proposal_top_k=5),
        data=DataConfig(dset_name="synthetic", max_v_l=NC, max_q_l=8, clip_length=1.0,
                        topk_window=4, max_ctx_l=256),
        train=TrainConfig(**{**dict(bsz=8, n_epoch=2, eval_epoch_interval=2,
                                    save_interval=100, start_epoch_for_adapter=0,
                                    lr=3e-4, wd=1e-4), **train_kw}),
        eval=EvalConfig(query_chunk=4))


def test_golden_tan_train_trajectory():
    worst = golden_tan_train.check(device="cpu")   # raises beyond the limits
    assert worst["worst_weight"]
    g = dict(np.load(golden_tan_train.FIXTURE).items())
    assert float(g["step3_loss_overall"]) < float(g["step0_loss_overall"])


@pytest.mark.parametrize("adapter_steps", [(True, True, True), (False,)],
                         ids=["adapter_on_3_steps", "adapter_off_1_step"])
def test_step_matches_cone_tpu(adapter_steps):
    cfg = _cfg()
    jcfg = JConeConfig.from_json(cfg.to_json())
    sd = random_reference_tan_state_dict(cfg.tan, seed=5)
    model = ConeTanModel(cfg.tan, device="cpu")
    model.load_state_dict(load_reference_tan_state_dict(sd))
    # flax's LSTM cell has one bias per gate, torch's two that get the same
    # gradient: the reference's Adam moves their sum twice as far and its
    # norm counts that gradient twice. Frozen at zero, bias_hh leaves the
    # port with cone_tpu's one bias (the golden test holds the reference's two)
    enc = model.fusion_layer.textual_encoder
    for i in range(cfg.tan.lstm_layers):
        getattr(enc, f"bias_hh_l{i}").requires_grad_(False)
    opt, _ = make_tan_optimizer(model, cfg.train)
    step = make_tan_train_step(model, opt, cfg.tan, adapter_loss_coef=0.1)
    params = jax.tree.map(jax.numpy.asarray, tan_params_to_jax(sd, cfg.tan))
    tx = j_make_tan_optimizer(JTrainConfig(lr=cfg.train.lr, wd=cfg.train.wd))
    opt_state = tx.init(params)
    jstep = j_make_tan_train_step(JConeTanModel(jcfg.tan), tx, jcfg.tan,
                                  adapter_loss_coef=0.1)

    kw = dict(n_videos=4, queries_per_video=4, ctx_l_range=(90, 180), dim=DIM, signal=3.0,
              seed=9)
    batches = TrainLoader(make_synthetic_dataset(cfg.data, **kw), bsz=8, seed=0).epoch(0)
    jbatches = JTrainLoader(j_make_synthetic(jcfg.data, **kw), bsz=8, seed=0).epoch(0)
    for adapter_on, batch, jbatch in zip(adapter_steps, batches, jbatches):
        got = to_floats(step(batch, adapter_on))
        params, opt_state, want = jstep(params, opt_state, jbatch, jax.random.PRNGKey(0),
                                        adapter_on)
        want = {k: float(v) for k, v in want.items()}
        assert set(got) == set(want)
        assert ("loss_adapter" in got) == adapter_on
        for k in want:
            assert abs(got[k] - want[k]) <= STEP_RTOL * max(1.0, abs(want[k])), (k, got, want)
    assert got["loss_overall"] > 0 and got["grad_norm"] > 0
    port = {k: v.numpy() for k, v in model.state_dict().items()}
    w0 = jax.tree.map(np.asarray, tan_params_to_jax(sd, cfg.tan))
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            jax.tree.map(np.asarray, tan_params_to_jax(port, cfg.tan))):
        name = jax.tree_util.keystr(path)
        start = _leaf(w0, path)
        got_upd = leaf - start
        # with the adapter off no gradient reaches it: both Adams see a
        # zero gradient plus the L2 decay and move it by about lr toward
        # zero (cone_tpu's chain; the reference's Adam would skip it), so
        # it is held like every other leaf.
        # the update, not the final weights: Adam moves a weight by about lr
        # a step, so an absolute weight limit would pass a missing update.
        # Entry by entry, as Adam divides by sqrt(v): an ULP-level
        # difference in a near-zero gradient entry can move its update by
        # up to lr, so the median entry is held, not the worst
        want_upd = np.asarray(_leaf(params, path)) - start
        moved = want_upd != 0
        assert moved.mean() > 0.5, name
        err = np.median(np.abs(got_upd - want_upd)[moved] / np.abs(want_upd)[moved])
        assert err <= UPDATE_RTOL, (name, err)


def _leaf(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


def test_plateau_lr_sequence_matches_cone_tpu():
    """torch's rel-mode max with threshold 1e-4, reductions after more than
    `patience` evals without improvement, the counter reset after each."""
    scores = [0.1, 0.2, 0.2, 0.20001, 0.19, 0.3, 0.3, 0.3, 0.3, 0.31, 0.31, 0.31, 0.31,
              0.2, 0.1, 0.0, -0.1, 0.5, 0.5]
    tcfg = TrainConfig(lr=1e-3, plateau_factor=0.8, plateau_patience=2)
    opt, plateau = make_tan_optimizer(torch.nn.Linear(2, 2), tcfg)
    tx = j_make_tan_optimizer(JTrainConfig(lr=1e-3))
    state = tx.init({"w": jax.numpy.ones(2)})
    jplateau = JReduceLROnPlateau(factor=0.8, patience=2)
    got, want = [], []
    for s in scores:
        plateau.step(s)
        got.append(opt.param_groups[0]["lr"])
        state, lr = jplateau.step(s, state)
        want.append(lr)
    np.testing.assert_allclose(got, want, rtol=1e-6)   # optax keeps its lr in float32
    assert len(set(np.round(got, 12))) >= 3             # it did reduce, more than once
    assert plateau.num_bad_epochs == jplateau.num_bad
    assert plateau.best == pytest.approx(jplateau.best)


def test_plateau_and_early_stop_state_survive_resume(tmp_path, monkeypatch):
    """A resumed TAN run continues its plateau and early-stop counters, which
    the checkpoint's extra state carries (plateau_best, plateau_num_bad, as
    cone_tpu's does) and nothing else; eval scores are stubbed to a falling
    sequence, as tests/test_tan_loop.py does."""
    import cone_tpu_torch.train.loop as loop_mod

    scores = iter([0.5, 0.4, 0.3, 0.2])
    monkeypatch.setattr(loop_mod, "evaluate", lambda *a, **k: {
        "tables": {}, "submissions": {"fusion": []}, "ranklists": {},
        "stop_score": next(scores)})
    cfg = _cfg(n_epoch=2, eval_epoch_interval=1, plateau_patience=1, bsz=4)
    cfg = cfg.replace(eval=dataclasses.replace(cfg.eval, criterion_losses=False))
    ds = make_synthetic_dataset(cfg.data, n_videos=2, queries_per_video=2,
                                ctx_l_range=(90, 120), dim=DIM, signal=3.0, seed=3)
    workdir = str(tmp_path / "resume")
    model, history = loop_mod.train(cfg, ds, ds, workdir, device="cpu")
    assert model.training and [h["lr"] for h in history] == [3e-4, 3e-4]
    template = ConeTanModel(cfg.tan, device="cpu")
    ckpt = CheckpointManager(workdir)
    epoch, extra = ckpt.restore("latest", template)
    assert epoch == 1
    assert extra == {"best_score": 0.5, "es_cnt": 1, "plateau_best": 0.5,
                     "plateau_num_bad": 1}

    # two more epochs: the counters go on from 1; the second bad eval past
    # patience 1 cuts the lr, which the checkpoint's optimizer keeps
    cfg3 = cfg.replace(train=dataclasses.replace(cfg.train, n_epoch=4))
    _, history = loop_mod.train(cfg3, ds, ds, workdir, device="cpu")
    assert [h["epoch"] for h in history] == [3, 4]
    assert history[0]["lr"] == pytest.approx(3e-4 * 0.8)
    opt, _ = make_tan_optimizer(template, cfg3.train)
    epoch, extra = ckpt.restore("latest", template, opt)
    assert epoch == 3 and extra["es_cnt"] == 3 and extra["best_score"] == 0.5
    assert extra["plateau_best"] == 0.5 and extra["plateau_num_bad"] == 1
    assert opt.param_groups[0]["lr"] == pytest.approx(3e-4 * 0.8)
    raw = torch.load(os.path.join(workdir, "model_latest.ckpt"), weights_only=True)
    assert "lr_scheduler" not in raw   # one copy of the plateau's state
    with pytest.raises(ValueError, match="CONE-only"):
        loop_mod.train(cfg.replace(train=dataclasses.replace(cfg.train, multiscale=True)),
                       ds, ds, str(tmp_path / "ms"), device="cpu")


def test_cli_train_tan_then_infer(tmp_path):
    """`train --preset tan_ego4d --synthetic --debug` (narrowed) writes a
    TAN workdir; `infer` on it reproduces the eval's latest predictions."""
    wd = str(tmp_path / "run")
    sets = ["tan.hidden_size=16", "tan.txt_hidden_size=16", "tan.lstm_layers=1",
            "tan.map_hidden_sizes=16,16,16,16", "tan.map_kernel_sizes=3,3,3,3",
            "tan.map_paddings=4,0,0,0", "model.v_appear_feat_dim=16",
            "model.v_motion_feat_dim=16", "tan.v_feat_dim=16", "train.bsz=8",
            "train.n_epoch=2", "train.eval_epoch_interval=1", "train.start_epoch_for_adapter=1",
            "data.topk_window=4", "eval.query_chunk=8", "data.dset_name=synthetic"]
    argv = ["train", "--preset", "tan_ego4d", "--synthetic", "--debug", "--device", "cpu",
            "--workdir", wd]
    for kv in sets:
        argv += ["--set", kv]
    cli.main(argv)
    cfg = ConeConfig.load(os.path.join(wd, "config.json"))
    assert cfg.model.model_family == "tan" and cfg.tan.map_hidden_sizes == (16, 16, 16, 16)
    assert cfg.model.t_feat_dim == cfg.tan.t_feat_dim == 16   # the synthetic token width
    for f in ("model_latest.ckpt", "model_best.ckpt", "latest_preds.jsonl", "metrics.jsonl"):
        assert os.path.exists(os.path.join(wd, f)), f
    model, epoch = load_model(wd, "latest", device="cpu")
    assert isinstance(model, ConeTanModel) and epoch == 1 and not model.training

    ds = make_synthetic_dataset(cfg.data, n_videos=8, queries_per_video=8, dim=16, seed=0)
    text = tmp_path / "text"
    text.mkdir()
    write_packed_store(str(tmp_path / "video.cfs"), {v: ds.appear.get(v) for v in ds.video_ids})
    write_packed_store(str(text / "tokens.cfs"),
                       {e.query_id: ds.text.get_tokens(e.query_id) for e in ds.examples})
    write_packed_store(str(text / "cls.cfs"),
                       {e.query_id: ds.text.get_cls(e.query_id)[None] for e in ds.examples})
    jsonl = str(tmp_path / "eval.jsonl")
    save_jsonl([dataclasses.asdict(e) for e in ds.examples[:8]], jsonl)
    out = str(tmp_path / "results")
    cli.main(["infer", "--workdir", wd, "--ckpt", "latest", "--device", "cpu",
              "--eval_path", jsonl, "--results_dir", out,
              "--set", f"data.appearance_feat_dir={tmp_path / 'video.cfs'}",
              "--set", f"data.t_feat_dir={text}"])
    got = {r["query_id"]: r for r in load_jsonl(os.path.join(out, "inference_latest_preds.jsonl"))}
    want = load_jsonl(os.path.join(wd, "latest_preds.jsonl"))
    assert want and set(got) == {r["query_id"] for r in want}
    for r in want:
        np.testing.assert_allclose(got[r["query_id"]]["predicted_times"],
                                   r["predicted_times"], rtol=0, atol=1e-6)
