"""The port's Megatron tensor parallelism (train.tp_devices > 1:
cone_tpu_torch/parallel/mesh.py shards and rules, parallel/distributed.py
grid, f / g and grad norm, the sharded transformer and dropout, the TP
train step and loop, `train --distributed --set train.tp_devices=K`) on
the CPU, its spec tests/test_tp.py.

  * the rules in torch names: tests/test_tp.py's counts (6 column-parallel
    in-projections, 6 row-parallel out-projections, 4 column-parallel FFN
    inputs; norms and heads replicated), and the divisibility fallback by
    head count and by FFN width;
  * the shards and their gather, for the weights and AdamW's moments, bit
    for bit (tp ranks as threads of this process);
  * gloo ranks of cone_tpu_torch/tools/dist_worker.py `--steps 3` at
    tests/dist_worker_cfg.py's narrow width (hidden 64, 4 heads, FFN 128,
    bsz 8), dp 1 x tp 2 and dp 2 x tp 2 at the narrow width's dropouts
    (0.1, input 0.5), against the single process: tests/test_tp.py's
    rtol 2e-4, atol 1e-5 on metrics and weights; one bfloat16 case, the
    ego4d_scratch preset through the CLI, at 3e-3 (tests/test_torch_parallel.py's
    two-rank bfloat16 limit);
  * at dropout 0, the port's dp 1 x tp 2 against cone_tpu's
    make_mesh(2, tp=2) trajectory from the same weights, built as
    tests/test_tp.py's _run_steps builds it: tests/test_torch_train.py's
    port-vs-cone_tpu limits (metrics 1e-4 relative, weights n_steps x lr);
  * `train --distributed --set train.tp_devices=2` over two ranks: train,
    eval, gathered checkpoint, resume at tp 1 and at tp 2;
  * the refusals: a world tp does not divide, tp without --distributed;
    multiscale with tp taken on one host, refused across hosts.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cone_tpu.config import ConeConfig as JConeConfig
from cone_tpu.data import make_synthetic_dataset as j_make_synthetic
from cone_tpu.data.dataset import TrainLoader as JTrainLoader
from cone_tpu.models.init import build_model_and_params
from cone_tpu.parallel.mesh import make_mesh, shard_batch, shard_params
from cone_tpu.train.optim import make_optimizer as j_make_optimizer
from cone_tpu.train.step import make_train_step as j_make_train_step
from cone_tpu_torch import cli
from cone_tpu_torch.config import ModelConfig
from cone_tpu_torch.convert import params_from_jax
from cone_tpu_torch.data import TrainLoader
from cone_tpu_torch.models.cone import ConeModel
from cone_tpu_torch.parallel import mesh
from cone_tpu_torch.parallel.distributed import TensorParallel
from cone_tpu_torch.tools import dist_worker
from cone_tpu_torch.train.checkpoint import checkpoint_path
from cone_tpu_torch.train.loop import check_supported

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 2e-4, 1e-5          # tests/test_tp.py
BF16_RTOL = 3e-3                 # tests/test_torch_parallel.py's bfloat16 limit
N_STEPS = 3
GLOO_TIMEOUT_S = 120


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small eager ops: torch's intra-op pool spins against the other
    test workers (tests/test_torch_train.py has the same fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_ranks(argv_of_rank, n=2):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable] + argv_of_rank(i), cwd=REPO, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for i in range(n)]


def _spawn_ranks(argv_of_rank, n=2, timeout=600, procs=None):
    """Start n ranks (or take `procs`, started), wait for all; a failed rank
    fails the test (tests/test_torch_parallel.py's pattern)."""
    procs = procs or _start_ranks(argv_of_rank, n)
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {i}:\n{log[-4000:]}"
    return logs


def _narrow(**kw):
    """dist_worker's narrow config with train.tp_devices and model fields
    replaced."""
    cfg, _ = dist_worker.problem("narrow")
    tp = kw.pop("tp", 1)
    return cfg.replace(model=dataclasses.replace(cfg.model, **kw),
                       train=dataclasses.replace(cfg.train, tp_devices=tp))


def _steps_on_ranks(root, cfg, world, init=None):
    """Start dist_worker --steps N_STEPS on `world` gloo ranks; returns
    wait() -> (rank summaries, the gathered final state dict)."""
    cfg.save(str(root / "cfg.json"))
    port = _free_port()
    extra = ["--init", init] if init else []
    procs = _start_ranks(lambda i: [
        "-m", "cone_tpu_torch.tools.dist_worker", "--out", str(root / "out"), "--width",
        "narrow", "--device", "cpu", "--steps", str(N_STEPS), "--config",
        str(root / "cfg.json"), "--coordinator", f"127.0.0.1:{port}", "--num_processes",
        str(world), "--process_id", str(i), "--timeout_s", str(GLOO_TIMEOUT_S)] + extra,
        n=world)

    def wait():
        _spawn_ranks(None, procs=procs)
        ranks = [json.load(open(root / f"out.{i}.json")) for i in range(world)]
        return ranks, torch.load(root / "out.state.pt", weights_only=True)
    return wait


# ------------------------------------------------------------- the rules

def _tp_test_model_shapes(**kw):
    """tests/test_tp.py's _tiny_cfg model (hidden 64, 4 heads, FFN 128, 2+2
    layers), its parameter shapes under the reference's names."""
    cfg = ModelConfig(**{**dict(hidden_dim=64, nheads=4, dim_feedforward=128, t_feat_dim=32,
                                v_motion_feat_dim=32, v_appear_feat_dim=32, max_q_l=8,
                                max_v_l=32), **kw})
    return {k: tuple(v.shape) for k, v in ConeModel(cfg, device="meta").state_dict().items()}


def test_param_shardings_rules():
    """tests/test_tp.py's counts at tp 4 in torch names: 2 encoder layers
    (1 attention block) + 2 decoder layers (2) = 6 attention blocks, 4 FFNs;
    LayerNorms, heads, embeddings and the row-parallel biases replicated."""
    shapes = _tp_test_model_shapes()
    sh = mesh.param_shardings(shapes, tp=4, nhead=4)
    count = lambda suffix, spec: sum(k.endswith(suffix) and s == spec for k, s in sh.items())
    assert count("in_proj_weight", mesh.QKV) == count("in_proj_bias", mesh.QKV) == 6
    assert count("out_proj.weight", mesh.ROW) == 6
    assert count("linear1.weight", mesh.COLUMN) == count("linear1.bias", mesh.COLUMN) == 4
    assert count("linear2.weight", mesh.ROW) == 4 and len(sh) == 6 * 3 + 4 * 3
    for k in shapes:
        if "norm" in k or "class_embed" in k or "embed" in k or k.endswith(
                ("out_proj.bias", "linear2.bias")):
            assert k not in sh, k
    assert mesh.param_shardings(shapes, tp=1, nhead=4) == {}


def test_divisibility_fallback_replicates():
    """A pair shards only when its count divides by tp: 2 heads at tp 4
    keep every attention block whole while the FFNs (128 wide) shard; an
    FFN 6 wide at tp 4 stays whole (tests/test_tp.py's fake leaf)."""
    sh = mesh.param_shardings(_tp_test_model_shapes(nheads=2), tp=4, nhead=2)
    assert not any("attn" in k for k in sh) and len(sh) == 4 * 3
    fake = {"blk.linear1.weight": (6, 4), "blk.linear1.bias": (6,),
            "blk.linear2.weight": (4, 6)}
    assert mesh.param_shardings(fake, tp=4, nhead=4) == {}
    assert set(mesh.param_shardings(fake, tp=2, nhead=4)) == set(fake)


class _ThreadGroup:
    """A tp group of `size` ranks as threads of this process: all-reduce and
    all-gather through a shared slot list and a barrier."""

    def __init__(self, size):
        self.size, self.slots = size, [None] * size
        self.barrier = threading.Barrier(size, timeout=60)

    def _gather(self, rank, t):
        self.slots[rank] = t.clone()
        self.barrier.wait()
        out = list(self.slots)
        self.barrier.wait()
        return out

    def _all_reduce(self, rank, t):
        t.copy_(torch.stack(self._gather(rank, t)).sum(0))

    def member(self, rank):
        return TensorParallel(rank, self.size, lambda t: self._all_reduce(rank, t),
                              lambda t: self._gather(rank, t))


def _on_threads(size, fn):
    """fn(rank, TensorParallel) on `size` threads; their results in rank order."""
    group, out, errors = _ThreadGroup(size), [None] * size, []

    def body(r):
        try:
            out[r] = fn(r, group.member(r))
        except BaseException as e:   # re-raised below, in the test's thread
            errors.append(e)
            group.barrier.abort()
    threads = [threading.Thread(target=body, args=(r,)) for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)
    return out


@pytest.mark.parametrize("tp", [2, 4])
def test_shards_gather_back_bit_for_bit(tp):
    """shard_state_dict -> gather_state_dict and shard_optimizer_state ->
    gather_optimizer_state give back the full weights and AdamW's moments
    to the bit; each rank's in-projection and its moments are the shard's
    shape, the head-aligned block of each q, k, v third."""
    from cone_tpu_torch.train.optim import make_optimizer

    cfg = _narrow()
    model = ConeModel(cfg.model, device="cpu")
    opt, _ = make_optimizer(model, cfg.train, steps_per_epoch=2)
    gen = torch.Generator().manual_seed(0)
    for p in model.parameters():
        p.grad = torch.randn(p.shape, generator=gen)
    opt.step()
    full, full_osd = model.state_dict(), opt.state_dict()
    names = mesh.optimizer_param_names(opt, model)
    layout = mesh.param_shardings(full, tp, cfg.model.nheads)
    key = "transformer.encoder.layers.0.self_attn.in_proj_weight"
    assert key in layout

    def rank(r, tensor):
        sd = mesh.shard_state_dict(full, layout, r, tp)
        osd = mesh.shard_optimizer_state(full_osd, names, layout, r, tp)
        d = 64 // tp
        want = torch.cat([full[key][j * 64 + r * d: j * 64 + (r + 1) * d] for j in range(3)])
        assert torch.equal(sd[key], want)
        i = names.index(key)
        assert osd["state"][i]["exp_avg"].shape == osd["state"][i]["exp_avg_sq"].shape == (
            3 * d, 64)
        return (mesh.gather_state_dict(sd, layout, tensor),
                mesh.gather_optimizer_state(osd, names, layout, tensor))

    for sd, osd in _on_threads(tp, rank):
        assert sd.keys() == full.keys() and all(torch.equal(sd[k], v) for k, v in full.items())
        assert osd["param_groups"] == full_osd["param_groups"]
        for i, s in full_osd["state"].items():
            assert all(torch.equal(osd["state"][i][k], v) for k, v in s.items())


def test_sharded_forward_and_backward_equal_the_full_model():
    """shard_model on two threads: the forward, the gradient of every
    replicated parameter and the shards of every sharded one equal the
    full model's (dropout 0), and the tp-aware norm equals torch's."""
    from cone_tpu_torch.parallel.distributed import clip_grad_norm_

    cfg = _narrow(dropout=0.0, input_dropout=0.0)
    _, ds = dist_worker.problem("narrow", cfg)
    batch = next(iter(TrainLoader(ds, bsz=4, seed=0).epoch(0)))
    args = [torch.from_numpy(batch[k]) for k in ("query_tokens", "query_mask", "pos_motion",
                                                 "pos_mask")]
    torch.manual_seed(0)
    full = ConeModel(cfg.model, device="cpu")
    out = full(*args)
    loss = out["pred_spans"].square().sum() + out["pred_logits"].sum()
    loss.backward()
    want_norm = torch.nn.utils.clip_grad_norm_(full.parameters(), float("inf"))
    grads = {k: p.grad for k, p in full.named_parameters() if p.grad is not None}

    def rank(r, tensor):
        import copy

        model = copy.deepcopy(full)
        model.zero_grad(set_to_none=True)
        layout = mesh.shard_model(model, tensor)
        got = model(*args)
        (got["pred_spans"].square().sum() + got["pred_logits"].sum()).backward()
        norm = clip_grad_norm_(model.parameters(), float("inf"), tensor)
        return layout, got, {k: p.grad for k, p in model.named_parameters()
                             if p.grad is not None}, norm

    for r, (layout, got, g, norm) in enumerate(_on_threads(2, rank)):
        assert len(layout) == 30
        torch.testing.assert_close(got["pred_spans"], out["pred_spans"], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(norm, want_norm, rtol=1e-5, atol=0)
        assert g.keys() == grads.keys()
        for k, w in grads.items():
            w = mesh.shard_tensor(w, layout[k], r, 2) if k in layout else w
            torch.testing.assert_close(g[k], w, rtol=1e-4, atol=1e-6, msg=k)


# ---------------------------------------------- gloo ranks vs one process

@pytest.fixture(scope="module")
def single_run(tmp_path_factory):
    """The single-process --steps run: (summary, final state dict)."""
    path = str(tmp_path_factory.mktemp("single") / "state.pt")
    run = dist_worker.train_steps("narrow", "cpu", N_STEPS, _narrow(), state_path=path)
    return run, torch.load(path, weights_only=True)


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("world", [2, 4], ids=["dp1_tp2", "dp2_tp2"])
def test_tp_steps_equal_one_process(tmp_path, single_run, world):
    """N_STEPS train steps at the narrow width's dropouts on a (world / 2, 2)
    grid of gloo ranks: every metric of every step and the gathered final
    weights equal the single process's within tests/test_tp.py's rtol 2e-4,
    atol 1e-5. Each rank trains on the shard's shapes, weights and moments,
    and its gathered state shards back to the bit."""
    ranks, state = _steps_on_ranks(tmp_path, _narrow(tp=2), world)()
    single, want_state = single_run
    for r in ranks:
        assert (r["tp"], r["dp"], r["world"], r["backend"]) == (2, world // 2, world, "gloo")
        assert r["metrics"] == ranks[0]["metrics"]
        assert r["roundtrip_exact"]
        assert r["shard_shapes"]["transformer.encoder.layers.0.self_attn.in_proj_weight"] == [
            96, 64]
        assert r["shard_shapes"]["transformer.decoder.layers.1.linear1.weight"] == [64, 64]
        assert r["shard_shapes"]["transformer.decoder.layers.1.linear2.weight"] == [64, 64]
        assert r["moment_shapes"]["transformer.encoder.layers.0.self_attn.in_proj_weight"] == [
            [96, 64], [96, 64]]
        assert r["full_moment_shapes"]["transformer.decoder.layers.0.linear1.weight"] == [
            128, 64]
        assert r["tp_allreduce"]["calls"] > 0
    for s, (got, want) in enumerate(zip(ranks[0]["metrics"], single["metrics"])):
        assert got.keys() == want.keys()
        for k in want:
            _close(got[k], want[k], RTOL, ATOL, f"step {s} {k}")
    assert state.keys() == want_state.keys()
    for k, w in want_state.items():
        assert state[k].shape == w.shape, k
        _close(state[k].numpy(), w.numpy(), RTOL, ATOL, k)


# ----------------------------------------------------- against cone_tpu

def test_tp_trajectory_equals_cone_tpu(tmp_path):
    """Dropout 0, dp 1 x tp 2, from cone_tpu's build_model_and_params
    weights on the narrow problem: the port's gloo ranks against cone_tpu's
    make_mesh(2, tp=2) steps (shard_params, the tp-sharded jit), per-step
    metrics within 1e-4 of max(1, |x|), final weights within N_STEPS x lr."""
    cfg = _narrow(tp=2, dropout=0.0, input_dropout=0.0)
    jcfg = JConeConfig.from_json(cfg.to_json())
    jmodel, params = build_model_and_params(jcfg.model, seed=0)
    init = str(tmp_path / "init.pt")
    torch.save({"model": params_from_jax(jax.device_get(params), cfg.model)}, init)
    wait = _steps_on_ranks(tmp_path, cfg, 2, init=init)   # cone_tpu compiles meanwhile

    _, ds = dist_worker.problem("narrow", cfg)
    jds = j_make_synthetic(jcfg.data, n_videos=4, queries_per_video=4,
                           ctx_l_range=(100, 200), dim=32, signal=3.0, seed=7)
    assert [e.query_id for e in jds.examples] == [e.query_id for e in ds.examples]
    m = make_mesh(2, tp=2)
    loader = JTrainLoader(jds, bsz=cfg.train.bsz, seed=cfg.train.seed)
    tx = j_make_optimizer(params, jcfg.train, loader.steps_per_epoch())
    params = shard_params(params, m)
    opt_state = tx.init(params)
    step = j_make_train_step(jmodel, tx, jcfg, mesh=m)
    batches = [b for e in range(2) for b in loader.epoch(e)][:N_STEPS]
    rng, wants = jax.random.PRNGKey(0), []
    for batch in batches:
        rng, sub = jax.random.split(rng)
        params, opt_state, want = step(params, opt_state, shard_batch(batch, m), sub, True)
        wants.append({k: float(v) for k, v in jax.device_get(want).items()})
    ranks, state = wait()
    for s, want in enumerate(wants):
        got = ranks[0]["metrics"][s]
        assert got.keys() == want.keys()
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-4 * max(1.0, abs(want[k])), (s, k, got[k],
                                                                            want[k])
    want_state = params_from_jax(jax.device_get(params), cfg.model)
    assert state.keys() == want_state.keys()
    for k, w in want_state.items():
        diff = float((state[k] - torch.as_tensor(np.asarray(w))).abs().max())
        assert diff <= N_STEPS * cfg.train.lr, (k, diff)


# ------------------------------------------------------------------ CLI

def _cli_argv(wd, epochs):
    sets = ["model.hidden_dim=32", "model.nheads=4", "model.dim_feedforward=64",
            "model.enc_layers=1", "model.dec_layers=2", "model.t_feat_dim=16",
            "model.v_motion_feat_dim=16", "model.v_appear_feat_dim=16",
            f"train.n_epoch={epochs}", "train.eval_epoch_interval=1", "train.bsz=8",
            "data.dset_name=synthetic"]
    return (["train", "--synthetic", "--debug", "--device", "cpu", "--workdir", wd]
            + [x for kv in sets for x in ("--set", kv)])


def _records(wd, kind):
    with open(os.path.join(wd, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["kind"] == kind]


def _tp_cli(wd, epochs):
    port = _free_port()
    _spawn_ranks(lambda i: ["-m", "cone_tpu_torch"] + _cli_argv(wd, epochs) + [
        "--set", "train.tp_devices=2", "--distributed", "--coordinator",
        f"127.0.0.1:{port}", "--num_processes", "2", "--process_id", str(i)])


def test_cli_trains_evaluates_checkpoints_and_resumes(tmp_path):
    """`train --distributed --set train.tp_devices=2` over two gloo ranks
    trains, evaluates (flattened to both ranks) and writes full-size
    checkpoints: its losses and weights equal `train` in one process's
    (tests/test_tp.py's limits), and the workdir resumes for one more epoch
    at tp 1 and at tp 2, the two resumed runs equal."""
    wd, wd1 = str(tmp_path / "tp"), str(tmp_path / "one")
    _tp_cli(wd, 2)
    cli.main(_cli_argv(wd1, 2))
    with open(os.path.join(wd, "metrics.jsonl")) as f:
        assert json.loads(f.readline())["parallel"] == {"world_size": 2, "backend": "gloo",
                                                         "tp": 2}
    for kind in ("train_epoch", "eval"):
        got, want = _records(wd, kind), _records(wd1, kind)
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            for k in [k for k in b if k.startswith(("loss", "grad_norm", "eval_loss"))]:
                _close(a[k], b[k], RTOL, ATOL, k)
    assert "eval_loss_overall" in got[-1]
    for f in ("config.json", "model_best.ckpt", "model_latest.ckpt", "latest_preds.jsonl"):
        assert os.path.exists(os.path.join(wd, f)), f
    raw = torch.load(checkpoint_path(wd, "latest"), weights_only=True)
    raw1 = torch.load(checkpoint_path(wd1, "latest"), weights_only=True)
    for k, w in raw1["model"].items():   # full-size tensors
        assert raw["model"][k].shape == w.shape, k
        _close(raw["model"][k].numpy(), w.numpy(), RTOL, ATOL, k)
    assert raw["optimizer"]["param_groups"] == raw1["optimizer"]["param_groups"]
    for i, s in raw1["optimizer"]["state"].items():
        for k, v in s.items():
            _close(raw["optimizer"]["state"][i][k].numpy(), v.numpy(), RTOL, ATOL, (i, k))
    # one more epoch from the TP workdir, in one process and at tp 2
    import shutil

    wd_one, wd_tp = str(tmp_path / "resumed_one"), str(tmp_path / "resumed_tp")
    shutil.copytree(wd, wd_one)
    shutil.copytree(wd, wd_tp)
    cli.main(_cli_argv(wd_one, 3))
    _tp_cli(wd_tp, 3)
    a, b = _records(wd_one, "train_epoch"), _records(wd_tp, "train_epoch")
    assert [r["epoch"] for r in a] == [r["epoch"] for r in b] == [1, 2, 3]
    for k in [k for k in a[-1] if k.startswith(("loss", "grad_norm"))]:
        _close(b[-1][k], a[-1][k], RTOL, ATOL, k)
    raw_one = torch.load(checkpoint_path(wd_one, "latest"), weights_only=True)
    raw_tp = torch.load(checkpoint_path(wd_tp, "latest"), weights_only=True)
    assert raw_one["epoch"] == raw_tp["epoch"] == 2
    for k, w in raw_one["model"].items():
        _close(raw_tp["model"][k].numpy(), w.numpy(), RTOL, ATOL, k)


def test_cli_tp_equals_one_process_in_bfloat16(tmp_path):
    """tests/test_torch_parallel.py's two-rank bfloat16 case at tp 2: `train
    --preset ego4d_scratch` (bfloat16, 2 heads: one a rank) narrowed, at the
    preset's dropouts, dp 1 x tp 2 against one process: epoch losses and
    terms within BF16_RTOL of max(1, |term|), weights within BF16_RTOL of
    each tensor's largest entry (at least 1). From the second step the
    weights' last float32 bits flip bfloat16 roundings, under data
    parallelism as under tensor parallelism (one step's terms and grad norm
    read 1e-3 to 1e-2 apart at dist_worker's narrow width either way,
    measured on the CPU), so the epoch means are held, as for data
    parallelism."""
    sets = ["model.hidden_dim=32", "model.dim_feedforward=64", "model.t_feat_dim=16",
            "model.v_motion_feat_dim=16", "model.v_appear_feat_dim=16", "train.n_epoch=2",
            "train.eval_epoch_interval=2", "train.bsz=8", "data.dset_name=synthetic"]
    base = ["train", "--preset", "ego4d_scratch", "--synthetic", "--debug", "--device", "cpu"]
    sets = [x for kv in sets for x in ("--set", kv)]
    wd, wd1 = str(tmp_path / "tp"), str(tmp_path / "one")
    port = _free_port()
    _spawn_ranks(lambda i: ["-m", "cone_tpu_torch"] + base + [
        "--workdir", wd, "--distributed", "--coordinator", f"127.0.0.1:{port}",
        "--num_processes", "2", "--process_id", str(i), "--set", "train.tp_devices=2"] + sets)
    cli.main(base + ["--workdir", wd1] + sets)
    runs = [_records(w, "train_epoch") for w in (wd, wd1)]
    assert len(runs[0]) == len(runs[1]) == 2
    for a, b in zip(*runs):
        for k in [k for k in b if k.startswith("loss")]:
            assert abs(a[k] - b[k]) <= BF16_RTOL * max(1.0, abs(b[k])), (k, a[k], b[k])
    got = torch.load(checkpoint_path(wd, "latest"), weights_only=True)["model"]
    want = torch.load(checkpoint_path(wd1, "latest"), weights_only=True)["model"]
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                   atol=BF16_RTOL * max(1.0, float(w.abs().max())), err_msg=k)


# ------------------------------------------------------------ refusals

def test_refusals(tmp_path):
    """A world that tp does not divide, tp without --distributed (alone or
    with --mesh): refused before any work; multiscale with tp: taken on one
    host, refused on two."""
    cfg = _narrow(tp=2)
    with pytest.raises(ValueError, match="3 rank.* do not divide by train.tp_devices=2"):
        check_supported(cfg, 3)
    check_supported(cfg, 4)
    wd = str(tmp_path / "w")
    for extra in ([], ["--mesh"]):
        with pytest.raises(SystemExit, match="tp_devices=2 .* needs --distributed"):
            cli.main(_cli_argv(wd, 1) + ["--set", "train.tp_devices=2"] + extra)
    ms = cfg.replace(train=dataclasses.replace(cfg.train, multiscale=True))
    for world in (2, 4):   # multiscale takes tp on one host
        check_supported(ms, world)
        with pytest.raises(ValueError, match="ranks of one host, not on 2 hosts"):
            check_supported(ms, world, hosts=2)
    assert not os.path.exists(wd)
