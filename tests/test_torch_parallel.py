"""The port's data parallelism (cone_tpu_torch/parallel/, the global-batch
criterion, the data-parallel train steps, the sharded evaluate and corpus
library, `train --distributed/--mesh`) on the CPU over gloo.

  * a real two-rank group: two processes of cone_tpu_torch/tools/dist_worker.py
    at tests/dist_worker_cfg.py's narrow width (hidden 64, 4 videos x 4
    queries, bsz 8), against the single-process port run of the same
    problem (dist_worker.run in this process, no group), with the preset's
    dropouts (0.1, input 0.5): the masks are drawn for the global batch and
    each rank keeps its rows (models/dropout.py), as cone_tpu draws them
    from one global key. The single-process port is held to cone_tpu by
    tests/test_torch_train.py; here the ranks are held to it at 1e-5,
    tighter than tests/test_multiprocess.py's 2e-4;
  * the dropout masks: a row split draws the whole batch's mask rows, and
    two ranks as threads take the single process's train steps;
  * the criterion split into two shards in this process, through the
    loss's reduce hook over threads: equal to cone_tpu's criterion on the
    whole batch, value and gradient, with rows of unequal span counts;
  * the two-rank `train --distributed` CLI, and at the bfloat16
    ego4d_scratch preset against one process (3e-3: bfloat16 roundings);
  * the units: strided video shards, row blocks, a group of one rank.
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

from cone_tpu.config import LossConfig as JLossConfig
from cone_tpu.models import losses as jlosses
from cone_tpu_torch import cli
from cone_tpu_torch.config import LossConfig
from cone_tpu_torch.models import losses
from cone_tpu_torch.models.dropout import RowDropout, global_rows, step_seed
from cone_tpu_torch.parallel import distributed
from cone_tpu_torch.parallel.distributed import GroupReduce
from cone_tpu_torch.parallel.mesh import row_block, tp_size
from cone_tpu_torch.tools import dist_worker
from cone_tpu_torch.train.checkpoint import checkpoint_path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5
BF16_DP_RTOL = 3e-3   # tests/test_torch_bf16.py's limit on criterion terms
SPAN_ATOL, SCORE_ATOL = 1e-3, 2e-3   # tests/test_e2e_inference_parity.py:110-113
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


def _spawn_ranks(argv_of_rank, n=2, timeout=600):
    """Start n ranks, wait for all; a failed rank fails the test."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable] + argv_of_rank(i), cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(n)]
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(rank 0, rank 1, single) summaries and the two workdirs."""
    root = tmp_path_factory.mktemp("dp")
    port = _free_port()
    _spawn_ranks(lambda i: [
        "-m", "cone_tpu_torch.tools.dist_worker", "--out", str(root / "out"), "--width",
        "narrow", "--device", "cpu", "--coordinator", f"127.0.0.1:{port}",
        "--num_processes", "2", "--process_id", str(i), "--timeout_s", str(GLOO_TIMEOUT_S)])
    a, b = (json.load(open(root / f"out.{i}.json")) for i in (0, 1))
    single = dist_worker.run("narrow", "cpu", str(root / "single"))
    return a, b, single, str(root / "out.workdir"), str(root / "single")


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=0)


# ------------------------------------------------------------ two ranks

def test_ranks_agree(runs):
    """Both ranks of the gloo group hold the same losses, gradient norms,
    weights, gathered evaluation, library ranking and TAN step."""
    a, b, _, _, _ = runs
    assert (a["rank"], b["rank"]) == (0, 1)
    assert a["world"] == b["world"] == 2 and a["backend"] == b["backend"] == "gloo"
    for k in ("losses", "grad_norms", "terms", "param_sum", "eval_stop_score", "rows",
              "ranklists", "window_scores", "corpus_hits", "tan"):
        assert a[k] == b[k], k
    assert a["allreduce_bytes"] == b["allreduce_bytes"] > 0


def test_two_ranks_equal_one(runs):
    """Losses, criterion terms, gradient norms and weights of the 2-rank run
    against the single-process port run: rtol 1e-5 (the gradient sum runs
    in another order). Rank 0 alone wrote the shared workdir."""
    a, _, single, wd, wd1 = runs
    _close(a["losses"], single["losses"])
    _close(a["grad_norms"], single["grad_norms"])
    _close(a["param_sum"], single["param_sum"])
    for ta, ts in zip(a["terms"], single["terms"]):
        assert set(ta) == set(ts)
        for k in ts:
            assert abs(ta[k] - ts[k]) <= RTOL * max(1.0, abs(ts[k])), (k, ta[k], ts[k])
    assert "loss_adapter" in a["terms"][1] and "eval_loss_overall" in a["terms"][1]
    got = torch.load(checkpoint_path(wd, "latest"), weights_only=True)["model"]
    want = torch.load(checkpoint_path(wd1, "latest"), weights_only=True)["model"]
    for k, w in want.items():   # 1e-5 relative to each tensor's largest entry (at least 1)
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                   atol=RTOL * max(1.0, float(w.abs().max())), err_msg=k)
    with open(os.path.join(wd, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    kinds = [r["kind"] for r in recs]
    assert kinds.count("hparams") == 1 and kinds.count("train_epoch") == 2
    assert recs[0]["parallel"] == {"world_size": 2, "backend": "gloo"}
    assert [r["loss_overall"] for r in recs if r["kind"] == "train_epoch"] == a["losses"]
    for f in ("config.json", "model_best.ckpt", "latest_preds.jsonl"):
        assert os.path.exists(os.path.join(wd, f)), f


def test_gathered_evaluate_equals_single(runs):
    """The videos shard by rank and the rows gather: every query's moments
    and window ranklist on both ranks, equal to the single run's."""
    a, b, single, _, _ = runs
    for r in (a, b):
        assert len(r["ranklists"]) == 16 and set(r["ranklists"]) == set(single["ranklists"])
        assert r["ranklists"] == single["ranklists"]
        assert set(r["rows"]) == {"fusion", "proposal", "matching"}
        for m, rows in single["rows"].items():
            assert len(r["rows"][m]) == 16
            for q, want in rows.items():
                got, want = np.asarray(r["rows"][m][q]), np.asarray(want)
                assert got.shape == want.shape, (m, q)
                np.testing.assert_allclose(got[:, :2], want[:, :2], atol=SPAN_ATOL)
                np.testing.assert_allclose(got[:, 2], want[:, 2], atol=SCORE_ATOL)
    assert a["eval_stop_score"] == pytest.approx(single["eval_stop_score"])
    # the plain path runs on the CPU: no kernel launch, 2 dispatches a rank
    assert a["eval_launches"] == a["train_launches"] == 0 and a["dispatches"] == 2


def test_sharded_library_equals_full_library(runs):
    """Two movies a rank: the merged top-k, each rank's fine stage and the
    candidate rows merged before the fusion give the whole library's
    ranking (tests/test_multiprocess.py:166-192's limits)."""
    a, _, single, _, _ = runs
    assert len(a["corpus_hits"]) == len(single["corpus_hits"]) == dist_worker.N_CORPUS_QUERIES
    for got, want in zip(a["corpus_hits"], single["corpus_hits"]):
        assert got and [g[0] for g in got] == [w[0] for w in want]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[1:3], w[1:3], atol=1e-4)
            np.testing.assert_allclose(g[3], w[3], atol=1e-3)
    assert len({h[0] for q in a["corpus_hits"] for h in q}) > 1   # both shards answer


def test_tan_dp_step_equals_single(runs):
    """One 2D-TAN step, adapter on, 4 rows a rank: the global batch's BCE
    terms, InfoNCE and gradient norm, and the same update."""
    a, _, single, _, _ = runs
    assert set(a["tan"]) == set(single["tan"]) and "loss_adapter" in a["tan"]
    for k, want in single["tan"].items():
        assert abs(a["tan"][k] - want) <= RTOL * max(1.0, abs(want)), (k, a["tan"][k], want)


# ------------------------------------------------- the sharded criterion

class _Threads:
    """A group of `world` ranks as threads of this process: all_reduce sums
    the ranks' tensors in rank order."""

    def __init__(self, world):
        self.world = world
        self.slots = [None] * world
        self.barrier = threading.Barrier(world, timeout=60)

    def reduce(self, rank):
        def all_reduce(t):
            self.slots[rank] = t.clone()
            self.barrier.wait()
            total = sum(self.slots[1:], self.slots[0].clone())
            self.barrier.wait()
            t.copy_(total)
        return GroupReduce(rank, self.world, all_reduce)

    def run(self, fn):
        out, errs = [None] * self.world, []

        def body(r):
            try:
                out[r] = fn(r, self.reduce(r))
            except BaseException as e:   # reported below
                errs.append(e)
                self.barrier.abort()
        threads = [threading.Thread(target=body, args=(r,)) for r in range(self.world)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads) and not errs, errs
        return out


def _batch(rng, b, nq, nt, lv, d, n_aux=1):
    def layer():
        return {"pred_spans": (1 / (1 + np.exp(-rng.normal(size=(b, nq, 2))))).astype(np.float32),
                "pred_logits": rng.normal(size=(b, nq, 2)).astype(np.float32)}
    out = layer()
    out["saliency_scores"] = rng.normal(size=(b, lv)).astype(np.float32)
    out["aux_outputs"] = [layer() for _ in range(n_aux)]
    unit = rng.normal(size=(2, b, d))
    unit /= np.linalg.norm(unit, axis=-1, keepdims=True)
    prop, text = unit.astype(np.float32)
    neg = layer()
    neg["saliency_scores"] = rng.normal(size=(b, lv)).astype(np.float32)
    neg["vid_mask"] = (np.arange(lv)[None] < rng.integers(5, lv, (b, 1))).astype(np.float32)
    counts = [1, 3, 2, 2, 3, 1, 1, 1][:b]        # shards of 4 rows: 8 and 6 spans
    mask = (np.arange(nt)[None] < np.asarray(counts)[:, None]).astype(np.float32)
    spans = np.stack([rng.uniform(0.1, 0.9, (b, nt)), rng.uniform(0.05, 0.5, (b, nt))], -1)
    tgt = {"span_labels": (spans * mask[..., None]).astype(np.float32), "span_mask": mask,
           "saliency_pos": rng.integers(0, lv, (b, 2)).astype(np.int64),
           "saliency_neg": rng.integers(0, lv, (b, 2)).astype(np.int64)}
    return out, neg, tgt, prop, text


def _rows(tree, lo, hi):
    if isinstance(tree, dict):
        return {k: _rows(v, lo, hi) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rows(v, lo, hi) for v in tree]
    return tree[lo:hi]


def _leaves(out):
    return [out["pred_spans"], out["pred_logits"], out["saliency_scores"],
            out["aux_outputs"][0]["pred_spans"], out["aux_outputs"][0]["pred_logits"]]


@pytest.mark.parametrize("case", ["neg_and_adapter", "no_neg", "no_adapter"])
def test_sharded_criterion_equals_cone_tpu(case):
    """The batch of 8 split into two shards of 4 rows (8 and 6 target
    spans), each shard's criterion through the reduce hook over a group of
    two threads: the shards' terms sum to cone_tpu's criterion on the whole
    batch, and their gradients (the embeddings' through the gather's
    backward) concatenate to its gradient, within 1e-5."""
    rng = np.random.default_rng(["neg_and_adapter", "no_neg", "no_adapter"].index(case))
    b, nq, nt, lv, d = 8, 5, 3, 24, 16
    out, neg, tgt, prop, text = _batch(rng, b, nq, nt, lv, d)
    neg = None if case == "no_neg" else neg
    adapter = case != "no_adapter"
    cfg = LossConfig()
    weights = losses.loss_weight_dict(cfg, 2)
    assert tgt["span_mask"][:4].sum() != tgt["span_mask"][4:].sum()

    def shard(r, reduce):
        lo, hi = row_block(b, r, 2)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a))   # noqa: E731
        o = _rows(out, lo, hi)
        o = {"pred_spans": t(o["pred_spans"]), "pred_logits": t(o["pred_logits"]),
             "saliency_scores": t(o["saliency_scores"]),
             "aux_outputs": [{k: t(v) for k, v in o["aux_outputs"][0].items()}]}
        for x in _leaves(o):
            x.requires_grad_(True)
        emb = [t(prop[lo:hi]).requires_grad_(True), t(text[lo:hi]).requires_grad_(True)]
        if adapter:
            o["adapter_embeds"] = tuple(emb)
        n = None if neg is None else {k: (t(v) if k != "aux_outputs" else v)
                                      for k, v in _rows(neg, lo, hi).items()}
        got = losses.compute_losses(o, {k: t(v) for k, v in _rows(tgt, lo, hi).items()},
                                    n, cfg, reduce)
        losses.total_loss(got, weights).backward()
        grads = [x.grad.numpy() for x in _leaves(o)] + [
            e.grad.numpy() if e.grad is not None else np.zeros(e.shape, np.float32)
            for e in emb]
        return {k: float(v.detach()) for k, v in got.items()}, grads

    shards = _Threads(2).run(shard)

    def j_total(o_leaves, p, x):
        o = dict(jax.tree.map(jnp.asarray, out))
        o["pred_spans"], o["pred_logits"], o["saliency_scores"] = o_leaves[:3]
        o["aux_outputs"] = [{"pred_spans": o_leaves[3], "pred_logits": o_leaves[4]}]
        if adapter:
            o["logits_per_video"] = p @ x.T
        terms = jlosses.compute_losses(o, jax.tree.map(jnp.asarray, tgt),
                                       None if neg is None else jax.tree.map(jnp.asarray, neg),
                                       JLossConfig())
        return jlosses.total_loss(terms, weights), terms

    leaves = [jnp.asarray(x) for x in _leaves(out)]
    (want_total, want), want_grads = jax.value_and_grad(j_total, argnums=(0, 1, 2),
                                                        has_aux=True)(leaves, prop, text)
    got = {k: shards[0][0][k] + shards[1][0][k] for k in shards[0][0]}
    assert set(got) == set(want) and ("loss_adapter" in got) == adapter
    for k, w in want.items():
        assert abs(got[k] - float(w)) <= RTOL * max(1.0, abs(float(w))), (k, got[k], float(w))
    assert abs(losses.total_loss(got, weights) - float(want_total)) <= RTOL * float(want_total)
    want_grads = [np.asarray(g) for g in list(want_grads[0]) + list(want_grads[1:])]
    for i, w in enumerate(want_grads):
        g = np.concatenate([shards[0][1][i], shards[1][1][i]])
        np.testing.assert_allclose(g, w, rtol=0, atol=RTOL * max(1.0, np.abs(w).max()),
                                   err_msg=f"gradient {i}")


# ------------------------------------------------------------- dropout

def test_row_split_draws_the_whole_batch_masks():
    """Two row blocks of 4 draw, call by call, the rows of the masks the
    whole batch of 8 draws from the same generator: (B, H, Lq, Lk) and
    (B, L, D) shapes in turn, as a step's forwards call them."""
    drop = RowDropout(0.3).train()
    x = torch.randn(8, 4, 6, 6)
    y = torch.randn(8, 5, 16)

    def calls(lo, b):
        gen = torch.Generator().manual_seed(step_seed(2018, 3))
        with global_rows(gen, 8, lo):
            return [drop(x[lo : lo + b]), drop(y[lo : lo + b]), drop(x[lo : lo + b])]

    whole = calls(0, 8)
    halves = [calls(0, 4), calls(4, 4)]
    for i, w in enumerate(whole):
        assert torch.equal(torch.cat([halves[0][i], halves[1][i]]), w), i
    kept = (whole[1] != 0).float().mean().item()
    assert 0.6 < kept < 0.8
    assert torch.allclose(whole[1][whole[1] != 0], (y / 0.7)[whole[1] != 0])
    assert not torch.equal(whole[0], whole[2])      # the stream moves on
    assert step_seed(2018, 3) != step_seed(2018, 4) and step_seed(1, 3) != step_seed(2018, 3)
    assert torch.equal(drop.eval()(x), x)
    with pytest.raises(ValueError, match="outside a global batch"):
        with global_rows(None, 8, 6):
            drop.train()(x[:4])


def test_dropout_two_thread_ranks_take_the_single_steps():
    """An epoch's two train steps at dropout 0.1 (input 0.5), adapter on: two ranks
    as threads of this process, each on its row block, against one process
    on the whole batch: losses, grad norms and weights within 1e-5."""
    from cone_tpu_torch.data import TrainLoader
    from cone_tpu_torch.train.loop import build_family
    from cone_tpu_torch.train.optim import make_optimizer
    from cone_tpu_torch.train.step import make_train_step, to_floats

    cfg, ds = dist_worker.problem("narrow")
    assert cfg.model.dropout == 0.1 and cfg.model.input_dropout == 0.5
    loader = TrainLoader(ds, bsz=cfg.train.bsz, seed=cfg.train.seed)

    def run(cfg, world):
        # the models are built here: their initialisation seeds torch's
        # global generator, which threads would share
        models = [build_family(cfg, seed=cfg.train.seed, device="cpu") for _ in range(world)]

        def rank(r, reduce):
            model = models[r]
            opt, sched = make_optimizer(model, cfg.train, loader.steps_per_epoch())
            step = make_train_step(model, opt, sched, cfg, reduce)
            lo, hi = row_block(cfg.train.bsz, reduce.rank, reduce.world)
            metrics = [to_floats(step(b, True)) for b in loader.epoch(0, lo, hi)]
            return metrics, [p.detach().clone() for p in model.parameters()]
        return _Threads(world).run(rank)

    (single, w1), = run(cfg, 1)
    ranks = run(cfg, 2)
    assert len(single) == 2   # 16 examples, bsz 8
    for metrics, weights in ranks:
        for got, want in zip(metrics, single):
            for k in ("loss_overall", "grad_norm", "loss_adapter"):
                assert abs(got[k] - want[k]) <= RTOL * max(1.0, abs(want[k])), (k, got[k], want[k])
        for g, w in zip(weights, w1):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                       atol=RTOL * max(1.0, float(w.abs().max())))
    # dropout was on: the same steps without it give other losses
    (plain, _), = run(cfg.replace(model=dataclasses.replace(
        cfg.model, dropout=0.0, input_dropout=0.0)), 1)
    assert abs(plain[0]["loss_overall"] - single[0]["loss_overall"]) > 1e-4


# ------------------------------------------------------------------ CLI

def test_cli_trains_two_ranks(tmp_path):
    """`train --distributed --coordinator ... --num_processes 2 --process_id
    i --device cpu`: both ranks run to the end, rank 0 writes the workdir."""
    wd = str(tmp_path / "run")
    port = _free_port()
    sets = ["model.hidden_dim=32", "model.nheads=4", "model.dim_feedforward=64",
            "model.enc_layers=1", "model.dec_layers=2", "model.t_feat_dim=16",
            "model.v_motion_feat_dim=16", "model.v_appear_feat_dim=16", "train.n_epoch=2",
            "train.eval_epoch_interval=1", "train.bsz=8", "data.dset_name=synthetic"]
    logs = _spawn_ranks(lambda i: [
        "-m", "cone_tpu_torch", "train", "--synthetic", "--debug", "--device", "cpu",
        "--workdir", wd, "--distributed", "--coordinator", f"127.0.0.1:{port}",
        "--num_processes", "2", "--process_id", str(i)] + [x for kv in sets for x in
                                                            ("--set", kv)])
    assert "rank 1 of 2 on cpu (gloo)" in logs[1]
    with open(os.path.join(wd, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert recs[0]["parallel"] == {"world_size": 2, "backend": "gloo"}
    assert [r["kind"] for r in recs].count("eval") == 2
    assert os.path.exists(checkpoint_path(wd, "latest"))


def test_cli_two_ranks_equal_one_process_in_bfloat16(tmp_path):
    """`train --preset ego4d_scratch` (bfloat16, 2 heads) narrowed, at the
    preset's dropouts: two gloo ranks against one process of the same run.
    The gradient sum runs in another order, and the weights' last float32
    bits then flip bfloat16 roundings now and then (measured on the CPU:
    losses 1.1e-05 relative in epoch 0, terms up to 1.1e-03 and weights
    6.7e-04 in epoch 1): losses and terms within BF16_DP_RTOL of max(1,
    |term|), weights within BF16_DP_RTOL of each tensor's largest entry
    (at least 1)."""
    sets = ["model.hidden_dim=32", "model.dim_feedforward=64", "model.t_feat_dim=16",
            "model.v_motion_feat_dim=16", "model.v_appear_feat_dim=16", "train.n_epoch=2",
            "train.eval_epoch_interval=2", "train.bsz=8", "data.dset_name=synthetic"]
    base = ["train", "--preset", "ego4d_scratch", "--synthetic", "--debug", "--device", "cpu"]
    sets = [x for kv in sets for x in ("--set", kv)]
    wd, wd1 = str(tmp_path / "two"), str(tmp_path / "one")
    port = _free_port()
    _spawn_ranks(lambda i: ["-m", "cone_tpu_torch"] + base + [
        "--workdir", wd, "--distributed", "--coordinator", f"127.0.0.1:{port}",
        "--num_processes", "2", "--process_id", str(i)] + sets)
    cli.main(base + ["--workdir", wd1] + sets)
    runs = []
    for w in (wd, wd1):
        with open(os.path.join(w, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        assert json.load(open(os.path.join(w, "config.json")))["model"]["compute_dtype"] == (
            "bfloat16")
        runs.append([r for r in recs if r["kind"] == "train_epoch"])
    assert len(runs[0]) == len(runs[1]) == 2
    for a, b in zip(*runs):
        for k in [k for k in b if k.startswith("loss")]:
            assert abs(a[k] - b[k]) <= BF16_DP_RTOL * max(1.0, abs(b[k])), (k, a[k], b[k])
    got = torch.load(checkpoint_path(wd, "latest"), weights_only=True)["model"]
    want = torch.load(checkpoint_path(wd1, "latest"), weights_only=True)["model"]
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                   atol=BF16_DP_RTOL * max(1.0, float(w.abs().max())), err_msg=k)


def test_cli_layout_flags_need_distributed(tmp_path):
    with pytest.raises(SystemExit, match="need --distributed"):
        cli.main(["train", "--workdir", str(tmp_path), "--num_processes", "2"])
    with pytest.raises(ValueError, match="need a coordinator"):
        distributed.initialize(num_processes=2, process_id=0, device="cpu")
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------- units

def test_shards_and_row_blocks(monkeypatch):
    assert distributed.shard_by_process(list(range(5))) == list(range(5))
    monkeypatch.setattr(distributed, "rank", lambda: 1)
    monkeypatch.setattr(distributed, "world_size", lambda: 3)
    assert distributed.shard_by_process(list(range(8))) == [1, 4, 7]   # strided
    assert distributed.shard_by_process(["a"]) == []
    assert row_block(32, 1, 2) == (16, 32) and row_block(8, 3, 4) == (6, 8)
    with pytest.raises(ValueError, match="divide"):
        row_block(30, 0, 4)
    assert tp_size(1, 1) == 1 and tp_size(2, 4) == 2 and tp_size(4, 4) == 4
    with pytest.raises(ValueError, match="3 rank.* do not divide by train.tp_devices=2"):
        tp_size(2, 3)


def test_a_group_of_one_rank():
    """No group: every function passes through. A group of one rank (what
    `train --mesh` makes): the collectives run and each is an exact copy,
    the gather's gradient included."""
    assert distributed.all_gather_obj({"x": 1}) == [{"x": 1}]
    assert distributed.batch_reduce() is distributed.LOCAL and distributed.backend() is None
    distributed.barrier()
    dev = distributed.initialize(num_processes=1, process_id=0, device="cpu")
    try:
        with pytest.raises(RuntimeError, match="already initialized"):
            distributed.initialize(num_processes=1, process_id=0, device="cpu")
        assert dev == torch.device("cpu") and distributed.backend() == "gloo"
        assert (distributed.rank(), distributed.world_size(), distributed.is_main()) == (0, 1, True)
        assert distributed.all_gather_obj(("a", [2])) == [("a", [2])]
        assert distributed.all_gather_rows([1, 2]) == [1, 2]
        distributed.barrier("unit")
        distributed.assert_same_across_processes(0.5, "x")
        reduce = distributed.batch_reduce()
        x = torch.randn(3, 4, requires_grad=True)
        y = reduce.gather_rows(x)
        assert torch.equal(y, x) and torch.equal(reduce.sum(x), x)
        (y * torch.arange(12.0).view(3, 4)).sum().backward()
        assert torch.equal(x.grad, torch.arange(12.0).view(3, 4))
        p = torch.nn.Parameter(torch.ones(2))
        p.grad = torch.full((2,), 3.0)
        reduce.sum_grads([p, torch.nn.Parameter(torch.ones(5))])   # the second has no grad
        assert torch.equal(p.grad, torch.full((2,), 3.0))
    finally:
        distributed.shutdown()
    assert distributed.world_size() == 1 and distributed.batch_reduce() is distributed.LOCAL


@pytest.mark.parametrize("hosts,rank,device,want", [
    ([("a", 1), ("b", 1)], 1, "cuda", (0, "nccl")),                   # 2 hosts x 1 card
    ([("a", 8)] * 8 + [("b", 8)] * 8, 11, "cuda", (3, "nccl")),         # 2 hosts x 8 cards
    ([("a", 1), ("a", 1)], 1, "cuda", (1, "gloo")),                   # 2 ranks share a card
    ([("a", 4), ("a", 4), ("b", 1), ("b", 1)], 3, "cuda", (1, "gloo")),   # one host overfull
    ([("a", 0), ("b", 0)], 1, "cpu", (0, "gloo")),
])
def test_backend_follows_ranks_per_host(hosts, rank, device, want):
    """The backend comes from every rank's (host, card count), not from the
    world size: NCCL when no host runs more ranks than it has cards."""
    assert distributed.rank_layout(hosts, rank, device) == want


def test_hosts_gather_over_the_rendezvous_store():
    """Each rank publishes its host and card count on the store and reads
    every rank's, in rank order (two ranks as threads on one store)."""
    store = torch.distributed.HashStore()
    out = [None, None]

    def rank(r):
        out[r] = distributed._gather_hosts(store, r, 2, r + 1, host=f"h{r}")
    threads = [threading.Thread(target=rank, args=(r,)) for r in (1, 0)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert out[0] == out[1] == [("h0", 1), ("h1", 2)]


def test_eval_loss_batch_must_divide_by_the_ranks(monkeypatch, tmp_path):
    """The eval-loss pass scores the single run's batches: an eval split
    smaller than train.bsz whose size does not divide by the ranks is
    refused before training starts, not trimmed to another batch."""
    from cone_tpu_torch.train import loop

    cfg, ds = dist_worker.problem("narrow")
    small = loop.copy.copy(ds)
    small.examples = ds.examples[:5]
    monkeypatch.setattr(distributed, "rank", lambda: 0)
    monkeypatch.setattr(distributed, "world_size", lambda: 2)
    with pytest.raises(ValueError, match="eval-loss batch.* = 5, must divide by the 2 ranks"):
        loop.train(cfg, ds, small, str(tmp_path / "w"), device="cpu")
    with pytest.raises(ValueError, match="must divide by the 2 ranks"):
        loop.eval_criterion_losses(None, small, cfg, False)
