"""train.multiscale (the ECCV'22 recipe, cone_tpu_torch/data/multiscale.py)
on several ranks of one host, on the CPU: data parallel (each rank its
standard rows and their extra rows of the [standard x B ; extra x 3B]
batch) and dp 1 x tp 2.

  * cone_tpu's behaviour, which the port matches: its multiscale train step
    on make_mesh(2) and on make_mesh(2, tp=2) (one host's devices) equals
    its one-device step (tests/test_tp.py's rtol 2e-4, atol 1e-5);
  * two gloo ranks of cone_tpu_torch/tools/dist_worker.py --steps 3 at a
    narrow width, dp 2 and dp 1 x tp 2, at the width's dropouts (0.1, input
    0.5), against the port's one-process multiscale steps: metrics and the
    gathered weights within the DP and TP limits (rtol 2e-4, atol 1e-5);
  * the same ranks at dropout 0 against cone_tpu's mesh trajectory of the
    same weights, dp 2 and dp 1 x tp 2, the adapter on from the first step
    (start_epoch_for_adapter=-1): metrics within 1e-4 of max(1, |x|),
    weights within n_steps x lr (PERF.md section 2);
  * the two-block dropout draw: one process draws the masks it drew with
    one block, and each rank keeps the rows of its two blocks;
  * ranks on two hosts are refused before any work, with no workdir.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from cone_tpu.config import ConeConfig as JConeConfig
from cone_tpu.data import make_synthetic_dataset as j_make_synthetic
from cone_tpu.data.multiscale import MultiscaleTrainLoader as JMultiscaleTrainLoader
from cone_tpu.models.cone import ConeModel as JConeModel
from cone_tpu.parallel.mesh import make_mesh, shard_batch, shard_params, tp_size
from cone_tpu.train.optim import make_optimizer as j_make_optimizer
from cone_tpu.train.step import make_train_step as j_make_train_step
from cone_tpu_torch.convert import (
    load_reference_state_dict, params_from_jax, params_to_jax, random_reference_state_dict,
)
from cone_tpu_torch.models.dropout import RowDropout, global_rows
from cone_tpu_torch.parallel import distributed
from cone_tpu_torch.parallel.distributed import GroupReduce
from cone_tpu_torch.tools import dist_worker
from cone_tpu_torch.train import loop
from cone_tpu_torch.train.step import rank_row_blocks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 2e-4, 1e-5          # tests/test_tp.py; the DP limit 2e-4 relative
N_STEPS = 3
GRIDS = {"dp2": 1, "dp1_tp2": 2}   # name -> train.tp_devices over 2 ranks


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small eager ops: torch's intra-op pool spins against the other
    test workers (tests/test_torch_train.py has the same fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(tp=1, dropout=True):
    """dist_worker's narrow problem at hidden 32 (4 heads, FFN 64, 1+2
    layers), multiscale, the adapter on from the first step."""
    cfg, _ = dist_worker.problem("narrow")
    drops = {} if dropout else dict(dropout=0.0, input_dropout=0.0)
    return cfg.replace(
        model=dataclasses.replace(cfg.model, hidden_dim=32, dim_feedforward=64,
                                  enc_layers=1, **drops),
        train=dataclasses.replace(cfg.train, multiscale=True, tp_devices=tp,
                                  start_epoch_for_adapter=-1))


def _start_ranks(root, cfg, init):
    """dist_worker --steps N_STEPS on 2 gloo ranks; returns wait() -> (rank
    summaries, the gathered final state dict)."""
    os.makedirs(root)
    cfg.save(str(root / "cfg.json"))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "cone_tpu_torch.tools.dist_worker", "--out", str(root / "out"),
         "--width", "narrow", "--device", "cpu", "--steps", str(N_STEPS), "--config",
         str(root / "cfg.json"), "--init", init, "--coordinator", f"127.0.0.1:{port}",
         "--num_processes", "2", "--process_id", str(i), "--timeout_s", "120"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]

    def wait():
        logs = []
        try:
            logs = [p.communicate(timeout=300)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for i, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, f"rank {i}:\n{log[-4000:]}"
        return ([json.load(open(root / f"out.{i}.json")) for i in range(2)],
                torch.load(root / "out.state.pt", weights_only=True))
    return wait


def _cone_tpu_steps(cfg, sd, mesh):
    """cone_tpu's multiscale train steps from the weights `sd` on `mesh` (None:
    one device), the batches dist_worker's --steps takes: (metrics per step,
    final weights under the reference's names)."""
    jcfg = JConeConfig.from_json(cfg.to_json())
    jds = j_make_synthetic(jcfg.data, n_videos=4, queries_per_video=4, ctx_l_range=(100, 200),
                           dim=32, signal=3.0, seed=7)
    loader = JMultiscaleTrainLoader(jds, bsz=cfg.train.bsz, seed=cfg.train.seed)
    params = params_to_jax(sd, cfg.model)
    tx = j_make_optimizer(params, jcfg.train, loader.steps_per_epoch())
    if mesh is not None and tp_size(mesh) > 1:
        params = shard_params(params, mesh)
    opt_state = tx.init(params)
    step = j_make_train_step(JConeModel(jcfg.model), tx, jcfg, mesh=mesh)
    batches = [b for e in range(2) for b in loader.epoch(e)][:N_STEPS]
    rng, out = jax.random.PRNGKey(0), []
    for batch in batches:
        if mesh is not None:
            batch = shard_batch(batch, mesh)
        rng, sub = jax.random.split(rng)
        params, opt_state, metrics = step(params, opt_state, batch, sub, True)
        out.append({k: float(v) for k, v in jax.device_get(metrics).items()})
    return out, params_from_jax(jax.device_get(params), cfg.model)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run at once: 2-rank groups of the port at each grid with dropout
    on and at dropout 0, the port's one process with dropout on, and
    cone_tpu's one device, dp 2 and dp 1 x tp 2 meshes (threads), all from
    one seeded set of weights."""
    root = tmp_path_factory.mktemp("ms_ranks")
    # through cone_tpu's tree and back: the text position table, which
    # cone_tpu's model leaves out, at the port's fresh-init values
    sd = params_from_jax(params_to_jax(load_reference_state_dict(
        random_reference_state_dict(_cfg().model, seed=3)), _cfg().model), _cfg().model)
    init = str(root / "init.pt")
    torch.save({"model": sd}, init)
    waits = {(name, drop): _start_ranks(root / f"{name}_{drop}", _cfg(tp, drop), init)
             for name, tp in GRIDS.items() for drop in (True, False)}
    one = dist_worker.train_steps("narrow", "cpu", N_STEPS, _cfg(), init=init,
                                  state_path=str(root / "one.pt"))
    meshes = {"one": None, "dp2": make_mesh(2), "dp1_tp2": make_mesh(2, tp=2)}
    jax_runs, errors = {}, []

    def jax_run(name):
        try:
            jax_runs[name] = _cone_tpu_steps(_cfg(dropout=False), sd, meshes[name])
        except BaseException as e:   # re-raised below, in the fixture's thread
            errors.append(e)
    threads = [threading.Thread(target=jax_run, args=(n,)) for n in meshes]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    ranks = {key: wait() for key, wait in waits.items()}
    return dict(one=(one, torch.load(root / "one.pt", weights_only=True)), ranks=ranks,
                cone_tpu=jax_runs)


@pytest.mark.parametrize("grid", list(GRIDS))
def test_cone_tpu_mesh_steps_equal_its_one_device_step(runs, grid):
    (want, want_w), (got, got_w) = runs["cone_tpu"]["one"], runs["cone_tpu"][grid]
    assert len(got) == N_STEPS and "loss_adapter" in got[0]
    for s, (a, b) in enumerate(zip(got, want)):
        assert a.keys() == b.keys()
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=RTOL, atol=ATOL, err_msg=f"{s} {k}")
    for k, w in want_w.items():
        np.testing.assert_allclose(np.asarray(got_w[k]), np.asarray(w), rtol=RTOL, atol=ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("grid", list(GRIDS))
def test_gloo_ranks_equal_one_process_with_dropout(runs, grid):
    ranks, state = runs["ranks"][(grid, True)]
    single, want_state = runs["one"]
    for r in ranks:
        assert (r["backend"], r["world"], r["tp"], r["dp"]) == ("gloo", 2, GRIDS[grid],
                                                                2 // GRIDS[grid])
        assert r["metrics"] == ranks[0]["metrics"]
    assert "loss_adapter" in single["metrics"][0]
    for s, (got, want) in enumerate(zip(ranks[0]["metrics"], single["metrics"])):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {s} {k}")
    assert state.keys() == want_state.keys()
    for k, w in want_state.items():
        np.testing.assert_allclose(state[k].numpy(), w.numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("grid", list(GRIDS))
def test_gloo_ranks_equal_cone_tpus_mesh_at_dropout_0(runs, grid):
    ranks, state = runs["ranks"][(grid, False)]
    wants, want_w = runs["cone_tpu"][grid]
    lr = _cfg().train.lr
    for s, want in enumerate(wants):
        got = ranks[0]["metrics"][s]
        assert got.keys() == want.keys() and "loss_adapter" in got
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-4 * max(1.0, abs(want[k])), (s, k, got[k],
                                                                            want[k])
    assert state.keys() == want_w.keys()
    for k, w in want_w.items():
        diff = float((state[k] - torch.as_tensor(np.asarray(w))).abs().max())
        assert diff <= N_STEPS * lr, (k, diff)


def test_two_block_draw_keeps_one_process_masks():
    """One process (one block, or its standard and extra blocks named apart)
    draws the same masks; each of two ranks keeps exactly the rows of its
    standard block and its extra block (rank_row_blocks) of that draw."""
    b, world = 3, 2
    drop = RowDropout(0.5).train()
    x = torch.ones(4 * b * world, 5, 7)

    def masks(blocks, rows):
        with global_rows(torch.Generator().manual_seed(11), 4 * b * world, blocks):
            return drop(x[:rows])
    whole = masks(0, 4 * b * world)
    std = b * world
    assert torch.equal(masks(((0, std), (std, 3 * std)), 4 * std), whole)
    for r in range(world):
        blocks = rank_row_blocks({"query_cls": torch.zeros(b), "query_tokens":
                                  torch.zeros(4 * b)}, GroupReduce(r, world, lambda t: None))
        assert blocks == ((r * b, b), (std + 3 * r * b, 3 * b))
        want = torch.cat([whole[r * b:(r + 1) * b], whole[std + 3 * r * b:std + 3 * (r + 1) * b]])
        assert torch.equal(masks(blocks, 4 * b), want)
    with pytest.raises(ValueError, match="do not hold a batch"):
        masks(((0, b), (std, b)), 4 * b)


def test_ranks_on_two_hosts_are_refused_before_any_work(tmp_path, monkeypatch):
    """check_supported takes multiscale at any (dp, tp) of one host and
    refuses it over two; `train` reads the hosts gathered at the rendezvous
    and refuses before the workdir exists."""
    for tp, world in ((1, 2), (2, 2), (2, 4)):
        loop.check_supported(_cfg(tp), world)
        with pytest.raises(ValueError, match="ranks of one host, not on 2 hosts"):
            loop.check_supported(_cfg(tp), world, hosts=2)
    loop.check_supported(_cfg().replace(train=dataclasses.replace(
        _cfg().train, multiscale=False)), 2, hosts=2)
    _, ds = dist_worker.problem("narrow", _cfg())
    monkeypatch.setitem(distributed._ctrl, "hosts", [("node-a", 0), ("node-b", 0)])
    assert distributed.n_hosts() == 2
    with pytest.raises(ValueError, match="not on 2 hosts"):
        loop.train(_cfg(), ds, ds, str(tmp_path / "run"), device="cpu")
    assert not os.path.exists(tmp_path / "run")
