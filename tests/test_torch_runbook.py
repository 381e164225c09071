"""The real-data runbook through the port (cone_tpu_torch/tools/parity.py,
the counterpart of scripts/parity_ego4d.sh and scripts/parity_mad.sh) and
the reference checkpoint it reads, on the CPU at a narrow width.

  * a reference checkpoint with all five keys of cone/train.py:184-191
    ({model, optimizer, lr_scheduler, epoch, opt}, `opt` an
    argparse.Namespace holding a torch.device) loads weights-only through
    `infer` (load_model), through `train --init_ckpt` and through
    CheckpointManager.restore (weights, AdamW's moments, the reference's
    epoch-counted StepLR as the port's update count); a file that pickles
    any other class is still refused;
  * `python -m cone_tpu_torch.tools.parity ego4d|mad` on synthetic assets
    (tests/test_real_data_journey.py's raw challenge json for Ego4D, a flat
    jsonl for MAD, seeded npy feature directories) runs every stage through
    the port's CLI and passes at a wide --expect_tol; the same chain exits
    nonzero at a wrong --expect;
  * its moments equal cone_tpu's `evaluate` on the same .cfs stores and the
    same weights: ranklists exact, spans within
    1e-3, scores within 2e-3 (tests/test_e2e_inference_parity.py's limits).
"""

import argparse
import json
import os
import pickle
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from cone_tpu.cli import _open_dataset as j_open_dataset
from cone_tpu.config import ConeConfig as JConeConfig
from cone_tpu.models.cone import ConeModel as JConeModel
from cone_tpu.train.loop import evaluate as j_evaluate
from cone_tpu_torch import cli
from cone_tpu_torch.config import ConeConfig, DataConfig, EvalConfig, ModelConfig, TrainConfig
from cone_tpu_torch.convert import (
    load_reference_state_dict, params_to_jax, random_reference_state_dict,
)
from cone_tpu_torch.data.reformat import reformat_ego4d
from cone_tpu_torch.models.cone import ConeModel
from cone_tpu_torch.tools import parity
from cone_tpu_torch.train.checkpoint import CheckpointManager, load_model
from cone_tpu_torch.train.optim import make_optimizer
from cone_tpu_torch.utils.io import load_jsonl, save_jsonl

from test_real_data_journey import _raw_challenge_json

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM = 32
SPAN_ATOL, SCORE_ATOL = 1e-3, 2e-3
EPOCH = 7
WIDE = ["--expect", "R1@0.3=0,R5@0.3=0", "--expect_tol", "101"]


def _cfg(dset):
    return ConeConfig(
        model=ModelConfig(hidden_dim=32, nheads=4, enc_layers=1, dec_layers=2,
                          dim_feedforward=64, t_feat_dim=DIM, v_motion_feat_dim=DIM,
                          v_appear_feat_dim=DIM, max_q_l=8, max_v_l=32),
        data=DataConfig(dset_name=dset, max_v_l=32, max_q_l=8, clip_length=1.0,
                        topk_window=4, max_ctx_l=256),
        train=TrainConfig(bsz=4, lr_drop=120),
        eval=EvalConfig(query_chunk=4))


def reference_checkpoint(state_dict: dict, path: str, epoch: int = EPOCH) -> None:
    """A checkpoint as the reference writes it (cone/train.py:184-191):
    `state_dict` as the weights; AdamW over the reference's two groups
    (adapter at lr x 0.1) and its StepLR after epoch + 1 epochs of one
    update each (on a copy of the weights, with seeded gradients); the
    epoch; the argparse options, which hold a torch.device."""
    model = ConeModel(_cfg("ego4d").model, device="cpu")
    model.load_state_dict(state_dict)
    named = list(model.named_parameters())
    opt = torch.optim.AdamW(
        [{"params": [p for n, p in named if "adapter_layer" not in n]},
         {"params": [p for n, p in named if "adapter_layer" in n], "lr": 1e-5}],
        lr=1e-4, weight_decay=1e-4)
    sched = torch.optim.lr_scheduler.StepLR(opt, 120)
    gen = torch.Generator().manual_seed(0)
    for _ in range(epoch + 1):
        for p in model.parameters():
            p.grad = torch.randn(p.shape, generator=gen)
        opt.step()
        sched.step()
    options = argparse.Namespace(device=torch.device("cuda"), dset_name="ego4d", lr=1e-4,
                                 max_v_l=32, results_dir="results/ego4d", debug=False)
    torch.save({"model": {k: v.clone() for k, v in state_dict.items()},
                "optimizer": opt.state_dict(), "lr_scheduler": sched.state_dict(),
                "epoch": epoch, "opt": options}, path)


class Arbitrary:
    """A class no reference checkpoint pickles."""


@pytest.fixture(scope="module")
def weights():
    """Seeded weights at the narrow width as cone_tpu's parameter tree and
    under the reference's names."""
    mcfg = _cfg("ego4d").model
    sd = load_reference_state_dict(random_reference_state_dict(mcfg, seed=1))
    return params_to_jax(sd, mcfg), sd


# ----------------------------------------------------- the checkpoint repair

def test_reference_checkpoint_loads_through_infer_init_ckpt_and_restore(weights, tmp_path):
    _, sd = weights
    run = tmp_path / "run"
    os.makedirs(run)
    _cfg("ego4d").save(str(run / "config.json"))
    ckpt = str(run / "model_latest.ckpt")
    reference_checkpoint(sd, ckpt)
    raw = torch.load(ckpt, map_location="cpu", weights_only=False)
    assert set(raw) == {"model", "optimizer", "lr_scheduler", "epoch", "opt"}
    assert isinstance(raw["opt"], argparse.Namespace) and raw["opt"].device.type == "cuda"

    # infer's load_model
    model, epoch = load_model(str(run), "latest", device="cpu")
    assert epoch == EPOCH and not model.training
    assert all(torch.equal(v, sd[k]) for k, v in model.state_dict().items())

    # train --init_ckpt (no epoch runs: the weights are the warm start's)
    sets = ["model.hidden_dim=32", "model.nheads=4", "model.enc_layers=1",
            "model.dim_feedforward=64", f"model.t_feat_dim={DIM}",
            f"model.v_motion_feat_dim={DIM}", f"model.v_appear_feat_dim={DIM}",
            "model.max_v_l=32", "model.max_q_l=8", "data.max_v_l=32", "data.max_q_l=8",
            "data.clip_length=1.0",
            "train.n_epoch=0", "train.bsz=4"]
    warm, history = cli.main(["train", "--synthetic", "--debug", "--device", "cpu",
                              "--workdir", str(tmp_path / "warm"), "--init_ckpt", ckpt]
                             + [x for kv in sets for x in ("--set", kv)])
    assert history == []
    assert all(torch.equal(v, sd[k]) for k, v in warm.state_dict().items())

    # CheckpointManager.restore: weights, moments, the update count
    fresh = ConeModel(_cfg("ego4d").model, device="cpu")
    opt, sched = make_optimizer(fresh, _cfg("ego4d").train, steps_per_epoch=5)
    epoch, extra = CheckpointManager(str(run)).restore("latest", fresh, opt, sched,
                                                       steps_per_epoch=5)
    assert (epoch, extra) == (EPOCH, {})
    assert all(torch.equal(v, sd[k]) for k, v in fresh.state_dict().items())
    state = opt.state_dict()["state"]
    assert len(state) == len(raw["optimizer"]["state"]) == len(list(fresh.parameters()))
    for i, s in raw["optimizer"]["state"].items():
        assert all(torch.equal(state[i][k], v) for k, v in s.items())
    assert sched.last_epoch == (EPOCH + 1) * 5
    with pytest.raises(ValueError, match="steps_per_epoch"):
        CheckpointManager(str(run)).restore("latest", fresh, opt, sched)


def test_a_file_pickling_another_class_is_still_refused(weights, tmp_path):
    _, sd = weights
    _cfg("ego4d").save(str(tmp_path / "config.json"))
    torch.save({"model": sd, "epoch": 1, "opt": Arbitrary()},
               str(tmp_path / "model_best.ckpt"))
    with pytest.raises(pickle.UnpicklingError, match="Arbitrary"):
        load_model(str(tmp_path), device="cpu")
    model = ConeModel(_cfg("ego4d").model, device="cpu")
    with pytest.raises(pickle.UnpicklingError):
        CheckpointManager(str(tmp_path)).restore("best", model)


# ------------------------------------------------------------- the runbook

def _assets(root, dset, sd):
    """(gt, ckpt, video, tokens, cls) sources of one dataset, npy dirs."""
    rng = np.random.default_rng(1)
    dirs = [root / d for d in ("vid_npy", "tok_npy", "cls_npy")]
    for d in dirs:
        os.makedirs(d)
    if dset == "ego4d":
        raw = _raw_challenge_json()
        gt = root / "nlq_val.json"
        gt.write_text(json.dumps(raw))
        videos = (("clip0", 100), ("clip1", 120))
        qids = [r["query_id"] for r in reformat_ego4d(raw)]
    else:
        videos = (("movie0", 180), ("movie1", 150))
        rows = []
        for v, dur in videos:
            for q in range(3):
                s = float(rng.uniform(0, dur - 20))
                rows.append(dict(query=f"what happens {v} {q}", query_id=f"{v}_{q}",
                                 duration=float(dur), clip_id=v, video_id=v,
                                 timestamps=[round(s, 2), round(s + rng.uniform(3, 15), 2)]))
        gt = root / "val.jsonl"
        save_jsonl(rows, str(gt))
        qids = [r["query_id"] for r in rows]
    for v, n in videos:
        np.save(dirs[0] / f"{v}.npy", rng.standard_normal((n, DIM)).astype(np.float32))
    for q in qids:
        np.save(dirs[1] / f"{q}.npy",
                rng.standard_normal((int(rng.integers(4, 8)), DIM)).astype(np.float32))
        np.save(dirs[2] / f"{q}.npy", rng.standard_normal(DIM).astype(np.float32))
    preset = root / "preset.json"
    _cfg(dset).save(str(preset))
    ckpt = root / "model_best.ckpt"
    reference_checkpoint(sd, str(ckpt))
    return [str(gt), str(ckpt)] + [str(d) for d in dirs] + ["--src_format", "npy_dir",
                                                           "--preset", str(preset)]


@pytest.fixture(scope="module")
def chains(weights, tmp_path_factory):
    """The runbook of each dataset as `python -m cone_tpu_torch.tools.parity`
    (both at once), then cone_tpu's evaluate of each run's config.json on its
    stores (both at once): {dset: (assets, run dir, stdout, cone_tpu's result)}."""
    params, sd = weights
    root = tmp_path_factory.mktemp("runbook")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = {}
    for dset in ("ego4d", "mad"):
        os.makedirs(root / dset)
        assets = _assets(root / dset, dset, sd)
        wd = str(root / dset / "out")
        proc = subprocess.Popen(
            [sys.executable, "-m", "cone_tpu_torch.tools.parity", dset, wd] + assets
            + WIDE + ["--device", "cpu"],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        out[dset] = [assets, os.path.join(wd, "run"), proc]
    for dset, entry in out.items():
        log = entry[2].communicate(timeout=300)[0]
        assert entry[2].returncode == 0, f"{dset}:\n{log[-4000:]}"
        entry[2] = log

    def cone_tpu(dset):
        run = out[dset][1]
        jcfg = JConeConfig.load(os.path.join(run, "config.json"))
        gt = out[dset][0][0]
        eval_path = os.path.join(os.path.dirname(run), "val.jsonl") if dset == "ego4d" else gt
        out[dset].append(j_evaluate(JConeModel(jcfg.model), params,
                                    j_open_dataset(jcfg, eval_path), jcfg))

    threads = [threading.Thread(target=cone_tpu, args=(d,)) for d in out]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(len(v) == 4 for v in out.values())
    return out


@pytest.mark.parametrize("dset", ["ego4d", "mad"])
def test_runbook_passes_and_its_moments_equal_cone_tpu(chains, dset):
    _, run, log, want = chains[dset]
    assert f"restored '{parity.CKPT_TAG}' (epoch {EPOCH})" in log
    assert "parity check PASSED" in log and "FAIL" not in log
    if dset == "ego4d":
        assert "Official Ego4D" in log
        assert os.path.exists(os.path.join(run, "submission_ego4d_reference.json"))
    ranklists = {r["query_id"]: r["ranklist"]
                 for r in load_jsonl(os.path.join(run, "inference_reference_windows.jsonl"))}
    assert ranklists == {q: [int(w) for w in r] for q, r in want["ranklists"].items()}
    files = {"fusion": "inference_reference_preds.jsonl",
             "proposal": "inference_reference_proposal_preds.jsonl",
             "matching": "inference_reference_matching_preds.jsonl"}
    assert set(want["submissions"]) == set(files)
    for name, f in files.items():
        got = {r["query_id"]: np.asarray(r["predicted_times"])
               for r in load_jsonl(os.path.join(run, f))}
        rows = want["submissions"][name]
        assert set(got) == {r["query_id"] for r in rows} and len(rows) == len(ranklists)
        for r in rows:
            a, b = got[r["query_id"]], np.asarray(r["predicted_times"])
            assert a.shape == b.shape and len(a), (name, r["query_id"])
            np.testing.assert_allclose(a[:, :2], b[:, :2], atol=SPAN_ATOL)
            np.testing.assert_allclose(a[:, 2:], b[:, 2:], atol=SCORE_ATOL)


@pytest.mark.parametrize("dset", ["ego4d", "mad"])
def test_runbook_exits_nonzero_at_a_wrong_row(chains, dset, tmp_path, capsys):
    assets = chains[dset][0]
    with pytest.raises(SystemExit, match="parity check FAILED") as e:
        parity.main([dset, str(tmp_path / "out")] + assets
                    + ["--expect", "R1@0.3=150", "--expect_tol", "0.1", "--device", "cpu"])
    assert e.value.code not in (0, None)
    assert "FAIL" in capsys.readouterr().out
