"""The port's CLI (python -m cone_tpu_torch infer|eval|ensemble|serve) and
its workdir checkpoints against cone_tpu's CLI on one synthetic workdir.

The JAX side reads model_best.msgpack; the port reads model_best.ckpt, the
reference-named torch file that tools/convert_ckpt.py --export writes (made
here with its params_to_torch_state_dict). Limits: equal ranklists, kept
moments within spans atol 1e-3 / scores atol 2e-3, equal file names, equal
metric tables.
"""

import dataclasses
import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from cone_tpu.cli import main as j_main
from cone_tpu.config import ConeConfig as JConeConfig
from cone_tpu.models.init import build_model_and_params
from cone_tpu.train.checkpoint import CheckpointManager
from cone_tpu_torch import cli as t_cli
from cone_tpu_torch.cli import main as t_main
from cone_tpu_torch.config import ConeConfig, DataConfig, EvalConfig, ModelConfig, TrainConfig
from cone_tpu_torch.data import make_synthetic_dataset, write_packed_store
from cone_tpu_torch.train.checkpoint import load_config, load_model
from cone_tpu_torch.train.loop import build_family, evaluate
from cone_tpu_torch.utils.io import load_jsonl, save_jsonl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM = 32
SPAN_ATOL, SCORE_ATOL = 1e-3, 2e-3


def _convert_ckpt():
    spec = importlib.util.spec_from_file_location(
        "convert_ckpt", os.path.join(REPO, "tools", "convert_ckpt.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A workdir both CLIs can evaluate: .cfs stores, a jsonl, config.json,
    model_best.msgpack (cone_tpu) and model_best.ckpt (the port)."""
    root = tmp_path_factory.mktemp("cli")
    cfg = ConeConfig(
        model=ModelConfig(hidden_dim=32, nheads=4, enc_layers=1, dec_layers=1,
                          dim_feedforward=64, t_feat_dim=DIM, v_motion_feat_dim=DIM,
                          v_appear_feat_dim=DIM, max_q_l=8, max_v_l=16),
        data=DataConfig(dset_name="synthetic", max_v_l=16, max_q_l=8, clip_length=1.0,
                        topk_window=4, max_ctx_l=128),
        train=TrainConfig(bsz=4),
        eval=EvalConfig(query_chunk=4))
    ds = make_synthetic_dataset(cfg.data, n_videos=3, queries_per_video=3,
                                ctx_l_range=(50, 110), dim=DIM, signal=2.0, seed=0)
    text = root / "features" / "text"
    os.makedirs(text)
    write_packed_store(str(root / "features" / "video.cfs"),
                       {v: ds.video_features(v)[0] for v in ds.video_ids})
    write_packed_store(str(text / "tokens.cfs"),
                       {e.query_id: ds.text.get_tokens(e.query_id) for e in ds.examples})
    write_packed_store(str(text / "cls.cfs"),
                       {e.query_id: ds.text.get_cls(e.query_id)[None] for e in ds.examples})
    jsonl = root / "eval.jsonl"
    save_jsonl([e.__dict__ for e in ds.examples], str(jsonl))
    cfg = cfg.replace(data=DataConfig(**{
        **cfg.data.__dict__, "appearance_feat_dir": str(root / "features" / "video.cfs"),
        "t_feat_dir": str(text), "eval_path": str(jsonl)}))
    run = root / "run"
    jcfg = JConeConfig.from_json(cfg.to_json())
    _, params = build_model_and_params(jcfg.model, seed=0)
    CheckpointManager(str(run), jcfg).save("best", params, None, epoch=3)
    conv = _convert_ckpt()
    sd = conv.params_to_torch_state_dict(conv.jax_to_numpy(params), jcfg.model)
    torch.save({"model": {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                "epoch": 3}, str(run / "model_best.ckpt"))
    return dict(root=root, run=str(run), jsonl=str(jsonl), cfg=cfg, n=len(ds.examples))


def _rows_close(got, want):
    assert [r["query_id"] for r in got] == [r["query_id"] for r in want]
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k != "predicted_times"} == {
            k: v for k, v in w.items() if k != "predicted_times"}
        a, b = np.asarray(g["predicted_times"]), np.asarray(w["predicted_times"])
        assert a.shape == b.shape and a.shape[0] >= 1, g["query_id"]
        np.testing.assert_allclose(a[:, :2], b[:, :2], atol=SPAN_ATOL)
        np.testing.assert_allclose(a[:, 2:], b[:, 2:], atol=SCORE_ATOL)


@pytest.fixture(scope="module")
def infer_outputs(workdir):
    """{mode: (port results dir, cone_tpu results dir, port stdout tables)}"""
    return {}


@pytest.mark.parametrize("mode", ["staged", "fused", "fast_postproc"])
def test_infer_matches_cone_tpu_cli(workdir, infer_outputs, capsys, mode):
    flags = {"staged": ["--save_all"], "fused": ["--fused", "--save_all"],
             "fast_postproc": ["--fast_postproc"]}[mode]
    t_dir, j_dir = (str(workdir["root"] / f"{p}_{mode}") for p in ("t", "j"))
    base = ["infer", "--workdir", workdir["run"], "--ckpt", "best"] + flags
    t_main(base + ["--results_dir", t_dir, "--device", "cpu"])
    t_out = capsys.readouterr().out
    j_main(base + ["--results_dir", j_dir])
    j_out = capsys.readouterr().out
    assert "restored 'best' (epoch 3)" in t_out and "restored 'best' (epoch 3)" in j_out
    assert "Rank@1" in t_out and "Window Pre-filtering" in t_out

    names = sorted(os.listdir(t_dir))
    assert names == sorted(os.listdir(j_dir))
    want_names = {"inference_best_preds.jsonl", "inference_best_windows.jsonl",
                  "submission_synthetic_best.jsonl"}
    if "--save_all" in flags:
        want_names |= {"inference_best_proposal_preds.jsonl",
                       "inference_best_matching_preds.jsonl"}
    assert set(names) == want_names
    # ranklists: exact
    assert (load_jsonl(os.path.join(t_dir, "inference_best_windows.jsonl"))
            == load_jsonl(os.path.join(j_dir, "inference_best_windows.jsonl")))
    for name in names:
        if name.endswith("preds.jsonl"):
            got = load_jsonl(os.path.join(t_dir, name))
            assert len(got) == workdir["n"]
            _rows_close(got, load_jsonl(os.path.join(j_dir, name)))
    sub_t = load_jsonl(os.path.join(t_dir, "submission_synthetic_best.jsonl"))
    sub_j = load_jsonl(os.path.join(j_dir, "submission_synthetic_best.jsonl"))
    for g, w in zip(sub_t, sub_j):
        assert (g["query_id"], g["video_id"]) == (w["query_id"], w["video_id"])
        np.testing.assert_allclose(g["predicted_times"], w["predicted_times"], atol=SPAN_ATOL)
    infer_outputs[mode] = (t_dir, j_dir)


def test_eval_submission_mode_gives_equal_tables(workdir, infer_outputs, capsys, tmp_path):
    if "staged" not in infer_outputs:
        pytest.skip("needs the staged infer outputs of this module")
    t_dir, _ = infer_outputs["staged"]
    args = ["eval", "--submission", os.path.join(t_dir, "inference_best_preds.jsonl"),
            "--gt", workdir["jsonl"], "--dset", "ego4d", "--title", "Fusion",
            "--thresholds", "0.01", "0.3", "--topK", "1", "5"]
    t_main(args + ["--out", str(tmp_path / "table.txt")])
    t_out = capsys.readouterr().out
    j_main(args)
    j_out = capsys.readouterr().out
    assert t_out == j_out and "Rank@1" in t_out and "mIoU" in t_out
    assert (tmp_path / "table.txt").read_text().strip() == t_out.strip()
    # --expect: read the first cell back out of the table and hold the CLI to it
    cells = [c.strip() for c in t_out.strip().splitlines()[-2].strip("|").split("|")]
    t_main(args + ["--expect", f"R1@0.01={cells[0]},mIoU={cells[-1]}", "--expect_tol", "0.01"])
    assert "parity check PASSED" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="FAILED"):
        t_main(args + ["--expect", f"R1@0.01={float(cells[0]) + 7:.2f}"])
    with pytest.raises(SystemExit, match="--submission"):
        t_main(["eval", "--gt", workdir["jsonl"]])


def test_eval_ranklist_mode_gives_equal_tables(workdir, infer_outputs, capsys):
    if "fused" not in infer_outputs:
        pytest.skip("needs the fused infer outputs of this module")
    t_dir, j_dir = infer_outputs["fused"]
    outs = []
    for main, d in ((t_main, t_dir), (j_main, j_dir)):
        main(["eval", "--ranklists", os.path.join(d, "inference_best_windows.jsonl"),
              "--gt", workdir["jsonl"], "--clip_length", "1.0", "--max_v_l", "16",
              "--topK", "1", "3"])
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "Window Pre-filtering" in outs[0]
    cells = [c.strip() for c in outs[0].strip().splitlines()[-2].strip("|").split("|")]
    t_main(["eval", "--ranklists", os.path.join(t_dir, "inference_best_windows.jsonl"),
            "--gt", workdir["jsonl"], "--clip_length", "1.0", "--max_v_l", "16",
            "--topK", "1", "3", "--expect", f"R1={cells[0]},R3={cells[1]}"])
    assert "parity check PASSED" in capsys.readouterr().out


def test_eval_official_ego4d_mode_gives_equal_tables(capsys, tmp_path):
    with open(os.path.join(REPO, "tests", "golden", "eval_ensemble_golden.json")) as f:
        g = json.load(f)["ego4d"]
    with open(tmp_path / "gt.json", "w") as f:
        json.dump(g["ground_truth"], f)
    with open(tmp_path / "sub.json", "w") as f:
        json.dump({"version": "1.0", "results": g["predictions"]}, f)
    outs = []
    for main in (t_main, j_main):
        main(["eval", "--submission", str(tmp_path / "sub.json"),
              "--ego4d_gt", str(tmp_path / "gt.json")])
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "Official Ego4D" in outs[0]


def test_ensemble_gives_equal_rows(workdir, infer_outputs, capsys, tmp_path):
    if not {"staged", "fused"} <= set(infer_outputs):
        pytest.skip("needs the staged and fused infer outputs of this module")
    inputs = [os.path.join(infer_outputs["staged"][0], "inference_best_preds.jsonl"),
              os.path.join(infer_outputs["staged"][1], "inference_best_preds.jsonl"),
              os.path.join(infer_outputs["staged"][0], "inference_best_proposal_preds.jsonl")]
    for main, out in ((t_main, "t.jsonl"), (j_main, "j.jsonl")):
        main(["ensemble", "--inputs", *inputs, "--output", str(tmp_path / out),
              "--max_input", "3"])
        assert f"wrote {workdir['n']} fused rows" in capsys.readouterr().out
    got = load_jsonl(str(tmp_path / "t.jsonl"))
    assert got == load_jsonl(str(tmp_path / "j.jsonl"))
    assert all(len(r["predicted_times"]) == 5 for r in got)


def test_infer_untrained_set_and_debug(workdir, capsys, tmp_path):
    t_main(["infer", "--workdir", workdir["run"], "--untrained", "--fused",
            "--results_dir", str(tmp_path / "u"), "--device", "cpu",
            "--set", "train.debug=true", "--set", "eval.query_chunk=2",
            "--set", "eval.nms_thd=0.4"])
    out = capsys.readouterr().out
    assert "UNTRAINED" in out and "Rank@1" in out
    # debug mode: max(query_chunk, 8) examples
    assert len(load_jsonl(str(tmp_path / "u" / "inference_best_preds.jsonl"))) == 8
    cfg = t_cli._apply_overrides(workdir["cfg"], ["eval.nms_thd=0.4", "train.debug=yes",
                                                  "data.dset_name=mad"])
    assert (cfg.eval.nms_thd, cfg.train.debug, cfg.data.dset_name) == (0.4, True, "mad")


def test_checkpoint_and_evaluate_api(workdir):
    cfg = load_config(workdir["run"])
    assert cfg == workdir["cfg"]
    model, epoch = load_model(workdir["run"], "best", device="cpu")
    assert epoch == 3 and not model.training
    ds = t_cli._open_dataset(cfg, workdir["jsonl"])
    res = evaluate(model, ds, cfg, host_postproc=False, fused=True, device="cpu")
    assert set(res["tables"]) == {"window", "fusion", "proposal", "matching"}
    assert set(res["submissions"]) == {"fusion", "proposal", "matching"}
    assert len(res["ranklists"]) == workdir["n"]
    assert res["stop_score"] == float(np.mean(res["recall_fusion"][0]))
    assert "miou_fusion" in res and res["window_recall"].shape == (5,)
    with pytest.raises(FileNotFoundError, match="convert_ckpt.py --export"):
        load_model(workdir["run"], "latest", device="cpu")
    a, b = (build_family(cfg, seed=7, device="cpu") for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
    tan = cfg.replace(model=ModelConfig(model_family="tan"))
    with pytest.raises(ValueError, match="TAN geometry"):   # 64 map cells in another window
        build_family(tan, seed=0, device="cpu")
    tan = tan.replace(data=dataclasses.replace(tan.data, max_v_l=64))
    assert type(build_family(tan, seed=0, device="meta")).__name__ == "ConeTanModel"


def test_what_waits_raises_and_names_its_roadmap_item(workdir):
    with pytest.raises(NotImplementedError, match="Queue 1 item 14"):
        t_cli._open_store(str(workdir["root"] / "features"))  # an LMDB directory
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):   # tensor parallel waits
        t_main(["train", "--workdir", workdir["run"], "--preset", "tan_ego4d",
                "--set", "train.tp_devices=2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):  # the default device is the card
            t_main(["infer", "--workdir", workdir["run"]])
        with pytest.raises(RuntimeError, match="cuda"):
            evaluate(None, None, workdir["cfg"])


def test_tan_trains_on_a_mesh(tmp_path):
    """`train --preset tan_ego4d --mesh` (narrowed): data parallel over a
    group of this one rank trains the same 2D-TAN run as one device."""
    sets = ["tan.hidden_size=16", "tan.txt_hidden_size=16", "tan.lstm_layers=1",
            "tan.map_hidden_sizes=16,16,16,16", "tan.map_kernel_sizes=3,3,3,3",
            "tan.map_paddings=4,0,0,0",
            "model.v_appear_feat_dim=16", "model.v_motion_feat_dim=16", "tan.v_feat_dim=16",
            "train.bsz=8", "train.n_epoch=1", "train.eval_epoch_interval=1",
            "train.start_epoch_for_adapter=0", "data.topk_window=4", "eval.query_chunk=8",
            "data.dset_name=synthetic"]
    runs = []
    for extra in ([], ["--mesh"]):
        wd = str(tmp_path / f"run{len(runs)}")
        t_main(["train", "--preset", "tan_ego4d", "--synthetic", "--debug", "--device", "cpu",
                "--workdir", wd] + [x for kv in sets for x in ("--set", kv)] + extra)
        runs.append(load_jsonl(os.path.join(wd, "metrics.jsonl")))
    assert not torch.distributed.is_initialized()
    assert runs[1][0]["parallel"] == {"world_size": 1, "backend": "gloo"}
    epochs = [[r for r in run if r["kind"] == "train_epoch"] for run in runs]
    assert "loss_adapter" in epochs[1][0]
    for a, b in zip(*epochs):
        assert {k: v for k, v in a.items() if k.startswith("loss")} == \
            {k: v for k, v in b.items() if k.startswith("loss")}
