"""JAX workdirs read by the port, on the CPU: the flax-msgpack decoder
(cone_tpu_torch/train/jax_workdir.py) and checkpoint.load_model /
load_params on cone_tpu's own files, for both model families.

  * the decoder against flax.serialization.msgpack_restore, leaf for leaf
    and exactly (type, dtype, shape, value): a CheckpointManager file with
    its optax state and extra dict, a raw {"params": ...} file
    (tools/convert_ckpt.py --out), a chunked leaf, a bfloat16 leaf (widened
    exactly to float32), and what it refuses;
  * `infer` of the port on a workdir that cone_tpu's CheckpointManager
    wrote (config.json + model_best.msgpack, no torch file), CONE and
    2D-TAN, against cone_tpu's `infer` CLI on the same workdir: equal
    ranklists, kept moments within spans atol 1e-3 / scores atol 2e-3
    (tests/test_torch_cli.py's test_infer_matches_cone_tpu_cli limits);
  * `train --init_ckpt` of a .msgpack: the same weights as the file;
  * a workdir that cone_tpu's `train --preset ego4d_scratch` wrote
    (bfloat16 compute, 2 heads), narrowed: the port's `infer` against
    cone_tpu's, equal ranklists, moments within tests/test_torch_bf16.py's
    limits.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization as fs
from jax.experimental import pallas as pl

from cone_tpu.cli import main as j_main
from cone_tpu.config import ConeConfig as JConeConfig
from cone_tpu.train.checkpoint import CheckpointManager
from cone_tpu_torch.cli import main as t_main
from cone_tpu_torch.config import ConeConfig, DataConfig, EvalConfig, ModelConfig, TanConfig
from cone_tpu_torch.convert import (
    params_from_jax, params_to_jax, random_reference_state_dict, random_reference_tan_state_dict,
    tan_params_from_jax, tan_params_to_jax,
)
from cone_tpu_torch.data import make_synthetic_dataset, write_packed_store
from cone_tpu_torch.models.tan import ConeTanModel
from cone_tpu_torch.train import jax_workdir as jw
from cone_tpu_torch.train.checkpoint import load_model, load_params
from cone_tpu_torch.train.loop import build_family
from cone_tpu_torch.utils.io import load_jsonl, save_jsonl

DIM = 32
SPAN_ATOL, SCORE_ATOL = 1e-3, 2e-3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    # cone_tpu's Pallas coarse kernel runs in interpret mode on the CPU
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call", lambda *a, **k: orig(*a, **{**k, "interpret": True}))


# ------------------------------------------------------------ decoder

def _same(want, got, path="root"):
    """flax's tree == ours: the same containers, keys in order, leaf types,
    dtypes, shapes and values (bfloat16 leaves widened to float32)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(want) == list(got), path
        for k in want:
            _same(want[k], got[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(want) == len(got), path
        for i, (a, b) in enumerate(zip(want, got)):
            _same(a, b, f"{path}[{i}]")
    elif isinstance(want, (np.ndarray, np.generic)):
        if want.dtype == jnp.bfloat16:
            assert isinstance(got, np.ndarray) and got.dtype == np.float32, path
            np.testing.assert_array_equal(np.asarray(want, np.float32), got, err_msg=path)
            return
        assert type(want) is type(got) and want.dtype == got.dtype, (path, want, got)
        assert np.shape(want) == np.shape(got), path
        np.testing.assert_array_equal(want, got, err_msg=path)
    else:
        assert type(want) is type(got) and want == got, (path, want, got)


def _manager_file(tmp_path, params, with_opt=True):
    tx = optax.adamw(1e-4)
    CheckpointManager(str(tmp_path), None).save(
        "best", params, tx.init(params) if with_opt else None, epoch=5,
        extra={"best_score": 0.25, "es_cnt": 2})
    return (tmp_path / "model_best.msgpack").read_bytes()


def test_decoder_equals_flax_on_a_manager_file(tmp_path):
    mcfg = _cone_cfg().model
    params = params_to_jax(random_reference_state_dict(mcfg, seed=0), mcfg)
    data = _manager_file(tmp_path, params)
    want, got = fs.msgpack_restore(data), jw.msgpack_restore(data)
    _same(want, got)
    assert set(got) == {"params", "opt_state", "epoch", "extra"}
    assert type(got["epoch"]) is np.int32 and got["epoch"] == 5
    assert got["extra"] == {"best_score": 0.25, "es_cnt": 2.0}
    assert jw.msgpack_restore(_manager_file(tmp_path, params, with_opt=False))["opt_state"] is None


def test_decoder_equals_flax_on_a_raw_params_file_with_every_type(monkeypatch):
    rng = np.random.default_rng(0)
    tree = {"params": {"dense": {"kernel": rng.normal(size=(3, 5)).astype(np.float32),
                                 "bias": np.zeros(5, np.float32)},
                       "embed": rng.normal(size=(40,)).astype(np.float32),   # chunked
                       "half": rng.normal(size=(2, 2)).astype(np.float16),
                       "bf16": jnp.asarray(rng.normal(size=(4,)), jnp.bfloat16),
                       "ints": np.arange(6, dtype=np.int64).reshape(2, 3),
                       "empty": np.zeros((0, 3), np.float32)},
            "meta": {"step": np.int64(-3), "lr": np.float32(0.5), "flag": True, "none": None,
                     "name": "é" * 40, "blob": b"\x00\xff" * 20, "n": [1, -1, 2 ** 40, -2 ** 40,
                                                                     300, -200, 1.5,
                                                                     [{"deep": 7}]]}}
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 64)   # 160-byte "embed" -> 3 chunks
    data = fs.msgpack_serialize(tree)
    monkeypatch.undo()
    assert b"__msgpack_chunked_array__" in data
    _same(fs.msgpack_restore(data), jw.msgpack_restore(data))


@pytest.mark.parametrize("case,match", [
    ("complex", "extension type 2"), ("ext5", "extension type 5"), ("int_key", "map key"),
    ("trailing", "bytes after"), ("truncated", "truncated"), ("reserved", "0xc1"),
])
def test_decoder_refuses_what_flax_does_not_write(case, match):
    import msgpack

    data = {"complex": lambda: fs.msgpack_serialize({"c": 1 + 2j}),
            "ext5": lambda: msgpack.packb({"x": msgpack.ExtType(5, b"ab")}),
            "int_key": lambda: msgpack.packb({1: 2}),
            "trailing": lambda: msgpack.packb({"a": 1}) + b"\x00",
            "truncated": lambda: msgpack.packb({"a": "abcdef"})[:-2],
            "reserved": lambda: b"\xc1"}[case]()
    with pytest.raises(jw.MsgpackError, match=match):
        jw.msgpack_restore(data)


# -------------------------------------------------- workdirs and infer

def _write_data(root, cfg, **synth):
    """.cfs stores + an eval jsonl of one synthetic set; cfg pointed at them."""
    ds = make_synthetic_dataset(cfg.data, dim=DIM, signal=2.0, **synth)
    text = root / "features" / "text"
    os.makedirs(text)
    write_packed_store(str(root / "features" / "video.cfs"),
                       {v: ds.video_features(v)[0] for v in ds.video_ids})
    write_packed_store(str(text / "tokens.cfs"),
                       {e.query_id: ds.text.get_tokens(e.query_id) for e in ds.examples})
    write_packed_store(str(text / "cls.cfs"),
                       {e.query_id: ds.text.get_cls(e.query_id)[None] for e in ds.examples})
    save_jsonl([e.__dict__ for e in ds.examples], str(root / "eval.jsonl"))
    return cfg.replace(data=dataclasses.replace(
        cfg.data, appearance_feat_dir=str(root / "features" / "video.cfs"),
        t_feat_dir=str(text), eval_path=str(root / "eval.jsonl"))), len(ds.examples)


def _cone_cfg():
    return ConeConfig(
        model=ModelConfig(hidden_dim=32, nheads=4, enc_layers=1, dec_layers=1,
                          dim_feedforward=64, t_feat_dim=DIM, v_motion_feat_dim=DIM,
                          v_appear_feat_dim=DIM, max_q_l=8, max_v_l=16),
        data=DataConfig(dset_name="synthetic", max_v_l=16, max_q_l=8, clip_length=1.0,
                        topk_window=4, max_ctx_l=128),
        eval=EvalConfig(query_chunk=4))


def _tan_cfg():
    """tests/test_torch_tan_pipeline.py's geometry: a 32x32 map, hidden 48,
    the coarse stage on."""
    nc = 32
    return ConeConfig(
        model=ModelConfig(model_family="tan", t_feat_dim=DIM, v_appear_feat_dim=DIM,
                          v_motion_feat_dim=DIM, max_q_l=8, max_v_l=nc),
        tan=TanConfig(num_clips=nc, hidden_size=48, v_feat_dim=DIM, t_feat_dim=DIM,
                      txt_hidden_size=48, lstm_layers=2, num_scale_layers=(8, 4),
                      map_hidden_sizes=(48, 48), map_kernel_sizes=(5, 5), map_paddings=(4, 0),
                      proposal_top_k=5),
        data=DataConfig(dset_name="synthetic", max_v_l=nc, max_q_l=8, clip_length=1.0,
                        topk_window=4, max_ctx_l=256),
        eval=EvalConfig(query_chunk=4, use_pallas_coarse=True))


@pytest.fixture(scope="module", params=["cone", "tan"])
def jax_workdir(request, tmp_path_factory):
    """A workdir written by cone_tpu alone: config.json + model_best.msgpack
    (with its optax state), model_e0001.msgpack (params only, no opt
    state), and the feature stores it evaluates on."""
    root = tmp_path_factory.mktemp(request.param)
    cfg, n = _write_data(root, _cone_cfg() if request.param == "cone" else _tan_cfg(),
                         n_videos=3, queries_per_video=3,
                         ctx_l_range=(50, 110) if request.param == "cone" else (90, 180),
                         seed=0)
    jcfg = JConeConfig.from_json(cfg.to_json())
    # seeded weights in cone_tpu's tree layout, written by cone_tpu's manager
    params = (tan_params_to_jax(random_reference_tan_state_dict(cfg.tan, seed=3), cfg.tan)
              if request.param == "tan" else
              params_to_jax(random_reference_state_dict(cfg.model, seed=3), cfg.model))
    run = root / "run"
    mgr = CheckpointManager(str(run), jcfg)
    mgr.save("best", params, optax.adam(1e-3).init(params), epoch=3, extra={"best_score": 0.5})
    mgr.save("e0001", params, None, epoch=1)
    with open(root / "params.msgpack", "wb") as f:   # tools/convert_ckpt.py --out's layout
        f.write(fs.msgpack_serialize({"params": params}))
    return dict(family=request.param, root=root, run=str(run), cfg=cfg, params=params, n=n)


def _rows_close(got, want):
    assert [r["query_id"] for r in got] == [r["query_id"] for r in want]
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k != "predicted_times"} == {
            k: v for k, v in w.items() if k != "predicted_times"}
        a, b = np.asarray(g["predicted_times"]), np.asarray(w["predicted_times"])
        assert a.shape == b.shape and a.shape[0] >= 1, g["query_id"]
        np.testing.assert_allclose(a[:, :2], b[:, :2], atol=SPAN_ATOL)
        np.testing.assert_allclose(a[:, 2:], b[:, 2:], atol=SCORE_ATOL)


def test_infer_on_a_jax_workdir_matches_cone_tpu_cli(jax_workdir, capsys):
    wd = jax_workdir
    assert not [f for f in os.listdir(wd["run"]) if f.endswith(".ckpt")]
    t_dir, j_dir = (str(wd["root"] / p) for p in ("t", "j"))
    base = ["infer", "--workdir", wd["run"], "--ckpt", "best", "--save_all"]
    t_main(base + ["--results_dir", t_dir, "--device", "cpu"])
    t_out = capsys.readouterr().out
    j_main(base + ["--results_dir", j_dir])
    j_out = capsys.readouterr().out
    assert "restored 'best' (epoch 3)" in t_out and "restored 'best' (epoch 3)" in j_out
    names = sorted(os.listdir(t_dir))
    assert names == sorted(os.listdir(j_dir)) and "inference_best_windows.jsonl" in names
    assert (load_jsonl(os.path.join(t_dir, "inference_best_windows.jsonl"))
            == load_jsonl(os.path.join(j_dir, "inference_best_windows.jsonl")))
    for name in names:
        if name.endswith("preds.jsonl"):
            got = load_jsonl(os.path.join(t_dir, name))
            assert len(got) == wd["n"]
            _rows_close(got, load_jsonl(os.path.join(j_dir, name)))


def _expected_state_dict(wd):
    cfg = wd["cfg"]
    return (tan_params_from_jax(wd["params"], cfg.tan) if wd["family"] == "tan"
            else params_from_jax(wd["params"], cfg.model))


def test_load_model_and_init_ckpt_read_the_jax_weights(jax_workdir):
    wd = jax_workdir
    want = _expected_state_dict(wd)
    for tag, epoch in (("best", 3), ("e0001", 1)):
        model, got_epoch = load_model(wd["run"], tag, device="cpu")
        assert got_epoch == epoch and not model.training
        assert isinstance(model, ConeTanModel) == (wd["family"] == "tan")
        sd = model.state_dict()
        assert sd.keys() == want.keys()
        for k in want:
            assert torch.equal(sd[k], want[k]), k
    for path in (os.path.join(wd["run"], "model_best.msgpack"), str(wd["root"] / "params.msgpack")):
        model = build_family(wd["cfg"], seed=11, device="cpu")
        load_params(path, model)
        assert all(torch.equal(v, want[k]) for k, v in model.state_dict().items())
    with pytest.raises(FileNotFoundError, match="model_latest.ckpt.*model_latest.msgpack"):
        load_model(wd["run"], "latest", device="cpu")


def test_train_init_ckpt_takes_a_msgpack(jax_workdir, tmp_path):
    """`train --init_ckpt model_best.msgpack`: the run starts from the JAX
    weights (one epoch at lr 0 keeps them, bit for bit)."""
    wd = jax_workdir
    out = str(tmp_path / "run")
    sets = {"train.n_epoch": 1, "train.bsz": 4, "train.lr": 0.0, "train.debug": "true",
            "train.eval_epoch_interval": 5, "train.save_interval": 1,
            "data.dset_name": "synthetic",
            "data.train_path": wd["cfg"].data.eval_path}
    cfg = wd["cfg"].replace(train=dataclasses.replace(wd["cfg"].train, n_epoch=1))
    cfg.save(str(tmp_path / "cfg.json"))
    argv = ["train", "--config", str(tmp_path / "cfg.json"), "--workdir", out, "--device", "cpu",
            "--init_ckpt", os.path.join(wd["run"], "model_best.msgpack")]
    for k, v in sets.items():
        argv += ["--set", f"{k}={v}"]
    t_main(argv)
    sd = torch.load(os.path.join(out, "model_e0000.ckpt"), weights_only=True)["model"]
    for k, v in _expected_state_dict(wd).items():
        assert torch.equal(sd[k], v), k


def test_infer_on_a_jax_scratch_workdir_matches_cone_tpu(tmp_path, capsys):
    """A workdir that cone_tpu's own `train --preset ego4d_scratch` wrote
    (narrowed: hidden 32, 2 heads, 2+2 layers; bfloat16 compute, float32
    model_latest.msgpack) through the port's `infer`, against cone_tpu's
    `infer` on it: equal window ranklists, at least half of cone_tpu's
    moments found to the bit (tests/test_torch_bf16.py), their matching
    scores within 1e-2."""
    from tests.test_torch_bf16 import assert_bf16_moments, moment_agreement

    sets = ["model.hidden_dim=32", "model.dim_feedforward=64", f"model.t_feat_dim={DIM}",
            f"model.v_motion_feat_dim={DIM}", f"model.v_appear_feat_dim={DIM}",
            "model.max_v_l=16", "model.max_q_l=8", "data.dset_name=synthetic",
            "data.max_v_l=16", "data.max_q_l=8", "data.clip_length=1.0",
            "data.topk_window=4", "data.max_ctx_l=512", "train.n_epoch=1",
            "train.eval_epoch_interval=1", "train.bsz=8", "eval.query_chunk=4"]
    run = str(tmp_path / "run")
    j_main(["train", "--preset", "ego4d_scratch", "--synthetic", "--debug", "--workdir", run]
           + [x for kv in sets for x in ("--set", kv)])
    assert not [f for f in os.listdir(run) if f.endswith(".ckpt")]
    cfg = ConeConfig.load(os.path.join(run, "config.json"))
    assert (cfg.model.compute_dtype, cfg.model.nheads, cfg.model.seq_pad_multiple) == (
        "bfloat16", 2, 16)
    data_cfg, n = _write_data(tmp_path, cfg, n_videos=3, queries_per_video=3,
                              ctx_l_range=(50, 110), seed=0)
    d = data_cfg.data
    base = ["infer", "--workdir", run, "--ckpt", "latest", "--save_all",
            "--eval_path", d.eval_path,
            "--set", f"data.appearance_feat_dir={d.appearance_feat_dir}",
            "--set", f"data.t_feat_dir={d.t_feat_dir}", "--set", "train.debug=false"]
    t_dir, j_dir = str(tmp_path / "t"), str(tmp_path / "j")
    t_main(base + ["--results_dir", t_dir, "--device", "cpu"])
    j_main(base + ["--results_dir", j_dir])
    capsys.readouterr()
    names = sorted(os.listdir(t_dir))
    assert names == sorted(os.listdir(j_dir)) and "inference_latest_windows.jsonl" in names
    assert (load_jsonl(os.path.join(t_dir, "inference_latest_windows.jsonl"))
            == load_jsonl(os.path.join(j_dir, "inference_latest_windows.jsonl")))
    preds = [name for name in names if name.endswith("preds.jsonl")]
    got = {name: load_jsonl(os.path.join(t_dir, name)) for name in preds}
    want = {name: load_jsonl(os.path.join(j_dir, name)) for name in preds}
    assert len(preds) == 3 and all(len(rows) == n for rows in got.values())
    modality = {"inference_latest_preds.jsonl": "fusion",
                "inference_latest_proposal_preds.jsonl": "proposal",
                "inference_latest_matching_preds.jsonl": "matching"}
    agree = moment_agreement({modality[k]: v for k, v in got.items()},
                             {modality[k]: v for k, v in want.items()},
                             d.max_v_l * d.clip_length)
    print("moments against cone_tpu's infer:", agree)
    # the staged path's spans are equal in 4-dp seconds, not in the window
    # fractions it pools: a span a bfloat16 step apart below that may pool
    # one clip more or less, so the matching score is held at 1e-2
    assert_bf16_moments(agree, score_atol=1e-2)
