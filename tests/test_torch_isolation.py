"""The port stands alone: `import cone_tpu_torch` (every module of it, the
serving path, the CLI and the tools included) loads neither jax, flax,
msgpack, lmdb, h5py nor cone_tpu, no source under cone_tpu_torch/ or
chip_smoke.py imports them (but for the optional-package lines in
ALLOWED), and the entry points default to the card and raise without one
instead of carrying on elsewhere."""

import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

from cone_tpu_torch.config import ModelConfig, ego4d_config
from cone_tpu_torch.data import make_synthetic_dataset
from cone_tpu_torch.eval.pipeline import InferencePipeline
from cone_tpu_torch.models.cone import ConeModel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "cone_tpu_torch")
FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|msgpack|lmdb|h5py|cone_tpu)(\.|\s|$)")
# (file, import line) -> why it may stand: optional packages the card's
# machine lacks, imported only inside the one branch that reads their format
ALLOWED = {
    ("cone_tpu_torch/data/store.py", "import lmdb"):
        "LmdbArrayStore.__init__: a reference LMDB database is read only there",
    ("cone_tpu_torch/cli.py", "import h5py   # optional: only this branch needs it"):
        "cmd_convert_store's --format h5 branch",
}
# a video's host copy belongs to the dataset, its device copy to the resident
# library: these private names appear in their owner's file and nowhere else
OWNER_OF_PRIVATE = {
    "_vid_cache": "cone_tpu_torch/data/dataset.py",
    "_pinned": "cone_tpu_torch/data/dataset.py",
    **{name: "cone_tpu_torch/eval/resident.py" for name in (
        "_dev_cache", "_device_video", "_encode_corpus", "_padded_video", "_bucket_len")},
}
SOURCES = [os.path.join(REPO, "chip_smoke.py")] + sorted(
    os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs if f.endswith(".py"))
NEW_MODULES = [
    "cone_tpu_torch.__main__", "cone_tpu_torch.cli", "cone_tpu_torch.eval.ensemble",
    "cone_tpu_torch.eval.metrics", "cone_tpu_torch.eval.submission",
    "cone_tpu_torch.ops.attention", "cone_tpu_torch.serve.corpus",
    "cone_tpu_torch.serve.localizer", "cone_tpu_torch.serve.server",
    "cone_tpu_torch.tools.bench_attn", "cone_tpu_torch.train.checkpoint",
    "cone_tpu_torch.train.loop", "cone_tpu_torch.ops.matching",
    "cone_tpu_torch.models.losses", "cone_tpu_torch.train.optim",
    "cone_tpu_torch.train.step", "cone_tpu_torch.utils.logging",
    "cone_tpu_torch.models.tan", "cone_tpu_torch.eval.tan_pipeline",
    "cone_tpu_torch.train.tan_step", "cone_tpu_torch.tools.golden_tan_train",
    "cone_tpu_torch.parallel.distributed", "cone_tpu_torch.parallel.mesh",
    "cone_tpu_torch.tools.dist_worker", "cone_tpu_torch.tools.bench_dp_step",
    "cone_tpu_torch.models.dropout", "cone_tpu_torch.models.clip",
    "cone_tpu_torch.models.egovlp", "cone_tpu_torch.extract.video",
    "cone_tpu_torch.extract.egovlp_video", "cone_tpu_torch.extract.text",
    "cone_tpu_torch.serve.predictor", "cone_tpu_torch.data.native_store",
    "cone_tpu_torch.data.multiscale", "cone_tpu_torch.data.reformat",
    "cone_tpu_torch.train.jax_workdir", "cone_tpu_torch.tools.parity",
    "cone_tpu_torch.utils.perf"]


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages([PKG], "cone_tpu_torch."))


def test_import_loads_no_jax_and_no_cone_tpu():
    code = (
        "import importlib, sys\n"
        f"mods = {_modules()!r}\n"
        "for m in ['cone_tpu_torch'] + mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'lmdb', 'h5py', 'cone_tpu'))\n"
        "assert not bad, bad\n"
        "from cone_tpu_torch.kernels import build\n"
        "assert build.load_library.cache_info().currsize == 0  # nothing built or loaded\n"
        "print(len(mods))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15 + len(NEW_MODULES)


def test_every_module_imports_without_transformers():
    """Every module of the port imports where transformers is absent (the
    towers import it only where a released model or tokenizer is loaded by
    name), as on a GPU machine without it."""
    code = (
        "import importlib, sys\n"
        "sys.modules['transformers'] = None\n"
        f"mods = {_modules()!r}\n"
        "for m in ['cone_tpu_torch'] + mods:\n"
        "    importlib.import_module(m)\n"
        "try:\n"
        "    import transformers\n"
        "except ImportError:\n"
        "    print(len(mods))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15 + len(NEW_MODULES)


def test_the_walk_finds_the_serving_slice():
    assert set(NEW_MODULES) <= set(_modules())


@pytest.mark.parametrize("path", SOURCES)
def test_sources_import_no_jax_and_no_cone_tpu(path):
    rel = os.path.relpath(path, REPO)
    with open(path) as f:
        hits = [line.strip() for line in f if FORBIDDEN.match(line)]
    hits = [h for h in hits if (rel, h) not in ALLOWED]
    assert not hits, (rel, hits)


@pytest.mark.parametrize("name", sorted(OWNER_OF_PRIVATE))
def test_video_caches_are_named_only_by_their_owner(name):
    """The pipeline, the retriever, the server and the tools reach a
    video's copies through the dataset's and eval/resident.py's public
    methods, never through these names."""
    hits = []
    for path in SOURCES:
        rel = os.path.relpath(path, REPO)
        if rel != OWNER_OF_PRIVATE[name]:
            with open(path) as f:
                hits += [f"{rel}:{i}" for i, line in enumerate(f, 1) if name in line]
    assert not hits, hits


def test_allowed_optional_imports_are_still_where_they_are_said_to_be():
    for rel, line in ALLOWED:
        with open(os.path.join(REPO, rel)) as f:
            assert line in (x.strip() for x in f), (rel, line)


def test_default_device_is_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    cfg = ego4d_config()
    with pytest.raises(RuntimeError, match="cuda"):
        ConeModel(cfg.model)
    model = ConeModel(ModelConfig(hidden_dim=32, nheads=4, dim_feedforward=64), device="cpu")
    ds = make_synthetic_dataset(cfg.data, n_videos=1, queries_per_video=1, dim=256)
    with pytest.raises(RuntimeError, match="cuda"):
        InferencePipeline(model, ds, cfg)


@pytest.mark.parametrize("entry", ["localizer", "retriever", "service", "evaluate",
                                   "build_family", "load_model", "cli_infer", "cli_serve",
                                   "bench_attn", "train", "cli_train", "tan_model",
                                   "tan_build_family", "tan_pipeline", "tan_cli_train",
                                   "golden_tan_train", "cli_train_mesh", "dist_initialize",
                                   "dist_worker", "clip_vision_tower", "clip_text_tower",
                                   "egovlp_tower", "predictor", "extract_clip_text",
                                   "extract_egovlp_video", "cli_demo", "cli_extract_video",
                                   "parity"])
def test_serving_entry_points_default_to_the_card(entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from cone_tpu_torch import cli
    from cone_tpu_torch.config import ConeConfig
    from cone_tpu_torch.serve.corpus import CorpusRetriever
    from cone_tpu_torch.serve.localizer import OnlineLocalizer
    from cone_tpu_torch.serve.server import MomentService
    from cone_tpu_torch.tools import bench_attn
    from cone_tpu_torch.train.checkpoint import load_model
    from cone_tpu_torch.data import make_synthetic_dataset
    from cone_tpu_torch.train.loop import build_family, evaluate, train
    from cone_tpu_torch.config import TanConfig, tan_ego4d_config
    from cone_tpu_torch.eval.tan_pipeline import TanInferencePipeline
    from cone_tpu_torch.models.tan import ConeTanModel
    from cone_tpu_torch.tools import dist_worker, golden_tan_train, parity
    from cone_tpu_torch.parallel import distributed
    from cone_tpu_torch.extract.egovlp_video import extract_egovlp_video
    from cone_tpu_torch.extract.text import extract_clip_text
    from cone_tpu_torch.models.clip import ClipTextTower, ClipVisionTower
    from cone_tpu_torch.models.egovlp import EgoVlpVideoTower
    from cone_tpu_torch.serve.predictor import MomentPredictor

    tan_cfg = tan_ego4d_config()
    tan_cfg = tan_cfg.replace(tan=TanConfig(hidden_size=8, v_feat_dim=32, t_feat_dim=32,
                                            txt_hidden_size=8, lstm_layers=1,
                                            map_hidden_sizes=(8,), map_kernel_sizes=(3,),
                                            map_paddings=(1,)))
    tan_model = ConeTanModel(tan_cfg.tan, device="cpu")

    mcfg = ModelConfig(hidden_dim=32, nheads=4, dim_feedforward=64, t_feat_dim=32,
                       v_motion_feat_dim=32, v_appear_feat_dim=32)
    cfg = ConeConfig(model=mcfg)
    model = ConeModel(mcfg, device="cpu")
    cfg.save(str(tmp_path / "config.json"))
    torch.save({"model": model.state_dict(), "epoch": 1}, str(tmp_path / "model_best.ckpt"))
    calls = {
        "localizer": lambda: OnlineLocalizer(model, cfg),
        "retriever": lambda: CorpusRetriever(model, cfg),
        "service": lambda: MomentService(model, cfg),
        "evaluate": lambda: evaluate(model, None, cfg),
        "build_family": lambda: build_family(cfg, seed=0),
        "load_model": lambda: load_model(str(tmp_path)),
        "cli_infer": lambda: cli.main(["infer", "--workdir", str(tmp_path), "--untrained"]),
        "cli_serve": lambda: cli.main(["serve", "--workdir", str(tmp_path)]),
        "bench_attn": lambda: bench_attn.main([]),
        "train": lambda: train(cfg, make_synthetic_dataset(cfg.data, dim=32), None,
                               str(tmp_path / "run")),
        "cli_train": lambda: cli.main(["train", "--synthetic", "--workdir",
                                       str(tmp_path / "run")]),
        "tan_model": lambda: ConeTanModel(tan_ego4d_config().tan),
        "tan_build_family": lambda: build_family(tan_ego4d_config(), seed=0),
        "tan_pipeline": lambda: TanInferencePipeline(
            tan_model, make_synthetic_dataset(tan_cfg.data, dim=32), tan_cfg, tan_cfg.tan),
        "tan_cli_train": lambda: cli.main(["train", "--preset", "tan_ego4d", "--synthetic",
                                           "--workdir", str(tmp_path / "tan")]),
        "golden_tan_train": lambda: golden_tan_train.main([]),
        # a rank's device is the card unless the caller asks for the CPU,
        # whatever the backend
        "cli_train_mesh": lambda: cli.main(["train", "--synthetic", "--mesh", "--workdir",
                                            str(tmp_path / "mesh")]),
        "dist_initialize": lambda: distributed.initialize(num_processes=1, process_id=0),
        "dist_worker": lambda: dist_worker.main(["--out", str(tmp_path / "w")]),
        "clip_vision_tower": lambda: ClipVisionTower(),
        "clip_text_tower": lambda: ClipTextTower(),
        "egovlp_tower": lambda: EgoVlpVideoTower(),
        "predictor": lambda: MomentPredictor(model, cfg, cache_dir=str(tmp_path / "c")),
        "extract_clip_text": lambda: extract_clip_text(
            str(tmp_path / "q.jsonl"), str(tmp_path / "t"), _model=object(),
            _tokenizer=object()),
        "extract_egovlp_video": lambda: extract_egovlp_video(
            {}, str(tmp_path / "v.cfs"), str(tmp_path / "e.pth")),
        "cli_demo": lambda: cli.main(["demo", "--workdir", str(tmp_path), "--video", "v.mp4",
                                      "--query", "q", "--cache_dir", str(tmp_path / "c")]),
        "cli_extract_video": lambda: cli.main(["extract-video", "--videos", "v.mp4", "--out",
                                               str(tmp_path / "v.cfs"), "--backend", "egovlp",
                                               "--checkpoint", "e.pth"]),
        # the chain's `infer` stage: the stores are linked, not read, before it
        "parity": lambda: parity.main(["mad", str(tmp_path / "parity"), "gt.jsonl",
                                       str(tmp_path / "model_best.ckpt"), "v.cfs", "t.cfs",
                                       "c.cfs", "--src_format", "cfs"]),
    }
    with pytest.raises(RuntimeError, match="cuda"):
        calls[entry]()
    assert not torch.distributed.is_initialized()
    # the same workdir loads when the caller asks for the CPU
    if entry == "load_model":
        assert load_model(str(tmp_path), device="cpu")[1] == 1
