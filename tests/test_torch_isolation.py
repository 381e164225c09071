"""The port stands alone: `import cone_tpu_torch` (every module of it)
loads neither jax nor cone_tpu, no source under cone_tpu_torch/ or
chip_smoke.py imports them, and the entry points default to the card and
raise without one instead of carrying on elsewhere."""

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
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|cone_tpu)(\.|\s|$)", re.M)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages([PKG], "cone_tpu_torch."))


def test_import_loads_no_jax_and_no_cone_tpu():
    code = (
        "import importlib, sys\n"
        f"mods = {_modules()!r}\n"
        "for m in ['cone_tpu_torch'] + mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'cone_tpu'))\n"
        "assert not bad, bad\n"
        "from cone_tpu_torch.kernels import build\n"
        "assert build.load_library.cache_info().currsize == 0  # nothing built or loaded\n"
        "print(len(mods))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


@pytest.mark.parametrize("path", [os.path.join(REPO, "chip_smoke.py")] + sorted(
    os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs if f.endswith(".py")))
def test_sources_import_no_jax_and_no_cone_tpu(path):
    with open(path) as f:
        hits = FORBIDDEN.findall(f.read())
    assert not hits, (os.path.relpath(path, REPO), hits)


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
