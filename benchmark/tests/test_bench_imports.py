"""What a run loads: no module whose top-level name is jax, jaxlib, flax or
the JAX package (compared whole: `cone_tpu_torch` is the port), and a
reference that imports nothing of the port."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

from benchmark import manifest
from benchmark.harness import FORBIDDEN, forbidden_modules

ROOT = manifest.ROOT


def test_whole_name_compare():
    sys.modules["cone_tpu_torch_probe.sub"] = sys
    try:
        assert "cone_tpu_torch_probe" not in forbidden_modules()
    finally:
        del sys.modules["cone_tpu_torch_probe.sub"]
    assert set(FORBIDDEN) == {"jax", "jaxlib", "flax", "cone_tpu"}


def test_a_whole_run_loads_no_jax():
    """Every traffic driver and reader imported and a tiny run driven, in a
    fresh process; then sys.modules is searched by whole top-level names."""
    code = (
        "import json, sys, time, torch\n"
        "torch.set_num_threads(2)\n"
        "import benchmark.run, benchmark.control, benchmark.sweep_rate\n"
        "from benchmark import manifest\n"
        "from benchmark.tests.conftest import tiny_run\n"
        "man = manifest.load()\n"
        "for w in man['workloads']: manifest.driver(manifest.traffic(w['traffic'])['kind'])\n"
        "for m in man['per_layer']: manifest.reader(m['name'])\n"
        "tiny_run('ego4d-nlq-val', trace=True, seconds=0.2)\n"
        "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "cone_tpu_torch" in top and not top & set(FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    for path in sorted((ROOT / "benchmark" / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in ("cone_tpu_torch", *FORBIDDEN), (path.name, n)
    code = ("import sys, benchmark.reference.cone, benchmark.reference.grounding, "
            "benchmark.reference.train, benchmark.reference.search\n"
            "print(sorted({n.split('.')[0] for n in sys.modules} & "
            "{'cone_tpu_torch', 'cone_tpu', 'jax', 'flax'}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
