"""Build the port's CUDA kernels at first use and load them with ctypes.

Each `cone_tpu_torch/csrc/<name>.cu` compiles with nvcc, on its own, into
a shared library with a plain C interface:

    cone_tpu_torch/_build/<name>-<hash>.so

where <hash> covers the sources under csrc/ and the compiler flags, so an
edited source rebuilds and an unchanged one is reused. All missing
libraries build in parallel (one nvcc per source, started together). The
build directory is listed in .gitignore. Nothing is imported or compiled
when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, $PATH or /usr/local/cuda, else raise."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    if shutil.which("nvcc"):
        candidates.append(shutil.which("nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels build only on a machine with the "
                       "CUDA toolkit")


def kernel_names():
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):  # .cu and .cuh
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict:
    """Compile every listed kernel (default: all under csrc/) whose library
    is missing, in parallel. Returns {name: library path}; raises with the
    compiler's output if any build fails. The ptxas report (registers,
    shared memory, spills) is kept beside each library as <lib>.log."""
    names = kernel_names() if names is None else list(names)
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for n, p in todo.items():
        tmp = p.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, cmd)
    failed = []
    for n, (proc, tmp, cmd) in procs.items():
        log, _ = proc.communicate()
        paths[n].with_suffix(".log").write_text(" ".join(cmd) + "\n" + log)
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """The built library of kernel `name`, building it first if needed."""
    return ctypes.CDLL(str(build([name])[name]))
