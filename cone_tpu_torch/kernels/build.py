"""Build the port's native libraries at first use and load them with ctypes.

Each `cone_tpu_torch/csrc/<name>.cu` compiles with nvcc, on its own, into
a shared library with a plain C interface:

    cone_tpu_torch/_build/<name>-<hash>.so

where <hash> covers the sources under csrc/ and the compiler flags, so an
edited source rebuilds and an unchanged one is reused. All missing
libraries build in parallel (one nvcc per source, started together).

Host code, `cone_tpu_torch/csrc/<name>.cpp` (the packed-store reader),
compiles with g++ the same way (`build_host`), its hash over its own
source and CXX_FLAGS; it is not one of the CUDA kernels (`kernel_names`)
and needs no card. CXX_FLAGS leave out -march=native, so a library built
on one host runs on another that receives a copy of the build directory.

Every library is published with a temporary file and os.replace, so
processes that build at the same time never load a half-written file.
The build directory is listed in .gitignore. Nothing is imported or
compiled when this module is imported.
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


CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")


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


def host_library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update((CSRC_DIR / f"{name}.cpp").read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_host(name: str) -> Path:
    """Compile csrc/<name>.cpp with g++ ($CXX where set) unless its library
    exists; returns the library's path, or raises with the compiler's
    output. The command and that output are kept beside it as <lib>.log."""
    path = host_library_path(name)
    if path.exists():
        return path
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError(f"{name}: no C++ compiler (set CXX or put g++ on PATH)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cpp")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{name}: {cxx} exited {proc.returncode}\n{' '.join(cmd)}\n"
                           f"{proc.stdout}")
    path.with_suffix(".log").write_text(" ".join(cmd) + "\n" + proc.stdout)
    os.replace(tmp, path)
    return path


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """The built library of `name` (a kernel's .cu, or host code's .cpp),
    building it first if needed."""
    if (CSRC_DIR / f"{name}.cpp").exists():
        return ctypes.CDLL(str(build_host(name)))
    return ctypes.CDLL(str(build([name])[name]))
