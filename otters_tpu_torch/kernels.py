"""Build and load the hand-written Hopper kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ctypes (no PyTorch headers, so a
build takes seconds). Libraries go to ``aot.cache_dir()`` (by default
``build/otters_tpu_torch/``) named by a hash of the source, the shared
headers (``csrc/*.cuh``) and the flags, so an edited source rebuilds and an
unchanged one is reused, by this process or a later one (``aot.stats``
counts the builds as ``compiles`` and the libraries found there as
``disk_hits``). Nothing is built at import: the first launch builds, and
``build`` lets a caller build every kernel up front, one ``nvcc`` per
source, all started together.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable

from . import aot

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# every kernel source of the port, one library each
SOURCES = (
    "cert_cos_binmax", "cert_fold_binmax", "int8_binmax", "f32_binmax", "bf16x3_binmax",
    "bf16_binmax", "profile_probes",
)
_libs: Dict[str, ctypes.CDLL] = {}
# ptxas register / shared-memory report of each build, for the smoke log
build_logs: Dict[str, str] = {}
# nvcc processes started by this process (a warmed server starts none)
nvcc_runs = 0
_built = set()  # the sources this process built (their loads are no disk hits)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(glob.glob(os.path.join(_CSRC, "*.cuh")))
    for path in [os.path.join(_CSRC, f"{name}.cu")] + headers:
        with open(path, "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()
    return os.path.join(aot.cache_dir(), f"lib{name}_{digest[:16]}.so")


def build(names: Iterable[str]) -> None:
    """Compile every named kernel that is not built yet, in parallel.

    Raises with nvcc's output if any build fails."""
    global nvcc_runs
    procs = []
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
        nvcc_runs += 1
        aot.stats["compiles"] += 1
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
            _built.add(name)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it on first use."""
    lib = _libs.get(name)
    if lib is None:
        path = _lib_path(name)
        build([name])
        if name not in _built:
            aot.stats["disk_hits"] += 1
        lib = ctypes.CDLL(path)
        _libs[name] = lib
    return lib
