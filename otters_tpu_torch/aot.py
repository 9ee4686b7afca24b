"""The cache of compiled programs: where the port's compiled artifacts live,
and the per-signature programs of a process.

The JAX package persists serialized XLA executables keyed by a signature
(``otters_tpu/aot.py``). The port compiles two kinds of artifact, both
ahead of the query path and both kept on disk under :func:`cache_dir`: the
nvcc libraries of the Hopper kernels (``kernels.py``) and the g++ library
of the host string kernels (``native/``). A fresh process that finds them
there loads them and compiles nothing (``stats``: ``disk_hits`` against
``compiles``).

A *program* of the port is the launch decision a query shape takes (its
scan tile, fast-exact and certified modes and the kernel)
with the libraries it needs loaded or built. ``MetaStore`` and
``ShardedMetaStore`` key it by :func:`signature` and keep it in the
in-memory table ``_mem`` (``lookup`` / ``load_or_compile``); the store's
``aot_key`` memo maps a query shape to its signature, as in the JAX
package.

``OTTERS_AOT_CACHE=<dir>`` relocates the disk layer (default
``build/otters_tpu_torch/`` beside the package, which ``.gitignore``
lists); ``OTTERS_AOT_CACHE=0`` or ``OTTERS_DISABLE_AOT`` turn it off: each
process then builds into a private temporary directory, and
``OTTERS_DISABLE_AOT`` also bypasses the in-memory table (the launch
decision is made afresh for every query, as JAX's kill-switch bypasses its
cache). ``OTTERS_AOT_NO_WARM`` is accepted and changes nothing: the port
has no second compile path to warm.
"""

from __future__ import annotations

import atexit
import glob
import hashlib
import os
import shutil
import tempfile
import threading
from typing import Any, Dict, Optional

_mem: Dict[str, Any] = {}
_lock = threading.Lock()
_MEM_LIMIT = 256
stats = {"disk_hits": 0, "compiles": 0}

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_private: Optional[str] = None  # this process's directory with the disk layer off


def disabled() -> bool:
    """Is the kill-switch ``OTTERS_DISABLE_AOT`` set?"""
    return bool(os.environ.get("OTTERS_DISABLE_AOT"))


def cache_dir() -> str:
    """Where every compiled artifact of the port lives (created if needed):
    ``OTTERS_AOT_CACHE``, else ``build/otters_tpu_torch/`` beside the
    package; a private temporary directory of this process when the disk
    layer is off."""
    global _private
    env = os.environ.get("OTTERS_AOT_CACHE")
    if env == "0" or disabled():
        if _private is None:
            _private = tempfile.mkdtemp(prefix="otters_aot_")
            atexit.register(shutil.rmtree, _private, True)
        return _private
    path = os.path.abspath(env) if env else os.path.join(
        os.path.dirname(_PKG_DIR), "build", "otters_tpu_torch")
    os.makedirs(path, exist_ok=True)
    return path


_code_salt: Optional[str] = None


def _code_version() -> str:
    """Content hash of the port's sources (``.py``, ``csrc/``, ``native/``):
    a code change changes every signature."""
    global _code_salt
    if _code_salt is None:
        h = hashlib.sha256()
        for pattern in ("**/*.py", "csrc/*", "native/*.cpp"):
            for p in sorted(glob.glob(os.path.join(_PKG_DIR, pattern), recursive=True)):
                with open(p, "rb") as f:
                    h.update(f.read())
        _code_salt = h.hexdigest()[:12]
    return _code_salt


_tag: Optional[str] = None


def _backend_tag() -> str:
    """torch's version, the CUDA runtime, the current device's name and
    compute capability (or ``cpu``), the process index and the code
    version (JAX's ``_backend_tag`` and ``_code_version``)."""
    global _tag
    if _tag is None:
        import torch

        from .parallel.mesh import process_index

        if torch.cuda.is_available():
            dev = torch.cuda.current_device()
            cap = torch.cuda.get_device_capability(dev)
            device = f"{torch.cuda.get_device_name(dev)}|sm_{cap[0]}{cap[1]}"
        else:
            device = "cpu"
        _tag = f"{torch.__version__}|{torch.version.cuda}|{device}|p{process_index()}"
    return f"{_tag}|{_code_version()}"


def _aval_sig(tree) -> str:
    """Every leaf's dtype and shape, in order (tensors, arrays, the
    fields of a named tuple, a sharded tensor's global shape)."""
    parts = []

    def walk(x):
        if isinstance(x, dict):
            for k in sorted(x, key=str):
                walk(x[k])
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)
        elif x is None:
            parts.append("None")
        else:
            dt = getattr(x, "dtype", type(x).__name__)
            parts.append(f"{dt}{list(getattr(x, 'shape', ()))}")

    walk(tree)
    return ",".join(parts)


def signature(name: str, static_repr: str, args, kwargs) -> str:
    """The key of a program: a hash of the backend tag, ``name``, the
    statics' repr and every argument's shape and dtype."""
    raw = "|".join([_backend_tag(), name, static_repr, _aval_sig((args, kwargs))])
    return hashlib.sha256(raw.encode()).hexdigest()[:32]


def lookup(key: str):
    """In-memory lookup only (no disk I/O on the query path)."""
    return _mem.get(key)


def load_or_compile(key: str, jitted, args, static_kwargs):
    """The program for ``key``: the in-memory table's, else
    ``jitted(*args, **static_kwargs)``, which makes the launch decision and
    loads (or builds) the libraries it needs from :func:`cache_dir`;
    ``stats`` counts those loads and builds. Kept in ``_mem`` (FIFO past
    256 programs)."""
    with _lock:
        hit = _mem.get(key)
    if hit is not None:
        return hit
    program = jitted(*args, **static_kwargs)
    with _lock:
        if len(_mem) >= _MEM_LIMIT:
            _mem.pop(next(iter(_mem)))
        _mem[key] = program
    return program


def clear_memory_cache() -> None:
    """Forget every program of this process (the libraries stay loaded)."""
    with _lock:
        _mem.clear()


def jit_is_ready(key: str) -> bool:
    """JAX's switch from the deserialized executable to jit's fast path.
    A program of the port is ready as soon as ``load_or_compile`` returns
    it: True for every program in the table."""
    return key in _mem


def ensure_jit_warm(key: str, jitted, args, static_kwargs) -> None:
    """JAX warms jit in the background for a signature served from disk.
    The port has no second compile path to warm: nothing to do."""


def wait_jit_ready(timeout: float = 600.0) -> bool:
    """Wait for background warms: the port starts none, so True at once."""
    return True
