"""The port stands alone: it imports torch and never JAX or the JAX package,
and its entry points run on CUDA unless the caller names the CPU."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest

import otters_tpu_torch as tx

PKG_DIR = os.path.dirname(os.path.abspath(tx.__file__))
REPO = os.path.dirname(PKG_DIR)


def test_import_leaves_jax_and_otters_tpu_out():
    code = (
        "import sys, otters_tpu_torch, otters_tpu_torch.meta, otters_tpu_torch.demo, "
        "otters_tpu_torch.ops.fused_topk, otters_tpu_torch.state, otters_tpu_torch.kernels, "
        "otters_tpu_torch.vec, otters_tpu_torch.ops.distance, otters_tpu_torch.differential_fuzz, "
        "otters_tpu_torch.examples.async_serving, otters_tpu_torch.examples.catalog, "
        "otters_tpu_torch.examples.certified_search, otters_tpu_torch.examples.multichip\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'otters_tpu' or m.startswith('otters_tpu.')]\n"
        "print(bad)\n"
        "raise SystemExit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_source_scan_finds_no_jax_or_otters_tpu_import():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG_DIR) for f in fs if f.endswith(".py")]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) > 15
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "otters_tpu"), (path, mod)


def test_build_without_a_device_named_needs_cuda(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    b = tx.MetaStore.from_columns(
        [tx.Column("id", tx.DataType.Int64).from_values([0, 1])]
    ).with_vectors(np.eye(2, dtype=np.float32))
    with pytest.raises(tx.OttersError, match="with_device"):
        b.build()
    store = b.with_device("cpu").build()
    assert store.device.type == "cpu"


def test_kernel_wrapper_never_falls_back_off_cpu():
    """A tensor on a device that is neither the CPU nor CUDA is refused by
    every kernel wrapper (K1 .. K5, every row type; the plain versions serve
    CPU tensors only)."""
    import torch

    from otters_tpu_torch.ops import fused_topk as ft

    meta = torch.device("meta")

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=meta)

    def tail():
        return [empty(1), empty(1, dtype=torch.int32), empty(1, dtype=torch.int32)]

    for name, vdtype in (("cert_cos_binmax", torch.int8), ("cert_cos_binmax_bf16", torch.bfloat16)):
        args = [empty(8, 16, dtype=torch.bfloat16), empty(512, 16, dtype=vdtype),
                *[empty(512) for _ in range(3)], *[empty(8) for _ in range(2)], *tail()]
        with pytest.raises(ValueError, match=f"{name}: unsupported device"):
            getattr(ft, name)(*args)
    args = [empty(8, 16, dtype=torch.bfloat16), empty(512, 16, dtype=torch.bfloat16),
            *[empty(512) for _ in range(5)], *[empty(8) for _ in range(6)], *tail()]
    with pytest.raises(ValueError, match="cert_fold_binmax: unsupported device"):
        ft.cert_fold_binmax(*args)
    for mode, (_, entry, qdtype, vdtype) in ft._MODES.items():
        args = [empty(8, 16, dtype=qdtype), empty(512, 16, dtype=vdtype),
                *[empty(512) for _ in range(3)], *[empty(8) for _ in range(3)], *tail()]
        with pytest.raises(ValueError, match=f"{entry}: unsupported device"):
            ft.KERNELS[mode](*args)
