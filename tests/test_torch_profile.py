"""``utils.trace`` and the profiling probes of the port.

- ``otters_tpu_torch.utils.trace`` writes a Chrome trace of a CPU query.
- Each probe's plain version (``otters_tpu_torch.profile_variants``) against
  the kernel body of ``scripts/kernel_profile_variants.py`` run through
  ``pl.pallas_call`` in interpret mode, at N_PAD 4096, D 64, B 8 and t 1024,
  launched as the script's ``run`` launches them. The bodies are taken from
  the script's source with ``ast`` and executed with ``jax`` / ``jnp``; the
  script itself is never imported (at import it allocates a 3 GB array and
  times the kernels). ``k_mm`` / ``k_mm_bins`` hold full-f32 sums in another
  order, within d 2^-24 |q| |v|; ``k_planes`` three sums of the same exact
  bf16 products, within 3 d 2^-24 |q| |v|.
- What the card path of ``k_planes`` does around its kernel, on the CPU:
  the scan's [n_bins, b] bin maxima mapped to the script's [n_tiles, b,
  t / 512] (``bins_to_tiles``), and VH / VL at a depth that is not a
  multiple of 8 copied with zero padding (``pad_depth8``), which leaves the
  result unchanged.
"""

import ast
import glob
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

import otters_tpu_torch as tx
from otters_tpu_torch import profile_variants as pv
from otters_tpu_torch.utils import trace

SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "scripts", "kernel_profile_variants.py")
N_PAD, D, B, T = 4096, 64, 8, 1024


def test_trace_writes_a_chrome_trace_of_a_cpu_query(tmp_path):
    vecs = np.random.default_rng(0).normal(size=(2000, 16)).astype(np.float32)
    store = (tx.MetaStore.from_columns([tx.Column("id", tx.DataType.Int64)
                                        .from_values(range(2000))])
             .with_vectors(vecs).with_device("cpu").build())
    with trace(str(tmp_path / "tr")) as prof:
        res = store.query(vecs[7], tx.Metric.Cosine).take(3).collect()
    assert res.indices[0] == 7
    files = glob.glob(str(tmp_path / "tr" / "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") or "mm" in e.get("name", "") for e in events)
    assert len(prof.key_averages()) > 0


def _script_bodies():
    """The script's kernel bodies, from its source, without running it."""
    tree = ast.parse(open(SCRIPT).read(), filename=SCRIPT)
    defs = [n for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name in ("k_mm", "k_mm_bins", "k_planes")]
    assert [d.name for d in defs] == ["k_mm", "k_mm_bins", "k_planes"]
    ns = {"jax": jax, "jnp": jnp}
    exec(compile(ast.Module(body=defs, type_ignores=[]), SCRIPT, "exec"), ns)
    return {"k_mm": ns["k_mm"], "k_mm_bins": ns["k_mm_bins"](2), "k_planes": ns["k_planes"](2)}


def _run(kern, args):
    """The script's ``run`` (grid over t-row tiles of the row inputs, the
    query block whole, out [n_tiles, B, 2]) in interpret mode."""
    nt = N_PAD // T
    vspecs = [pl.BlockSpec((T, D), lambda g: (g, 0))] * (len(args) - 1)
    f = pl.pallas_call(
        kern, grid=(nt,),
        in_specs=[pl.BlockSpec((B, D), lambda g: (0, 0))] + vspecs,
        out_specs=pl.BlockSpec((1, B, 2), lambda g: (g, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((nt, B, 2), jnp.float32),
        interpret=True,
    )
    return np.asarray(f(*args))


@pytest.mark.parametrize("name", list(pv.PROBES))
def test_probe_plain_matches_script_kernel(name):
    rng = np.random.default_rng(5)
    v = rng.normal(size=(N_PAD, D)).astype(np.float32)
    q = rng.normal(size=(B, D)).astype(np.float32)
    vj = jnp.asarray(v)
    vh_j = vj.astype(jnp.bfloat16)  # the script's planes (:8-9)
    vl_j = (vj - vh_j.astype(jnp.float32)).astype(jnp.bfloat16)
    ops = {"q": torch.from_numpy(q), "v": torch.from_numpy(v)}
    ops["vh"], ops["vl"] = pv.split_planes(ops["v"])
    # the port splits bit for bit as JAX does
    for t_, j_ in ((ops["vh"], vh_j), (ops["vl"], vl_j)):
        np.testing.assert_array_equal(t_.view(torch.int16).numpy(),
                                      np.asarray(j_).view(np.int16))
    jargs = (jnp.asarray(q), vh_j, vl_j) if name == "k_planes" else (jnp.asarray(q), vj)
    want = _run(_script_bodies()[name], jargs)
    before = pv.PROBES[name].launches
    got = pv.PROBES[name](*pv.probe_args(name, ops), t=T).numpy()
    assert pv.PROBES[name].launches == before  # CPU tensors: the plain version
    assert got.shape == want.shape == (N_PAD // T, B, 2)
    scale = np.linalg.norm(q, axis=1).max() * np.linalg.norm(v, axis=1).max()
    tol = (3 if name == "k_planes" else 1) * D * 2.0**-24 * scale
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    if name == "k_mm":  # the dots of each tile's first two rows
        np.testing.assert_allclose(got, np.stack([q @ v[i * T : i * T + 2].T
                                                  for i in range(N_PAD // T)]),
                                   rtol=0, atol=tol)


def test_probes_refuse_what_they_cannot_take(monkeypatch):
    ops = pv.make_inputs("cpu", n_pad=2048, d=16, b=4)
    with pytest.raises(ValueError, match="multiple of 512"):
        pv.k_mm(ops["q"], ops["v"], t=700)
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pv.k_mm_bins(ops["q"].to(meta), ops["v"].to(meta))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pv.main() == 1  # the timing entry point needs the card


@pytest.mark.parametrize("t", [512, 1024, 2048])
def test_k_planes_bins_to_tiles_layout(t):
    """The card path's output mapping: bin = tile * nb + j of the scan's
    [n_bins, b] lands at [tile, q, j]; applied to the per-bin maxima of the
    bf16x3 dots (the scan's order) it gives the plain version's layout."""
    rng = np.random.default_rng(t)
    n_pad, d, b = 4096, 32, 5
    nb = t // pv.BIN
    n_bins = n_pad // pv.BIN
    code = torch.arange(n_bins)[:, None] * 1000.0 + torch.arange(b)[None, :]
    tiles = pv.bins_to_tiles(code, nb)
    assert tiles.shape == (n_pad // t, b, nb) and tiles.is_contiguous()
    for tile in range(n_pad // t):
        for q in range(b):
            for j in range(nb):
                assert tiles[tile, q, j] == (tile * nb + j) * 1000 + q
    q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32))
    vh, vl = pv.split_planes(torch.from_numpy(rng.normal(size=(n_pad, d)).astype(np.float32)))
    qh, ql = (x.float() for x in pv.split_planes(q))
    dots = qh @ vh.float().T + qh @ vl.float().T + ql @ vh.float().T  # [b, n_pad]
    bins = dots.reshape(b, n_bins, pv.BIN).amax(dim=2).T  # the scan's [n_bins, b]
    want = pv.k_planes_plain(q, vh, vl, t=t)
    scale = float(q.norm(dim=1).max()) * float((vh.float() + vl.float()).norm(dim=1).max())
    np.testing.assert_allclose(pv.bins_to_tiles(bins, nb).numpy(), want.numpy(), rtol=0,
                               atol=3 * d * 2.0**-24 * scale)


def test_k_planes_depth8_padding_leaves_the_result_unchanged():
    """TMA reads VH / VL rows whose stride is a multiple of 16 bytes: at d
    = 100 the wrapper copies them zero-padded to 104 (the queries are padded
    with the query block); the plain result on the padded operands equals
    the unpadded one. At d = 768 nothing is copied."""
    ops = pv.make_inputs("cpu", n_pad=2048, d=100, b=6, seed=2)
    vh8, vl8 = pv.pad_depth8(ops["vh"]), pv.pad_depth8(ops["vl"])
    assert vh8.shape == vl8.shape == (2048, 104)
    assert not vh8[:, 100:].float().any() and not vl8[:, 100:].float().any()
    assert torch.equal(vh8[:, :100], ops["vh"]) and torch.equal(vl8[:, :100], ops["vl"])
    q8 = torch.nn.functional.pad(ops["q"], (0, 4))
    want = pv.k_planes_plain(ops["q"], ops["vh"], ops["vl"])
    got = pv.k_planes_plain(q8, vh8, vl8)
    scale = float(ops["q"].norm(dim=1).max()) * float(ops["v"].norm(dim=1).max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=100 * 2.0**-24 * scale)
    deep = torch.zeros((8, 768), dtype=torch.bfloat16)
    assert pv.pad_depth8(deep) is deep
