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
- What the card paths of the probes do around their kernels, on the CPU:
  the scan's [n_bins, b] bin maxima mapped to the script's [n_tiles, b,
  t / 512] (``bins_to_tiles``) for ``k_planes`` and ``k_mm_bins``;
  ``k_mm``'s two columns, gathered from the dots as the FFMA scan's thread
  layout hands them to the kernel's key (every row and query once, rows 0
  and 1 of each tile kept); and rows whose stride is not a multiple of 16
  bytes copied with zero padding (``pad_row_stride``, by element size:
  VH / VL at d = 100, f32 rows at d = 98), which leaves the result
  unchanged.
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
from otters_tpu_torch.ops import fused_topk as ft
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
    vh8, vl8 = pv.pad_row_stride(ops["vh"]), pv.pad_row_stride(ops["vl"])
    assert vh8.shape == vl8.shape == (2048, 104)
    assert not vh8[:, 100:].float().any() and not vl8[:, 100:].float().any()
    assert torch.equal(vh8[:, :100], ops["vh"]) and torch.equal(vl8[:, :100], ops["vl"])
    q8 = torch.nn.functional.pad(ops["q"], (0, 4))
    want = pv.k_planes_plain(ops["q"], ops["vh"], ops["vl"])
    got = pv.k_planes_plain(q8, vh8, vl8)
    scale = float(ops["q"].norm(dim=1).max()) * float(ops["v"].norm(dim=1).max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=100 * 2.0**-24 * scale)
    deep = torch.zeros((8, 768), dtype=torch.bfloat16)
    assert pv.pad_row_stride(deep) is deep


@pytest.mark.parametrize("dtype,d,padded", [(torch.float32, 98, 100), (torch.bfloat16, 98, 104),
                                            (torch.float32, 100, 100), (torch.int8, 98, 112)])
def test_pad_row_stride_by_element_size(dtype, d, padded):
    """One helper pads every probe's rows: to a multiple of 16 bytes a row
    (4 f32, 8 bf16, 16 int8 elements), with zero columns, and leaves rows
    whose stride already is one untouched."""
    x = torch.arange(3 * d).reshape(3, d).to(dtype)
    y = pv.pad_row_stride(x)
    assert y.shape == (3, padded) and y.dtype == dtype
    assert y.shape[1] * y.element_size() % 16 == 0
    assert torch.equal(y[:, :d], x) and not y[:, d:].float().any()
    assert (y is x) is (padded == d)


@pytest.mark.parametrize("name", ["k_mm", "k_mm_bins"])
def test_f32_probe_depth_padding_leaves_the_result_unchanged(name):
    """f32 rows at d = 98 (not a multiple of 4): the card path copies them
    zero-padded to 100 and pads the queries to 128 (two 64-deep k-blocks,
    ``sm90_pad_queries``); the plain result on those operands equals the
    unpadded one within d 2^-24 |q| |v| (zero columns add exact zeros)."""
    ops = pv.make_inputs("cpu", n_pad=2048, d=98, b=70, seed=4)
    v4 = pv.pad_row_stride(ops["v"])
    assert v4.shape == (2048, 100)
    geom = ft.sm90_geometry(name, 70, 100, 132)
    assert (geom.dq, geom.n_qb, geom.planes) == (128, 2, 1)
    qk, _ = ft.sm90_pad_queries(ops["q"], (), geom)
    assert qk.shape == (128, 128) and not qk[70:].any() and not qk[:, 98:].any()
    vk = torch.nn.functional.pad(v4, (0, 28))
    want = pv.PLAIN[name](ops["q"], ops["v"])
    got = pv.PLAIN[name](qk, vk)[:, :70]
    scale = float(ops["q"].norm(dim=1).max()) * float(ops["v"].norm(dim=1).max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=98 * 2.0**-24 * scale)


@pytest.mark.parametrize("t", [512, 1024, 2048])
def test_k_mm_bins_bins_to_tiles_layout(t):
    """k_mm_bins' card path: the scan's [n_bins, b] maxima of the f32 dots
    (bin = tile * nb + j), permuted by ``bins_to_tiles``, equal the plain
    version's [n_tiles, b, nb]."""
    rng = np.random.default_rng(t + 1)
    n_pad, d, b = 4096, 32, 5
    q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(n_pad, d)).astype(np.float32))
    bins = (q @ v.T).reshape(b, n_pad // pv.BIN, pv.BIN).amax(dim=2).T  # [n_bins, b]
    want = pv.k_mm_bins_plain(q, v, t=t)
    assert want.shape == (n_pad // t, b, t // pv.BIN)
    scale = float(q.norm(dim=1).max()) * float(v.norm(dim=1).max())
    np.testing.assert_allclose(pv.bins_to_tiles(bins, t // pv.BIN).numpy(), want.numpy(),
                               rtol=0, atol=d * 2.0**-24 * scale)


def _ffma_rows_and_queries(n_bins):
    """(row, first query) of every (bin, warpgroup, thread, i) of K3's FFMA
    scan as its key receives them (cert_scan_sm90.cuh): warpgroup wg takes
    rows [256 wg, 256 wg + 256) of each bin; thread (warp wq, lane) rows rg
    + 16 i, i < 16, and queries qg + 8 j, j < 8, rg = lane % 8 + 8 (wq %
    2), qg = lane / 8 + 4 (wq / 2)."""
    out = []
    for bin_ in range(n_bins):
        for wg in range(2):
            for wq in range(4):
                for lane in range(32):
                    rg, qg = lane % 8 + 8 * (wq % 2), lane // 8 + 4 * (wq // 2)
                    out += [(bin_ * 512 + 256 * wg + rg + 16 * i, qg) for i in range(16)]
    return out


@pytest.mark.parametrize("t", [512, 1024])
def test_k_mm_two_columns_from_the_ffma_layout(t):
    """k_mm's card path writes, from each row's dots (queries qg + 8 j of
    the 64-query block), those of rows 0 and 1 of every t-row tile to
    [tile, q, row % t] (csrc/profile_probes.cu TileDots::store). Over the
    FFMA layout every (row, query) of a block is handed over exactly once,
    and the two columns so gathered equal the plain version's."""
    rng = np.random.default_rng(t)
    n_pad, d, b = 2048, 16, 50  # one query block, 14 padded lanes
    q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(n_pad, d)).astype(np.float32))
    dots = torch.nn.functional.pad(q, (0, 0, 0, 64 - b)) @ v.T  # [64, n_pad]
    seen = torch.zeros((64, n_pad), dtype=torch.int32)
    first2 = torch.full((n_pad // t, b, 2), float("nan"))
    for row, qg in _ffma_rows_and_queries(n_pad // pv.BIN):
        qs = [qg + 8 * j for j in range(8)]
        seen[qs, row] += 1
        c = row % t
        if c < 2:
            for q_ in qs:
                if q_ < b:
                    first2[row // t, q_, c] = dots[q_, row]
    assert bool((seen == 1).all())
    want = pv.k_mm_plain(q, v, t=t)
    scale = float(q.norm(dim=1).max()) * float(v.norm(dim=1).max())
    np.testing.assert_allclose(first2.numpy(), want.numpy(), rtol=0, atol=d * 2.0**-24 * scale)
