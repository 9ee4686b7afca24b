"""The port's meshes that span processes, against the JAX package's.

Mirrors ``tests/test_multihost.py``: two OS processes form a gloo process
group over local TCP (``parallel.init_distributed``, each bringing two CPU
entries, as ``--xla_force_host_platform_device_count=2`` gives each JAX
worker two devices), build a ``rows=4`` mesh that spans both, and run the
cases of ``torch_multihost_cases.py``: ``ShardedVecStore.search`` (also on
``rows=2, batch=2``); ``build_sharded`` with a filter and its evaluated
chunks, and a certified int8 store in pipelined batches, each on the
direct and the fused path; the exotic paths (the hostmask ``contains``,
the certified int8 rerank, the forced collision redo, ``delete_rows`` +
per-process ``save`` + ``load(mesh=)``, the take-all) and ``append``.

Each case holds the port three ways: the numpy oracle inside the case;
the same case on the port's single-process ``rows=4`` mesh (bit for bit:
indices, scores, flags and statistics); and on ``otters_tpu``'s
single-process ``rows=4`` mesh over conftest's virtual devices (Pallas in
interpret mode): the same indices, flags and statistics, scores within
1e-6. Also: at most two collective calls a batch; the directory the two
port processes save (two manifests, ``process_count`` 2) loaded by
``otters_tpu`` with and without a mesh; one saved by two JAX processes
loaded by the port. Workers run under a timeout and are killed on expiry.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import otters_tpu as jx
import otters_tpu_torch as tx
import torch_multihost_cases as cases

_TESTS = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_TESTS)

_WORKER = r"""
import json, os, sys
import torch
torch.set_num_threads(2)
from otters_tpu_torch.parallel import exchange, init_distributed, make_mesh, process_count
import torch_multihost_cases as cases

coord, pid, case, tmp = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
init_distributed(coord, 2, pid, local_devices=["cpu", "cpu"])
try:
    init_distributed(coord, 2, pid, local_devices=["cpu", "cpu"])
    raise SystemExit("a second init_distributed did not raise")
except RuntimeError as e:
    assert "only be called once" in str(e), e
assert process_count() == 2
meshes = {"4": make_mesh(rows=4), "2x2": make_mesh(rows=2, batch=2)}
assert meshes["4"].spans_processes and [str(d) for d in meshes["4"].devices.flat] == ["cpu"] * 4
assert meshes["4"].owners.ravel().tolist() == [0, 0, 1, 1]
calls = exchange.calls
out = cases.CASES[case](__import__("otters_tpu_torch"), meshes, tmp)
out["_calls"] = exchange.calls - calls
with open(os.path.join(tmp, f"out_{pid}.json"), "w") as f:
    json.dump(out, f)
print(f"proc {pid} OK", flush=True)
"""

_JAX_SAVE = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
from otters_tpu.parallel import init_distributed, make_mesh
import jax.experimental.multihost_utils as mhu
import otters_tpu as jx
import torch_multihost_cases as cases

coord, pid, path = sys.argv[1], int(sys.argv[2]), sys.argv[3]
init_distributed(coordinator_address=coord, num_processes=2, process_id=pid)
vectors, tag, queries = cases.exotic_data()
store = cases.exotic_store(jx, make_mesh(rows=len(jax.devices()), batch=1), tag, vectors)
store.delete_rows([3, 700])
store.save(path)
mhu.sync_global_devices("save done")
print(f"proc {pid} OK", flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _two_processes(code, args, timeout, env=None):
    """Run ``code`` in two processes (ranks 0 and 1, a fresh coordinator
    port); both are killed when ``timeout`` expires."""
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, **(env or {}))
    env["PYTHONPATH"] = os.pathsep.join([_REPO, _TESTS, env.get("PYTHONPATH", "")])
    procs = [subprocess.Popen([sys.executable, "-c", code, coord, str(pid), *args],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=_REPO)
             for pid in (0, 1)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("two-process workers timed out")
    for pid, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}\n{err[-3000:]}"
        assert f"proc {pid} OK" in out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each case run once by two port processes -> {case: (rank 0's
    answers, rank 1's, the directory they wrote in)}."""
    got = {}

    def run(case):
        if case not in got:
            tmp = str(tmp_path_factory.mktemp(f"mh_{case}"))
            _two_processes(_WORKER, [case, tmp], timeout=120)
            outs = []
            for pid in (0, 1):
                with open(os.path.join(tmp, f"out_{pid}.json")) as f:
                    outs.append(json.load(f))
            got[case] = (*outs, tmp)
        return got[case]

    return run


def _port_meshes():
    from otters_tpu_torch.parallel import make_mesh

    return {"4": make_mesh(rows=4, devices=["cpu"] * 4),
            "2x2": make_mesh(rows=2, batch=2, devices=["cpu"] * 4)}


def _jax_meshes():
    import jax

    from otters_tpu.parallel import make_mesh

    return {"4": make_mesh(rows=4, batch=1, devices=jax.devices()[:4]),
            "2x2": make_mesh(rows=2, batch=2, devices=jax.devices()[:4])}


def _same_as_jax(got, want):
    assert set(got) == set(want)
    for key in want:
        assert got[key]["i"] == want[key]["i"], key
        np.testing.assert_allclose(got[key]["s"], want[key]["s"], rtol=0, atol=1e-6,
                                   err_msg=key)
        assert got[key].get("st") == want[key].get("st"), key


@pytest.mark.parametrize("case", list(cases.CASES))
def test_two_processes_agree_with_one_and_with_jax(case, runs, tmp_path, monkeypatch):
    rank0, rank1 = (dict(r) for r in runs(case)[:2])
    calls = rank0.pop("_calls"), rank1.pop("_calls")
    assert rank0 == rank1, "the two processes answered otherwise"
    assert calls[0] == calls[1] and calls[0] > 0
    single = cases.CASES[case](tx, _port_meshes(), str(tmp_path / "port"))
    assert rank0 == single, "two processes differ from the single-process mesh"
    monkeypatch.setenv("OTTERS_PALLAS_INTERPRET", "1")
    _same_as_jax(rank0, cases.CASES[case](jx, _jax_meshes(), str(tmp_path / "jax")))


def test_at_most_two_collective_calls_a_batch(runs):
    """The meta case's collectives: per mesh, each filtered query is one
    gather (the direct and fused paths alike); each certified int8 batch
    one on the fused path and two on the direct path (the mesh-wide slack
    before the scan). Building is collective too: one all_reduce a store
    with certificate residuals."""
    rank0, _, _ = runs("meta")
    per_mesh = 1 + 1 + 3 * 2 + 3 * 1 + 1  # filter x 2 paths, certified x 3 x 2 paths, build
    assert rank0["_calls"] == 2 * per_mesh, rank0["_calls"]


def test_two_process_save_has_two_manifests_and_loads_in_jax(runs, monkeypatch):
    """The port's two-process ``sharded-v1`` directory: one manifest per
    process (``process_count`` 2), each listing its own shards; JAX loads it
    with and without a mesh and answers as the port's processes did."""
    rank0, _, tmp = runs("exotic")
    path = os.path.join(tmp, "mh_store")
    manifests = []
    for pid in (0, 1):
        with open(os.path.join(path, f"manifest_{pid:05d}.json")) as f:
            manifests.append(json.load(f))
    assert [m["process_count"] for m in manifests] == [2, 2]
    assert [m["row_ranges"] for m in manifests] == [[[0, 8192], [8192, 16384]],
                                                     [[16384, 24576], [24576, 26000]]]
    _, _, queries = cases.exotic_data()
    monkeypatch.setenv("OTTERS_PALLAS_INTERPRET", "1")
    for loaded in (jx.MetaStore.load(path, mesh=_jax_meshes()["4"]), jx.MetaStore.load(path)):
        assert len(loaded) == 26_000 - 2
        r = loaded.query_batch(queries, jx.Metric.Cosine).take(5, rerank_from=40).collect()
        assert r.indices == rank0["loaded"]["i"]
        np.testing.assert_allclose(r.scores, rank0["loaded"]["s"], rtol=0, atol=1e-6)
        assert loaded.last_query_stats().certified is True


def test_two_process_save_loads_in_one_port_process_bit_for_bit(runs):
    rank0, _, tmp = runs("exotic")
    path = os.path.join(tmp, "mh_store")
    _, _, queries = cases.exotic_data()
    for loaded in (tx.MetaStore.load(path, mesh=_port_meshes()["4"]),
                   tx.MetaStore.load(path, device="cpu")):
        r = loaded.query_batch(queries, tx.Metric.Cosine).take(5, rerank_from=40).collect()
        assert [r.indices, [float(s) for s in r.scores]] == \
            [rank0["loaded"]["i"], rank0["loaded"]["s"]]
        assert loaded.last_query_stats().certified is True


def test_jax_two_process_save_loads_in_the_port(tmp_path, monkeypatch):
    """A directory saved by two JAX processes (``_EXOTIC_WORKER``'s store)
    loads in the port with and without a mesh, answering as JAX's own load
    of it does."""
    path = str(tmp_path / "jax_store")
    _two_processes(_JAX_SAVE, [path], timeout=240,
                   env={"JAX_PLATFORMS": "cpu",
                        "XLA_FLAGS": "--xla_force_host_platform_device_count=2"})
    assert sorted(f for f in os.listdir(path) if f.startswith("manifest")) == \
        ["manifest_00000.json", "manifest_00001.json"]
    _, _, queries = cases.exotic_data()
    monkeypatch.setenv("OTTERS_PALLAS_INTERPRET", "1")
    want = jx.MetaStore.load(path, mesh=_jax_meshes()["4"])
    rj = want.query_batch(queries, jx.Metric.Cosine).take(5, rerank_from=40).collect()
    for loaded in (tx.MetaStore.load(path, mesh=_port_meshes()["4"]),
                   tx.MetaStore.load(path, device="cpu")):
        assert len(loaded) == 26_000 - 2
        r = loaded.query_batch(queries, tx.Metric.Cosine).take(5, rerank_from=40).collect()
        assert r.indices == rj.indices
        np.testing.assert_allclose(r.scores, rj.scores, rtol=0, atol=1e-6)
        assert loaded.last_query_stats().certified is True
