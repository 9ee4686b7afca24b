"""Rows made by id, stores across several devices, and the metrics beyond
Cosine, on the CPU:

- rows made by id equal the same rows made in slabs of any size, bit for
  bit, and depend on the seed;
- ``data.make`` still gives every configuration of ``BENCHMARK.json`` the
  bits it gave before rows could be made by id (pinned digests);
- a four-chip cell of a small squared-L2 configuration (bfloat16 rows,
  certified, rows made by id, the rerank from the same function) runs end to
  end on four CPU shards, correct and with the answers of its one-device run;
  the exchange between shards left out makes it not correct, and its TF32
  control fails the limit that the program meets.

On the card (marked ``cuda``): the same configuration at 4M x 768 over four
shards, rows made by id against their slabs bit for bit, and the readings of
the program and of the control on three seeds.
"""

import dataclasses
import hashlib
import json
import sys
import time

import numpy as np
import pytest
import torch

from benchmark import control, data, harness, judge, spec, system

BY_ID = spec.part("inputs", "gaussian_by_id")
SMALL = {"rows": 30_000, "dim": 32, "batch": 8, "pool": 2}  # rows on all four shards
L2_CONFIG = {
    "name": "l2-by-id-bf16",
    "rows": 4_000_000,
    "dim": 768,
    "metric": "l2",
    "inputs": "gaussian_by_id",
    "columns": [{"name": "id", "dtype": "Int64", "values": "row_number"}],
    "storage_dtype": "bfloat16",
    "chunk_size": 1024,
    "rerank_source": "by_row_id",
    "certified": True,
    "scan_kernels": "binmax",
    "roofline": {"row_bytes": 2, "row_side_bytes": 12, "query_bytes": 2,
                 "query_side_bytes": 8, "peak": "bf16"},
    "limits": {"worst_gap": 2e-3},
    "assumed": ["a trial of the harness: rows and queries Gaussian, rows made by id"],
    "reduced": [],
}
# data.make at 300 rows, 2 x 3 queries, seed 2**40 + 29, on the CPU: the
# bytes of the rows, the queries and the columns
PINNED = {
    "cohere-10m-768-int8": "58f0143506546e4bc7cc392e87c8117df31a07960a562f4d6fc1b8af0209da61",
    "openai-5m-1536-bf16": "7e03ef0573424a18d4505dc2faac31f0eaa413cd235b1d72a9bb2498e3d3a394",
    "cohere-10m-768-f32": "58f0143506546e4bc7cc392e87c8117df31a07960a562f4d6fc1b8af0209da61",
}


def l2_cell(chips=4, **config):
    return dataclasses.replace(spec.cell("cohere10m.f1p"), name="l2.by_id", chips=chips,
                               config=dict(L2_CONFIG, **config))


@pytest.mark.parametrize("slab", [1, 7, 64, 999, 4096])
def test_rows_by_id_equal_their_slabs_bit_for_bit(slab):
    rows = BY_ID.RowsById(2**40 + 11, 4096, 34)
    whole = rows.slab(0, 4096, "cpu")
    pieces = torch.cat([rows.slab(s, min(slab, 4096 - s), "cpu") for s in range(0, 4096, slab)])
    assert whole.dtype == torch.float32 and whole.shape == (4096, 34)
    assert torch.equal(pieces.view(torch.int32), whole.view(torch.int32))
    ids = torch.randint(0, 4096, (slab,), generator=torch.Generator().manual_seed(slab))
    assert torch.equal(rows.take(ids, "cpu").view(torch.int32), whole[ids].view(torch.int32))
    assert torch.equal(rows.take(ids.numpy(), "cpu"), whole[ids])


def test_rows_by_id_follow_the_seed_and_look_gaussian():
    a = BY_ID.RowsById(2**40 + 11, 20_000, 64).slab(0, 20_000, "cpu")
    b = BY_ID.RowsById(2**40 + 12, 20_000, 64).slab(0, 20_000, "cpu")
    assert not torch.equal(a, b)
    assert torch.equal(a[:, :7], BY_ID.RowsById(2**40 + 11, 20_000, 7).slab(0, 20_000, "cpu"))
    for x in (a, b):
        assert abs(x.mean().item()) < 0.01 and abs(x.std().item() - 1.0) < 0.01
        assert (x.abs() > 4).float().mean().item() == pytest.approx(6.3e-5, abs=4e-5)
    cor = torch.corrcoef(a[:, :32].T) - torch.eye(32)
    assert cor.abs().max().item() < 0.04  # 5.7 sigma of 20,000 rows


@pytest.mark.parametrize("name", sorted(PINNED))
def test_data_make_keeps_every_configurations_bits(name):
    conf = {c["name"]: c for c in spec.benchmark()["configs"]}[name]
    config = spec.load_json(f"{spec.ROOT}/{conf['file']}")
    inputs = data.make(config, 300, int(config["dim"]), 2, 3, 2**40 + 29, "cpu")
    h = hashlib.sha256()
    for t in (inputs.rows, inputs.queries):
        h.update(t.contiguous().numpy().tobytes())
    for column in sorted(inputs.columns):
        h.update(np.ascontiguousarray(inputs.columns[column]).tobytes())
    assert h.hexdigest() == PINNED[name]


def test_a_configuration_by_id_makes_no_tensor_of_its_rows():
    inputs = data.make(L2_CONFIG, 100_000, 768, 2, 3, 2**40 + 1, "cpu")
    assert not isinstance(inputs.rows, torch.Tensor)
    assert type(inputs.rows).__name__ == "RowsById" and inputs.rows.n == 100_000
    assert inputs.queries.shape == (2, 3, 768) and inputs.queries.dtype == torch.float32


def run(cell, devices, monkeypatch, seed=2**40 + 5, seconds=0.3):
    """One run of ``cell`` on ``devices`` -> (its result, {pool: answer}, the store)."""
    seen = {}
    judged, build = judge.judge, system.build

    def keep_answers(answers, *args, **kw):
        seen["answers"] = {a.pool: (list(a.indices), list(a.scores)) for a in answers}
        return judged(answers, *args, **kw)

    def keep_store(*args, **kw):
        seen["store"], build_s = build(*args, **kw)
        return seen["store"], build_s

    monkeypatch.setattr(judge, "judge", keep_answers)
    monkeypatch.setattr(system, "build", keep_store)
    out = harness.run_cell(cell, seed, seconds, False, devices, time.perf_counter(),
                           overrides=SMALL)
    return out, seen["answers"], seen["store"]


def test_four_cpu_shards_answer_as_one_device(one_thread, monkeypatch):
    cell = l2_cell()
    out4, ans4, store4 = run(cell, ["cpu"] * 4, monkeypatch)
    out1, ans1, store1 = run(cell, ["cpu"], monkeypatch)
    for out in (out4, out1):
        assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
        assert out["checks"]["uncertified"]["value"] == 0
        assert out["device"]["count"] == 1 and out["device"]["platform"] == "cpu"
    assert store4.mesh.shape["rows"] == 4 and store1.mesh.shape["rows"] == 1
    assert store4._storage_dtype == "bfloat16" and len(store4) == SMALL["rows"]
    assert set(ans4) == set(ans1) == {0, 1}
    for pool in ans1:
        assert ans4[pool][0] == ans1[pool][0]
        np.testing.assert_allclose(ans4[pool][1], ans1[pool][1], rtol=0, atol=1e-4)
        assert ans1[pool][1] == sorted(ans1[pool][1])  # distances, nearest first


def test_the_exchange_left_out_is_not_correct(one_thread, monkeypatch):
    from otters_tpu_torch.parallel import meta_sharded

    merge = meta_sharded.merge_partials

    def first_shard_only(parts, k, take_min, lead):
        return merge(parts[:1], k, take_min, lead)

    monkeypatch.setattr(meta_sharded, "merge_partials", first_shard_only)
    out, _, _ = run(l2_cell(), ["cpu"] * 4, monkeypatch)
    assert out["correct"] is False and out["failed"] > 0


def test_the_tf32_control_fails_where_the_l2_program_passes(one_thread, monkeypatch):
    cell = l2_cell()
    limit = cell.config["limits"]["worst_gap"]
    sizes = dict(SMALL, dim=768)
    for seed in (1, 2, 3):
        verdict = control.control_verdict(cell, seed, ["cpu"] * 4, overrides=sizes)
        assert not verdict.correct
        assert verdict.numbers["worst_gap"] > 3 * limit
        assert verdict.numbers["filter_violations"] == 0
    out = harness.run_cell(cell, 1, 0.2, False, ["cpu"] * 4, time.perf_counter(),
                           overrides=sizes)
    assert out["correct"] is True and out["checks"]["worst_gap"]["value"] < limit / 3


@pytest.mark.cuda
def test_trial_l2_by_id_on_four_shards_on_the_card():
    """4M x 768 bfloat16 rows made by id over four shards (four cards where
    there are, else the card listed four times): rows by id against their
    slab on the card, then the control and the program on three seeds, one
    of them traced. Run with ``-s`` for the harness's log."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    n_cards = torch.cuda.device_count()
    devices = [f"cuda:{i}" for i in range(4)] if n_cards >= 4 else ["cuda:0"] * 4
    rows = BY_ID.RowsById(2**40 + 77, 4_000_000, 768)
    slab = rows.slab(1_234_567, 65_536, devices[-1])
    ids = torch.randint(1_234_567, 1_234_567 + 65_536, (4096,), device=devices[0])
    again = rows.take(ids, devices[0]).to(devices[-1])
    assert torch.equal(again.view(torch.int32), slab[ids.to(devices[-1]) - 1_234_567]
                       .view(torch.int32))
    del slab, again
    cell = l2_cell()
    readings = {}
    for seed, traced in ((2**33 + 1, False), (2**33 + 2, False), (2**33 + 3, True)):
        ctl = control.control_verdict(cell, seed, devices).numbers
        torch.cuda.empty_cache()
        out = harness.run_cell(cell, seed, 5.0, traced, devices, time.perf_counter())
        torch.cuda.empty_cache()
        readings[seed] = {"control": ctl, "program": out["checks"],
                          "correct": out["correct"], "device": out["device"],
                          "metrics": out["metrics"]}
        print(json.dumps({"seed": seed, **readings[seed]}), file=sys.stderr, flush=True)
    for r in readings.values():
        assert r["correct"] is True
        assert r["control"]["worst_gap"] > cell.config["limits"]["worst_gap"]
