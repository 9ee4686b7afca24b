"""Shard programs issued a request (the counter ``otters.shard_programs``:
one a shard, so the cell's cards where every request runs once), from the
program's counters in a traced run."""

from benchmark import sharding


def read(rec):
    return sharding.count_per_request(rec, "otters.shard_programs")
