"""Host ms a request spends on the sharded store's pre-pass (the span
``otters.submit.mesh_cert``: each shard's queries and certificate terms, and
the mesh-wide slack), from the program's spans in a traced run."""

from benchmark import sharding


def read(rec):
    return sharding.ms_per_request(rec, "otters.submit.mesh_cert")
