"""Host ms a request spends issuing every shard's program (the span
``otters.submit.shards``: each shard's masks, scan set-up, launch and phase
2, in turn from one thread), from the program's spans in a traced run."""

from benchmark import sharding


def read(rec):
    return sharding.ms_per_request(rec, "otters.submit.shards")
