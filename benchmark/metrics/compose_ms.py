"""Host ms a request spends composing the shards' outputs on the lead card
(the span ``otters.submit.compose``: the merge of the partial top-k, the
certificate's bound, the statistics), from the program's spans in a traced
run."""

from benchmark import sharding


def read(rec):
    return sharding.ms_per_request(rec, "otters.submit.compose")
