"""Host ms a request spends blocked on the device for its outputs (the
spans ``otters.finish.wait``: the scan's copy and the rerank's), from the
program's spans in a traced run."""

from benchmark import program_spans


def read(rec):
    return program_spans.ms_per_request(rec, ["otters.finish.wait"])
