"""Row ids a request asks of the rerank source (the counter
``otters.fetch_rows``; a group's one call over the union of its members'
candidates), from the program's counters in a traced run."""

from benchmark import program_spans


def read(rec):
    return program_spans.count_per_request(rec, "otters.fetch_rows")
