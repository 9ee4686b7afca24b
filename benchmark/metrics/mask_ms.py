"""Host ms a request spends enqueuing the pruning (the span
``otters.submit.masks``: the chunk mask, the evaluated counts, the row mask,
the live bins), from the program's spans in a traced run."""

from benchmark import program_spans


def read(rec):
    return program_spans.ms_per_request(rec, ["otters.submit.masks"], root="otters.submit")
