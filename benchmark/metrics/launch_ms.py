"""Host ms a request spends launching the phase 1 scan (the span
``otters.submit.launch``: the operand checks, the geometry, the padded
queries, the kernel's launch), from the program's spans in a traced run."""

from benchmark import program_spans


def read(rec):
    return program_spans.ms_per_request(rec, ["otters.submit.launch"], root="otters.submit")
