"""Host ms a request spends choosing and finding its program inside
``collect_async`` (the span ``otters.submit.plan``: the queries to the
device, the filter's lowering, the launch decision and its ``aot`` lookup),
from the program's spans in a traced run."""

from benchmark import program_spans


def read(rec):
    return program_spans.ms_per_request(rec, ["otters.submit.plan"], root="otters.submit")
