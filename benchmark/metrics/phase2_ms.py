"""Host ms a request spends enqueuing phase 2 and the copy of its outputs
(the spans ``otters.submit.phase2``: the winner bins' rescore, the
selection, the bound, the copy to the host), from the program's spans in a
traced run."""

from benchmark import program_spans


def read(rec):
    return program_spans.ms_per_request(rec, ["otters.submit.phase2"], root="otters.submit")
