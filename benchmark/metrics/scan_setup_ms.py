"""Host ms a request spends setting up the phase 1 scan (the span
``otters.submit.scan_setup``: the queries rounded, the certificate's
coefficients, lanes and slack, the row mask as f32, the survivor bins),
from the program's spans in a traced run."""

from benchmark import program_spans


def read(rec):
    return program_spans.ms_per_request(rec, ["otters.submit.scan_setup"],
                                        root="otters.submit")
