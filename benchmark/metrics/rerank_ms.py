"""Host ms a request spends in its exact rerank and certificate (the spans
``otters.finish.rerank`` and ``otters.finish.certify``, the user's
``fetch_vectors`` inside them), from the program's spans in a traced run."""

from benchmark import program_spans


def read(rec):
    return program_spans.ms_per_request(rec, ["otters.finish.rerank", "otters.finish.certify"])
