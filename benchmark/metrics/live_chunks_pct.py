"""The share of the store's chunks that pruning leaves to the scan
(``evaluated_chunks / total_chunks`` from ``stats()``), over the window."""


def read(rec):
    reqs = rec.window.requests
    return 100.0 * sum(r.evaluated_chunks for r in reqs) / sum(r.total_chunks for r in reqs)
