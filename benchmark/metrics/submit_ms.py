"""Host ms a request spends sending itself (``query_batch`` ... ``collect_async``),
the mean over the window, from the harness's span around the calls."""


def read(rec):
    reqs = rec.window.requests
    return 1e3 * sum(r.submit_s for r in reqs) / len(reqs)
