"""The program's host merge and result materialisation a request
(``stats().merge_duration``), the mean over the window, in ms."""


def read(rec):
    reqs = rec.window.requests
    return 1e3 * sum(r.merge_s for r in reqs) / len(reqs)
