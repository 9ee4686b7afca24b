"""The 95th percentile of every request's latency in the window, from the
call that sends it to the return of the call that finishes it, in ms."""

import numpy as np


def read(rec):
    return float(np.percentile([r.latency_s for r in rec.window.requests], 95)) * 1e3
