"""The phase 1 scan's share of its roofline, in %.

The least time of one request's scan on one card (``roofline.for_config``
over the rows the filter keeps and the request's queries) over the device
time a request spends in the kernels whose names hold the configuration's
``scan_kernels`` pattern, summed over the cell's cards: on one card exactly
that card's time, on several the mean share of each card's roofline. No
trace or no device in it (the CPU rehearsal): no value. A device trace in
which no kernel matches fails the run."""

from benchmark import roofline


def read(rec):
    if rec.trace is None:
        return None
    scan_s = rec.trace.kernel_s(rec.cell.config["scan_kernels"])
    if scan_s is None:
        return None
    bound_s = roofline.for_config(rec.cell.config, rec.live_rows, rec.batch)[0]
    return 100.0 * bound_s * len(rec.window.requests) / scan_s
