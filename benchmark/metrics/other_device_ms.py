"""Device ms a request outside the scan kernels: phase 2, the certificate,
the exact rerank and the copies (the summed durations of every other device
operation in the traced window, over its requests, summed over the cell's
cards: on one card exactly that card's). A device trace in which no kernel
matches the configuration's ``scan_kernels`` fails the run."""


def read(rec):
    if rec.trace is None:
        return None
    scan_s = rec.trace.kernel_s(rec.cell.config["scan_kernels"])
    if scan_s is None:
        return None
    return 1e3 * (rec.trace.sum_s() - scan_s) / len(rec.window.requests)
