"""The share of the traced window in which no device operation ran on a card,
in %: the mean over the cell's cards of each card's share (``trace.py``)."""


def read(rec):
    if rec.trace is None or rec.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)
