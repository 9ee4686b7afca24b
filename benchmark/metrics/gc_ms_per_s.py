"""Milliseconds of Python's cyclic garbage collector a second of the window."""


def read(rec):
    return sum(rec.window.gc.ms) / rec.window.seconds
