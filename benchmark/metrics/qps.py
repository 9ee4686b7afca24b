"""Queries answered a second: every query the window resolved on the host,
over the window's whole length."""


def read(rec):
    return rec.window.queries / rec.window.seconds
