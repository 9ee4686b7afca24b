"""Strict exact-f32 reruns a request: the fast-exact check failed and the
scan ran again in full f32 (the counter ``otters.strict_reruns``), from the
program's counters in a traced run. Nothing where the run counted no fast
check (``otters.fast_checks``): an untraced run, or a program without the
counters."""

from benchmark import program_spans


def read(rec):
    if not program_spans.count_per_request(rec, "otters.fast_checks"):
        return None
    return program_spans.count_per_request(rec, "otters.strict_reruns")
