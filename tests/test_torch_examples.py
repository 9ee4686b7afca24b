"""The port's example twins (``otters_tpu_torch/examples/``) against the
JAX package's ``examples/``: each pair run through ``runpy`` at a small size
on the CPU (the twin's device "cpu", the mesh of ``multichip`` the CPU
listed 8 times, JAX's over conftest's 8 virtual devices) prints the same
lines, timing aside: the same tables cell for cell, the same rows, scores,
certificates and counts."""

import contextlib
import io
import os
import re
import runpy
import sys

import pytest

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")

# (example, its arguments; the twin takes the device(s) after them)
CASES = {
    "async_serving": (["3000", "32", "3"], ["cpu"]),
    "catalog": (["3000", "32"], ["cpu"]),
    "certified_search": (["3000", "32"], ["cpu"]),
    "multichip": (["3000", "32"], ["cpu"] * 8),
}


def _run(argv, fn):
    out, saved = io.StringIO(), sys.argv
    sys.argv = argv
    try:
        with contextlib.redirect_stdout(out):
            fn()
    finally:
        sys.argv = saved
    return out.getvalue()


def _deterministic(text):
    """The lines that do not depend on timing, split into stripped table
    cells: timing rows and table borders go (their widths follow the
    timings), and a rate reads as ``N q/s``."""
    lines = []
    for ln in text.splitlines():
        if "_ms " in ln or (ln and set(ln) <= set("+-")):
            continue
        ln = re.sub(r"[\d,.]+ q/s", "N q/s", ln)
        lines.append([c.strip() for c in ln.split("|")])
    return lines


@pytest.mark.parametrize("name", sorted(CASES))
def test_twin_prints_what_the_jax_example_prints(name):
    args, devices = CASES[name]
    jax_out = _run([f"{name}.py", *args],
                   lambda: runpy.run_path(os.path.join(EXAMPLES, f"{name}.py"),
                                          run_name="__main__"))
    twin_out = _run([name, *args, *devices],
                    lambda: runpy.run_module(f"otters_tpu_torch.examples.{name}",
                                             run_name="__main__", alter_sys=True))
    got, want = _deterministic(twin_out), _deterministic(jax_out)
    assert len(got) == len(want) >= 3
    for g, w in zip(got, want):
        assert len(g) == len(w) and all(_same_cell(a, b) for a, b in zip(g, w)), (g, w)


def _same_cell(a, b):
    """Equal text, or two printed scores one unit apart in their last of 6
    decimals (f32 sums taken in another order can round either way)."""
    if a == b:
        return True
    try:
        return "." in a and abs(float(a) - float(b)) <= 1.01e-6
    except ValueError:
        return False


def test_twins_return_what_they_checked():
    from otters_tpu_torch.examples import async_serving, certified_search

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        results, results8 = async_serving.main(3000, 32, 3, device="cpu")
        res, stats = certified_search.main(3000, 32, device="cpu")
    assert len(results) == 3 and all(len(r) == 10 for r in results8)
    assert all(v == "cat_3" for r in results for v in r.column("category").string_values())
    assert stats.certified is True and len(res) == 10
