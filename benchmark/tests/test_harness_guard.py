"""The import guard compares whole top-level names."""

import subprocess
import sys

from benchmark import guard, spec


def test_the_port_passes_and_the_jax_package_fails():
    assert guard.offenders(["otters_tpu_torch", "otters_tpu_torch.meta", "torch",
                            "jaxtyping", "otters_tpu_tools"]) == []
    assert guard.offenders(["otters_tpu.x", "otters_tpu_torch", "jax.numpy", "jaxlib",
                            "flax.linen"]) == ["flax.linen", "jax.numpy", "jaxlib",
                                               "otters_tpu.x"]


def test_a_cpu_run_loads_nothing_forbidden():
    code = (
        "import time, sys; from benchmark import harness, spec, guard\n"
        "cell = spec.cell('cohere10m.f1p')\n"
        "harness.run_cell(cell, 3, 0.2, False, 'cpu', time.perf_counter(),\n"
        "                 overrides={'rows': 20000, 'dim': 32, 'batch': 16, 'pool': 2})\n"
        "print(guard.offenders())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
