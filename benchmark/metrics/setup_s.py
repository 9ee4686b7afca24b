"""Process start to the first timed request: CUDA's start, the kernels'
load (or build), the inputs, the build, ``precompile`` and the warm-up."""


def read(rec):
    return rec.setup_s
