"""Where the port's compiled artifacts live.

Both the g++-built host library (``native/``) and the nvcc-built Hopper
kernels (``csrc/``) are compiled at first use into ``build/otters_tpu_torch/``
next to the package directory, which ``.gitignore`` keeps out of the tree.
"""

from __future__ import annotations

import os

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))


def build_dir() -> str:
    """Create (if needed) and return the build directory."""
    path = os.path.join(os.path.dirname(_PKG_DIR), "build", "otters_tpu_torch")
    os.makedirs(path, exist_ok=True)
    return path
