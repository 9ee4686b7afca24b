"""A column that holds each row's number (VectorDBBench's int64 ``id``)."""

import numpy as np


def make(n: int, seed: int) -> np.ndarray:
    return np.arange(n, dtype=np.int64)
