"""The exact rerank reads the benchmark's f32 rows on the device:
``with_rerank_source(fetch_vectors=...)`` gathering them by row id."""

import numpy as np
import torch


def apply(builder, inputs):
    rows = inputs.rows

    def fetch(ids):
        return rows[torch.as_tensor(np.asarray(ids, dtype=np.int64), device=rows.device)]

    return builder.with_rerank_source(fetch_vectors=fetch)
