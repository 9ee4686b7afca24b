"""The exact rerank reads rows made by id (``inputs/gaussian_by_id.py``):
``with_rerank_source(fetch_vectors=...)`` remakes the ids asked for, as
float32, on the device of the queries (the store's lead device). No f32
copy of the store exists for it to gather from."""

import numpy as np


def apply(builder, inputs):
    rows, device = inputs.rows, inputs.queries.device

    def fetch(ids):
        return rows.take(np.asarray(ids, dtype=np.int64), device)

    return builder.with_rerank_source(fetch_vectors=fetch)
