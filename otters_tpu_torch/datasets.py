"""Realistic synthetic datasets for tests and benchmarks.

The reference's roadmap lists "Test with real datasets". Instead of
downloading corpora, this module generates datasets with the *statistics*
of real embedding workloads, deterministically, with numpy alone (the same
arrays and columns as the JAX package's ``datasets`` for the same
arguments):

- embeddings are a power-law mixture of anisotropic Gaussian clusters
  (real text/image embeddings are clustered and anisotropic, not i.i.d.
  spherical noise), L2-normalized like sentence-encoder output;
- metadata mimics an e-commerce catalog: zipf-ish categories and brands,
  log-normal prices correlated with category, star ratings, stock flags,
  listing datetimes over a year, and missing values at realistic rates.

Everything is seeded — two calls with the same arguments return identical
data on any machine, so exact-assertion tests can rely on it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .column import Column
from .types import DataType

CATEGORIES = (
    "electronics", "home", "clothing", "sports", "toys",
    "grocery", "beauty", "auto", "garden", "office",
)
BRANDS = tuple(f"brand_{i:02d}" for i in range(40))


def synthetic_catalog(
    n: int,
    dim: int,
    *,
    seed: int = 0,
    n_clusters: int = 64,
    null_rate: float = 0.03,
) -> Tuple[np.ndarray, Dict[str, Column]]:
    """Generate ``(vectors [n, dim] float32, {name: Column})``.

    Clusters follow a power law (cluster 0 is largest), each with its own
    anisotropic covariance; category correlates with cluster, price with
    category — so metadata filters correlate with embedding locality the
    way they do in real catalogs (and Z-order/sort clustering has real
    structure to exploit).
    """
    rng = np.random.default_rng(seed)

    # --- embeddings: power-law mixture of anisotropic Gaussians ----------
    weights = 1.0 / np.arange(1, n_clusters + 1) ** 0.7
    weights /= weights.sum()
    assignment = rng.choice(n_clusters, size=n, p=weights)
    anchors = rng.normal(size=(n_clusters, dim)).astype(np.float32)
    anchors /= np.linalg.norm(anchors, axis=1, keepdims=True)
    # per-cluster anisotropy: a few dominant directions (low-rank + noise)
    rank = max(2, dim // 16)
    basis = rng.normal(size=(n_clusters, rank, dim)).astype(np.float32)
    coeff = rng.normal(size=(n, rank)).astype(np.float32) * 0.35
    noise = rng.normal(size=(n, dim)).astype(np.float32) * 0.08
    vecs = (
        anchors[assignment]
        + np.einsum("nr,nrd->nd", coeff, basis[assignment])
        + noise
    )
    vecs /= np.maximum(np.linalg.norm(vecs, axis=1, keepdims=True), 1e-9)
    vecs = vecs.astype(np.float32)

    # --- metadata correlated with the clusters ---------------------------
    cat_of_cluster = rng.integers(0, len(CATEGORIES), n_clusters)
    cat_idx = cat_of_cluster[assignment]
    categories = [CATEGORIES[i] for i in cat_idx]
    brand_of_cluster = rng.integers(0, len(BRANDS), n_clusters)
    # 80% cluster brand, 20% random long tail
    brand_idx = np.where(
        rng.random(n) < 0.8,
        brand_of_cluster[assignment],
        rng.integers(0, len(BRANDS), n),
    )
    brands = [BRANDS[i] for i in brand_idx]
    # log-normal price whose location depends on category
    base = 2.0 + 0.35 * cat_idx.astype(np.float64)
    price = np.exp(rng.normal(base, 0.6)).round(2)
    rating = np.clip(rng.normal(4.0, 0.7, n), 1.0, 5.0).round(1)
    stock = rng.random(n) < 0.85
    reviews = rng.negative_binomial(2, 0.02, n).astype(np.int64)
    # listing datetimes across 2024, epoch millis
    t0 = 1704067200000  # 2024-01-01T00:00:00Z
    listed = t0 + rng.integers(0, 365 * 24 * 3600 * 1000, n, dtype=np.int64)

    def _nullify(values):
        out = list(values)
        for i in np.flatnonzero(rng.random(n) < null_rate):
            out[i] = None
        return out

    cols = {
        "category": Column("category", DataType.String).from_values(categories),
        "brand": Column("brand", DataType.String).from_values(_nullify(brands)),
        "price": Column("price", DataType.Float64).from_values(
            _nullify(price.tolist())
        ),
        "rating": Column("rating", DataType.Float32).from_values(
            _nullify([float(r) for r in rating])
        ),
        "in_stock": Column("in_stock", DataType.Bool).from_values(
            _nullify([bool(s) for s in stock])
        ),
        "reviews": Column("reviews", DataType.Int64).from_values(
            reviews.tolist()
        ),
        "listed": Column("listed", DataType.DateTime).from_values(
            _nullify(listed.tolist())
        ),
    }
    return vecs, cols
