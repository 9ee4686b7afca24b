"""otters-tpu on PyTorch and CUDA: exact vector search with metadata pruning.

The port of the JAX package ``otters_tpu`` to an NVIDIA H100 (Hopper). It
imports torch and never JAX. Stores run on the current CUDA device unless
the builder names another (``MetaStoreBuilder.with_device("cpu")``).

Ported so far: the MetaStore builder, zonemap / Bloom pruning, pipelined
``collect_async`` / ``resolve``, and ``VecStore`` / ``VecQueryPlan``; f32
storage with exact search (the verified fast-exact bf16x3 scan and its
strict exact-f32 rerun); bfloat16 storage, searched the same way over its
stored values or certified exact through the f32 rerank for Cosine, Dot
and Euclid; and int8 storage, certified through the exact f32 rerank or
uncertified. Each TPU kernel mode on these paths is a kernel written by
hand for Hopper (``csrc/``, see ``ops/fused_topk.py``). Also: ingest from a
CUDA tensor (``with_vectors(tensor)``) with the device Bloom build
(``OTTERS_BLOOM_DEVICE``), ``MetaStore.precompile`` and ``cache_stats``,
the VPU metrics (Manhattan, Hamming, Jaccard) with their pruned scan, the
store's lifecycle (sorted / Z-ordered layouts, ``delete_rows`` /
``append``, ``save`` / ``load``), the row-sharded stores over a mesh of
devices (``parallel``: ``make_mesh``, ``ShardedMetaStore`` through
``MetaStoreBuilder.build_sharded``, ``ShardedVecStore``) with their
per-shard directory format, also across processes
(``parallel.init_distributed``: the exchange between processes is gloo
over host buffers), pandas / Arrow ``adapters``, the synthetic
``datasets``, ``evaluate.recall_at_k``, and ``aot``: the cache of compiled
programs and of the compiled kernel libraries (``OTTERS_AOT_CACHE``).
``resolve`` fetches the candidates of a group the device rerank does not
take in one sorted ``fetch_vectors`` call; ``OTTERS_DISABLE_PALLAS``
sends every shape to the scan programs, which the on-card differential
fuzz (``differential_fuzz``) holds the kernels against; the JAX package's
examples have twins in ``otters_tpu_torch.examples``.
"""

from .column import Column
from .errors import (
    ColumnError,
    ColumnParseError,
    ColumnTypeMismatch,
    ExprError,
    InvalidComparison,
    InvalidExpression,
    OttersError,
    TypeMismatch,
    UnknownColumn,
    UnsupportedStringOp,
)
from .expr import CompiledFilter, Expr, col, lit
from .meta import (
    MetaBuildStats,
    MetaQueryPlan,
    MetaQueryResults,
    MetaQueryStats,
    MetaStore,
    MetaStoreBuilder,
    resolve,
)
from .ops.distance import cosine_similarity, dot_product, euclidean_distance_squared
from .types import Cmp, CmpOp, DataType, Metric, SearchResult, TakeType
from .vec import VecQueryPlan, VecStore

# submodules with additional surface (importable as otters_tpu_torch.<name>)
from . import adapters, aot, datasets, evaluate, io, parallel, utils  # noqa: E402,F401

__version__ = "0.1.0"

__all__ = [
    "Column",
    "ColumnError",
    "ColumnParseError",
    "ColumnTypeMismatch",
    "ExprError",
    "InvalidComparison",
    "InvalidExpression",
    "OttersError",
    "TypeMismatch",
    "UnknownColumn",
    "UnsupportedStringOp",
    "CompiledFilter",
    "Expr",
    "col",
    "lit",
    "MetaBuildStats",
    "MetaQueryPlan",
    "MetaQueryResults",
    "MetaQueryStats",
    "MetaStore",
    "MetaStoreBuilder",
    "resolve",
    "cosine_similarity",
    "dot_product",
    "euclidean_distance_squared",
    "Cmp",
    "CmpOp",
    "DataType",
    "Metric",
    "SearchResult",
    "TakeType",
    "VecQueryPlan",
    "VecStore",
]
