"""Per-chunk Bloom filters as a device-resident bit matrix.

The reference builds one ``fastbloom::BloomFilter`` per chunk per string
column (meta_compute.rs:99-116) and probes it host-side during pruning
(meta.rs:523-544). Here all chunks of a column live in one
``[n_chunks, words]`` 32-bit word matrix on the device:

- **build** (host): double hashing h_i = g1 + i*g2 over the pre-computed
  string hashes, scattered by the native C++ builder or ``np.bitwise_or.at``
  (bit-identical to the JAX package's host build);
- **probe** (device): the query string's k probe (word, bit) coordinates are
  tiny tensors; the probe gathers k columns of the matrix and AND-reduces
  them into the ``[n_chunks]`` "maybe contains" mask.

The words are held as int32 on the device (the same 32 bits; torch's uint32
has no bitwise kernels on every backend). No false negatives by
construction; the false-positive rate is configured like the reference via
``with_bloom_fpr`` (clamped [1e-2, 0.5], meta.rs:92-101) or
``with_bloom_bits`` (min 64, meta.rs:106-110).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from . import hashing

_LN2 = math.log(2.0)


@dataclass(frozen=True)
class BloomParams:
    bits: int  # per-chunk bits, multiple of 32
    k_hashes: int
    words: int

    @staticmethod
    def from_fpr(fpr: float, expected_items: int) -> "BloomParams":
        n = max(1, expected_items)
        bits = max(64, math.ceil(-n * math.log(fpr) / (_LN2 * _LN2)))
        bits = ((bits + 31) // 32) * 32
        k = max(1, round(bits / n * _LN2))
        return BloomParams(bits=bits, k_hashes=min(k, 16), words=bits // 32)

    @staticmethod
    def from_bits(bits: int, expected_items: int) -> "BloomParams":
        bits = max(64, bits)
        bits = ((bits + 31) // 32) * 32
        n = max(1, expected_items)
        k = max(1, round(bits / n * _LN2))
        return BloomParams(bits=bits, k_hashes=min(k, 16), words=bits // 32)


def build_matrix(
    g1: np.ndarray,
    g2: np.ndarray,
    null_mask: np.ndarray,
    chunk_ids: np.ndarray,
    n_chunks: int,
    params: BloomParams,
    chunk_size: int = 0,
) -> np.ndarray:
    """uint32[n_chunks, words] bloom bit matrix from per-row string hashes."""
    if chunk_size > 0 and len(g1) > 4096:
        # rows are chunk-contiguous -> native parallel build
        from .. import native

        m = native.bloom_build(
            g1, g2, null_mask, chunk_size, len(g1), n_chunks,
            params.words, params.bits, params.k_hashes,
        )
        if m is not None:
            return m
    matrix = np.zeros(n_chunks * params.words, dtype=np.uint32)
    keep = ~np.asarray(null_mask, dtype=bool)
    g1 = g1[keep]
    g2 = g2[keep]
    cid = np.asarray(chunk_ids)[keep].astype(np.int64)
    bits = np.uint64(params.bits)
    for i in range(params.k_hashes):
        pos = ((g1 + np.uint64(i) * g2) % bits).astype(np.int64)
        flat = cid * params.words + (pos >> 5)
        np.bitwise_or.at(matrix, flat, np.uint32(1) << (pos & 31).astype(np.uint32))
    return matrix.reshape(n_chunks, params.words)


def to_device(matrix: np.ndarray, device) -> torch.Tensor:
    """Host uint32 matrix -> device int32 tensor holding the same bits."""
    return torch.from_numpy(np.ascontiguousarray(matrix).view(np.int32)).to(device)


def probe_coords(rhs: str, params: BloomParams) -> Tuple[np.ndarray, np.ndarray]:
    """Host: k probe coordinates (word_idx int32 [k], bit_mask uint32 [k])."""
    g1, g2 = hashing.hash_string(rhs)
    idx = np.arange(params.k_hashes, dtype=np.uint64)
    pos = (np.uint64(g1) + idx * np.uint64(g2)) % np.uint64(params.bits)
    words = (pos >> np.uint64(5)).astype(np.int32)
    masks = (np.uint32(1) << (pos & np.uint64(31)).astype(np.uint32)).astype(np.uint32)
    return words, masks


def probe(matrix: torch.Tensor, word_idx: torch.Tensor, bit_mask: torch.Tensor):
    """Device: [n_chunks] bool 'chunk may contain the query string'.

    ``matrix`` and ``bit_mask`` hold int32 views of the uint32 words;
    ``word_idx`` is int64."""
    gathered = matrix[:, word_idx]  # [n_chunks, k]
    hit = (gathered & bit_mask[None, :]) != 0
    return torch.all(hit, dim=1)
