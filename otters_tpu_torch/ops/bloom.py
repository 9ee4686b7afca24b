"""Per-chunk Bloom filters as a device-resident bit matrix.

The reference builds one ``fastbloom::BloomFilter`` per chunk per string
column (meta_compute.rs:99-116) and probes it host-side during pruning
(meta.rs:523-544). Here all chunks of a column live in one
``[n_chunks, words]`` 32-bit word matrix on the device:

- **build** (host): double hashing h_i = g1 + i*g2 over the pre-computed
  string hashes, scattered by the native C++ builder or ``np.bitwise_or.at``
  (bit-identical to the JAX package's host build); or, with
  ``OTTERS_BLOOM_DEVICE`` set, on the device from the same hashes
  (:func:`build_matrix_device`, the same bits);
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


def device_build_ok(params: BloomParams, n_chunks: int) -> bool:
    """Can the device build handle this geometry? (The JAX package's rule:
    the per-chunk bit count below 2^24 and the flat bit index of the whole
    matrix below 2^31.)"""
    return (
        params.bits < (1 << 24)
        and n_chunks * params.bits + 1 < (1 << 31)
        and n_chunks > 0
    )


_MASK32 = 0xFFFFFFFF


def _halves(h: np.ndarray, device):
    """uint64 hashes -> their (high, low) 32-bit halves as int64 tensors on
    ``device``, each in [0, 2^32)."""
    t = torch.from_numpy(np.ascontiguousarray(h, dtype=np.uint64).view(np.int64)).to(device)
    # the arithmetic shift sign-extends; the mask keeps bits 32..63
    return (t >> 32) & _MASK32, t & _MASK32


def _mod64_pos(g1_hi, g1_lo, g2_hi, g2_lo, j: int, bits: int):
    """((g1 + j*g2) mod 2^64) mod bits, exactly, in int64 tensor math (torch
    has no unsigned 64-bit arithmetic, and a signed ``%`` of a wrapped sum
    is wrong for hashes >= 2^63).

    The halves are in [0, 2^32) and j < 16, so g1_lo + j*g2_lo < 2^36
    gives the low word and its carry; the high word is the masked
    g1_hi + j*g2_hi + carry (< 2^37 before the mask, the bits past 2^64
    dropped). Then (hi*2^32 + lo) mod bits = ((hi mod bits)*2^32 + lo) mod
    bits, where (hi mod bits)*2^32 + lo < 2^56 for bits < 2^24."""
    assert 0 <= j < 16 and bits < (1 << 24), (j, bits)
    lo = g1_lo + j * g2_lo
    s_lo = lo & _MASK32
    s_hi = (g1_hi + j * g2_hi + (lo >> 32)) & _MASK32
    return (((s_hi % bits) << 32) | s_lo) % bits


def build_matrix_device(g1: np.ndarray, g2: np.ndarray, null_mask: np.ndarray,
                        chunk_size: int, n_chunks: int, params: BloomParams,
                        device) -> torch.Tensor:
    """The Bloom matrix built on the device from host uint64 hashes (rows
    chunk-contiguous) -> [n_chunks, words] int32, the same bits as
    :func:`build_matrix`.

    Per hash j every non-null row's probe position gives a flat bit index
    (chunk * bits + position). The JAX package scatters these into a dense
    bitmap and packs it; here the indices are sorted unique (a bit set
    twice is set once), so adding each index's power of two into its word
    is the OR, with no dense bitmap and no uint32 op: bit 31 adds -2^31,
    and a sum of distinct powers of two never leaves int32. Requires
    :func:`device_build_ok`."""
    if not device_build_ok(params, n_chunks):
        raise ValueError(f"the device Bloom build cannot take {params} over {n_chunks} chunks")
    bits = params.bits
    g1_hi, g1_lo = _halves(g1, device)
    g2_hi, g2_lo = _halves(g2, device)
    dev = g1_lo.device
    keep = ~torch.from_numpy(np.ascontiguousarray(null_mask, dtype=bool)).to(dev)
    base = (torch.arange(g1_lo.shape[0], dtype=torch.int64, device=dev) // chunk_size * bits)[keep]
    flat = torch.unique(torch.cat([
        base + _mod64_pos(g1_hi, g1_lo, g2_hi, g2_lo, j, bits)[keep]
        for j in range(params.k_hashes)
    ]))
    bit = flat & 31
    val = torch.where(bit == 31, -(1 << 31), torch.ones_like(bit) << bit).to(torch.int32)
    out = torch.zeros(n_chunks * params.words, dtype=torch.int32, device=dev)
    return out.index_add_(0, flat >> 5, val).view(n_chunks, params.words)


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
