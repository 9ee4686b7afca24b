"""Rows made from the seed by row id; queries drawn as ``gaussian`` draws them.

Every element of a row is a pure function of ``(seed, row id, column)``:
32-bit integer hashes in int64 torch ops (each product stays below 2**63, so
no operation wraps), two 24-bit uniforms for each pair of columns, and
Box-Muller's step to two standard normals. No ``torch.Generator`` makes a
row. So any slab of rows, or any set of ids, can be made on any device, and
on one device an id gives the same bits whichever way it is made: the
store's build, the rerank source and the reference each remake what they
need, and no ``[n, d]`` copy of the rows exists anywhere. Ids must be below
2**32. The queries come from the run's generator, as ``gaussian.py`` draws
them.
"""

import math

import torch

MASK = 0xFFFFFFFF
MULTIPLIERS = (0x7FEB352D, 0x1B873593)  # odd, below 2**31: a 32-bit value times one fits int64


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """An xorshift-multiply mixer of 32-bit values held in int64."""
    x = x ^ (x >> 16)
    x = (x * MULTIPLIERS[0]) & MASK
    x = x ^ (x >> 15)
    x = (x * MULTIPLIERS[1]) & MASK
    return x ^ (x >> 16)


def _keys(seed: int):
    """Four 32-bit keys from the seed (splitmix64, in Python's integers)."""
    out, s = [], int(seed) % 2**64
    for _ in range(4):
        s = (s + 0x9E3779B97F4A7C15) % 2**64
        z = ((s ^ (s >> 30)) * 0xBF58476D1CE4E5B9) % 2**64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) % 2**64
        out.append((z ^ (z >> 31)) & MASK)
    return out


class RowsById:
    """The ``n`` rows of depth ``d`` of one seed, made on demand as float32."""

    def __init__(self, seed: int, n: int, d: int):
        if n > 2**32:
            raise ValueError(f"rows made by id take ids below 2**32, not {n}")
        self.n, self.d = int(n), int(d)
        self._keys = _keys(seed)

    def slab(self, start: int, count: int, device) -> torch.Tensor:
        """Rows ``start .. start + count`` -> [count, d] on ``device``."""
        return self._rows(torch.arange(start, start + count, dtype=torch.int64, device=device))

    def take(self, ids, device) -> torch.Tensor:
        """Rows ``ids`` (any order, repeats allowed) -> [len(ids), d] on ``device``."""
        return self._rows(torch.as_tensor(ids, dtype=torch.int64, device=device))

    def _rows(self, ids: torch.Tensor) -> torch.Tensor:
        k0, k1, k2, k3 = self._keys
        pairs = torch.arange((self.d + 1) // 2, dtype=torch.int64, device=ids.device)
        h1 = _hash32(_hash32(ids ^ k0)[:, None] ^ _hash32(pairs ^ k2)[None, :])
        h2 = _hash32(_hash32(ids ^ k1)[:, None] ^ _hash32(pairs ^ k3)[None, :])
        u1 = ((h1 >> 8) + 1).to(torch.float32) * 2.0**-24  # (0, 1]
        u2 = (h2 >> 8).to(torch.float32) * 2.0**-24  # [0, 1)
        del h1, h2
        radius = torch.sqrt(-2.0 * torch.log(u1))
        angle = (2.0 * math.pi) * u2
        out = torch.stack([radius * torch.cos(angle), radius * torch.sin(angle)], dim=-1)
        return out.reshape(ids.shape[0], -1)[:, : self.d].contiguous()


def make(n: int, d: int, pool: int, batch: int, g: torch.Generator, device):
    """-> (the rows as a ``RowsById`` of the generator's seed, [pool, batch, d]
    float32 queries)."""
    queries = torch.randn((pool, batch, d), generator=g, device=device)
    return RowsById(g.initial_seed(), n, d), queries
