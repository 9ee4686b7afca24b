"""Rows and queries drawn from a standard normal on the device, in two
calls of one generator."""

import torch


def make(n: int, d: int, pool: int, batch: int, g: torch.Generator, device):
    """-> ([n, d] rows, [pool, batch, d] queries), float32."""
    rows = torch.randn((n, d), generator=g, device=device)
    queries = torch.randn((pool, batch, d), generator=g, device=device)
    return rows, queries
