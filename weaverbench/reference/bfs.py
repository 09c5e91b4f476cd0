"""Breadth-first levels from one root over directed edges: top-down,
level by level, over a CSR built from the edge list.  A different
algorithm from the port's (which relaxes every edge each round)."""

from __future__ import annotations

import torch

UNREACHED = 2**31 - 1


def csr(src: torch.Tensor, dst: torch.Tensor, n: int):
    """``(indptr, nbrs)``: the out-neighbours of ``v`` are
    ``nbrs[indptr[v]:indptr[v + 1]]``."""
    order = torch.argsort(src, stable=True)
    nbrs = dst[order].to(torch.int64)
    del order
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=src.device)
    indptr[1:] = torch.cumsum(torch.bincount(src.to(torch.int64),
                                             minlength=n), 0)
    return indptr, nbrs


def levels(src: torch.Tensor, dst: torch.Tensor, n: int,
           root: int) -> torch.Tensor:
    """int32 level of every vertex, ``UNREACHED`` where none."""
    indptr, nbrs = csr(src, dst, n)
    dev = src.device
    level = torch.full((n,), UNREACHED, dtype=torch.int32, device=dev)
    level[root] = 0
    frontier = torch.tensor([root], dtype=torch.int64, device=dev)
    depth = 0
    while frontier.numel():
        starts = indptr[frontier]
        counts = indptr[frontier + 1] - starts
        total = int(counts.sum())
        if total == 0:
            break
        owner = torch.repeat_interleave(counts)
        first = torch.cumsum(counts, 0) - counts
        pos = starts[owner] + torch.arange(total, device=dev) - first[owner]
        del owner
        found = nbrs[pos]
        del pos
        found = torch.unique(found[level[found] == UNREACHED])
        depth += 1
        level[found] = depth
        frontier = found
    return level
