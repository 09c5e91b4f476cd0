"""The yardstick's counts: the rounds a query needs and the least bytes
its work moves, from the query's inputs and output alone, so that a
change to how the port computes it leaves them as they are; and the
table of peaks they are held against."""

from __future__ import annotations

import torch

# Peak HBM bandwidth by ``torch.cuda.get_device_name()`` (NVIDIA's data
# sheets).  A card not in the table gets no roofline share.
HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
    "NVIDIA H100 PCIe": 2.0e12,
    "NVIDIA H100 NVL": 3.9e12,
}

INDEX_BYTES = 4     # an int32 vertex id
RANK_BYTES = 4      # an fp32 rank

UNREACHED = 2**31 - 1


def bfs_rounds(max_level: int) -> int:
    """Rounds of a level-synchronous BFS: one per level beyond the root,
    and the round that finds nothing new."""
    return max_level + 1


def bfs_traversed_edges(levels: torch.Tensor, outdeg: torch.Tensor,
                        directed: bool):
    """Input edges whose source the BFS reached, as a 0-d tensor: the
    out-degrees of the reached vertices, halved for an undirected graph,
    which holds each input edge as two slots whose ends are reached
    together (Graph500's traversed edge tuples)."""
    slots = (outdeg.to(torch.int64) * (levels != UNREACHED)).sum()
    return slots if directed else slots // 2


def pagerank_rounds(iters: int) -> int:
    """The iterations and the one pass that counts out-degrees."""
    return iters + 1


def pagerank_least_bytes(n_edges: int, n_vertices: int, iters: int) -> int:
    """Every iteration needs every edge's contribution, and an edge list
    of this size does not fit the cache, so each iteration reads each
    edge's source index at least once (the destination side can be held
    as per-vertex offsets, and the vertex state can stay in cache); the
    ranks are written once.  Counted lower than that, never higher, so
    the share of the roofline cannot pass 100 %."""
    return iters * INDEX_BYTES * n_edges + RANK_BYTES * n_vertices
