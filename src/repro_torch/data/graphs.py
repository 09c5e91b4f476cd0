"""Graph containers and utilities: CSR build, batching of small graphs,
triplet construction for directional (DimeNet-style) message passing."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class CSRGraph:
    indptr: np.ndarray           # (N+1,)
    indices: np.ndarray          # (E,) neighbor ids (out-edges)
    n_nodes: int

    @property
    def n_edges(self) -> int:
        return int(self.indices.shape[0])

    def degree(self, v: int) -> int:
        return int(self.indptr[v + 1] - self.indptr[v])

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]:self.indptr[v + 1]]


def build_csr(edge_src: np.ndarray, edge_dst: np.ndarray,
              n_nodes: int) -> CSRGraph:
    order = np.argsort(edge_src, kind="stable")
    src = edge_src[order]
    dst = edge_dst[order]
    counts = np.bincount(src, minlength=n_nodes)
    indptr = np.zeros(n_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CSRGraph(indptr=indptr, indices=dst.astype(np.int32),
                    n_nodes=n_nodes)


def sort_edges_by_dst(edge_src: np.ndarray, edge_dst: np.ndarray):
    """dst-sorted edge list (the layout the segment_mp kernel and the
    shard_map edge-partitioned GNN layer both want)."""
    order = np.argsort(edge_dst, kind="stable")
    return edge_src[order].astype(np.int32), edge_dst[order].astype(np.int32)


def power_law_cdf(n_nodes: int) -> np.ndarray:
    """Normalised cumulative weights of :func:`random_graph`'s
    preferential-attachment-flavoured degree skew (weight 1/(i+1))."""
    w = 1.0 / np.arange(1, n_nodes + 1)
    w /= w.sum()
    cdf = w.cumsum()
    return cdf / cdf[-1]


def _search(cdf: np.ndarray, u: np.ndarray) -> np.ndarray:
    return np.searchsorted(cdf, u, side="right").astype(np.int32)


def random_graph(rng: np.random.Generator, n_nodes: int, n_edges: int,
                 power_law: bool = False, search=_search):
    """Random (src, dst) int32 edges.  With ``power_law``, each end is
    drawn as ``rng.choice(n_nodes, p=w)`` draws it: ``rng.random`` uniforms
    searched in :func:`power_law_cdf` (side="right"), which gives the same
    nodes and leaves ``rng`` where ``choice`` would.  ``search(cdf,
    uniforms)`` does that search; a caller may pass one that runs on a
    device (for graphs of tens of millions of edges) and gets the same
    edges as its tensors."""
    if power_law:
        cdf = power_law_cdf(n_nodes)
        src = search(cdf, rng.random(n_edges))
        dst = search(cdf, rng.random(n_edges))
    else:
        src = rng.integers(0, n_nodes, n_edges).astype(np.int32)
        dst = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    return src, dst


def batch_molecules(rng: np.random.Generator, n_graphs: int, n_nodes: int,
                    n_edges: int, d_feat: int,
                    with_pos: bool = False) -> dict:
    """Pack ``n_graphs`` identical-size molecules into one flat batch."""
    total_n = n_graphs * n_nodes
    total_e = n_graphs * n_edges
    src = np.zeros(total_e, dtype=np.int32)
    dst = np.zeros(total_e, dtype=np.int32)
    for g in range(n_graphs):
        s, d = random_graph(rng, n_nodes, n_edges)
        src[g * n_edges:(g + 1) * n_edges] = s + g * n_nodes
        dst[g * n_edges:(g + 1) * n_edges] = d + g * n_nodes
    batch = {
        "x": rng.normal(size=(total_n, d_feat)).astype(np.float32),
        "edge_src": src,
        "edge_dst": dst,
        "graph_ids": np.repeat(np.arange(n_graphs, dtype=np.int32), n_nodes),
        "n_graphs": n_graphs,
    }
    if with_pos:
        batch["pos"] = rng.normal(size=(total_n, 3)).astype(np.float32) * 2.0
        batch["species"] = rng.integers(0, 8, total_n).astype(np.int32)
    return batch


def build_triplets(edge_src: np.ndarray, edge_dst: np.ndarray,
                   max_per_edge: Optional[int] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Triplet index lists for directional MP: for each edge j->i, the
    incoming edges k->j (k != i).  Returns (trip_in, trip_out) as indices
    into the edge list: message of edge ``trip_in[t]`` feeds edge
    ``trip_out[t]``.  ``max_per_edge`` caps fan-in (cutoff analogue)."""
    e = edge_src.shape[0]
    by_dst: dict = {}
    for idx in range(e):
        by_dst.setdefault(int(edge_dst[idx]), []).append(idx)
    tin: List[int] = []
    tout: List[int] = []
    for ji in range(e):
        j = int(edge_src[ji])
        i = int(edge_dst[ji])
        incoming = by_dst.get(j, [])
        cnt = 0
        for kj in incoming:
            if int(edge_src[kj]) == i:
                continue                       # exclude backtracking k == i
            tin.append(kj)
            tout.append(ji)
            cnt += 1
            if max_per_edge is not None and cnt >= max_per_edge:
                break
    return (np.asarray(tin, dtype=np.int32),
            np.asarray(tout, dtype=np.int32))


def pad_triplets(trip_in: np.ndarray, trip_out: np.ndarray, target: int,
                 pad_edge: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pad triplet lists to a static size; padding points at ``pad_edge``
    (a self-loop-free dummy whose contributions segment-sum to an unused
    slot is avoided by pointing in==out so the angle is 0 and the edge
    update adds a constant-zero after masking upstream)."""
    cur = trip_in.shape[0]
    if cur >= target:
        return trip_in[:target], trip_out[:target]
    fill = target - cur
    return (np.concatenate([trip_in, np.full(fill, pad_edge, np.int32)]),
            np.concatenate([trip_out, np.full(fill, pad_edge, np.int32)]))
