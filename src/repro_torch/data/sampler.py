"""Layer-wise neighbour sampler (GraphSAGE-style, fanout e.g. 15-10).

``minibatch_lg`` requires a real sampler: given seed nodes, sample up to
``fanout[0]`` neighbours per seed, then ``fanout[1]`` per first-hop node,
and emit a compact subgraph (relabelled ids) whose edges point hop->seed
(message flow toward the seeds), padded to static shapes for jit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .graphs import CSRGraph


@dataclass
class SampledSubgraph:
    node_ids: np.ndarray         # (N_sub,) original ids (padded with -1)
    edge_src: np.ndarray         # (E_sub,) compact ids
    edge_dst: np.ndarray
    seeds: np.ndarray            # compact ids of the seed nodes
    n_real_nodes: int
    n_real_edges: int


class NeighborSampler:
    def __init__(self, graph: CSRGraph, fanouts: Sequence[int],
                 seed: int = 0):
        self.graph = graph
        self.fanouts = list(fanouts)
        self.rng = np.random.default_rng(seed)

    def sample(self, seeds: np.ndarray,
               pad_to: Optional[Tuple[int, int]] = None) -> SampledSubgraph:
        g = self.graph
        node_ids: List[int] = list(map(int, seeds))
        index = {v: i for i, v in enumerate(node_ids)}
        e_src: List[int] = []
        e_dst: List[int] = []
        frontier = list(map(int, seeds))
        for fanout in self.fanouts:
            nxt: List[int] = []
            for v in frontier:
                nbrs = g.neighbors(v)
                if len(nbrs) == 0:
                    continue
                if len(nbrs) > fanout:
                    pick = self.rng.choice(nbrs, size=fanout, replace=False)
                else:
                    pick = nbrs
                for u in map(int, pick):
                    if u not in index:
                        index[u] = len(node_ids)
                        node_ids.append(u)
                        nxt.append(u)
                    # message direction: sampled neighbour -> target
                    e_src.append(index[u])
                    e_dst.append(index[v])
            frontier = nxt
        n_real_nodes = len(node_ids)
        n_real_edges = len(e_src)
        nid = np.asarray(node_ids, dtype=np.int64)
        es = np.asarray(e_src, dtype=np.int32)
        ed = np.asarray(e_dst, dtype=np.int32)
        if pad_to is not None:
            max_n, max_e = pad_to
            assert n_real_nodes <= max_n and n_real_edges <= max_e, \
                (n_real_nodes, n_real_edges, pad_to)
            nid = np.concatenate([nid, np.full(max_n - n_real_nodes, -1,
                                               np.int64)])
            # padding edges self-loop on a dedicated dead node (last slot)
            pad_e = max_e - n_real_edges
            es = np.concatenate([es, np.full(pad_e, max_n - 1, np.int32)])
            ed = np.concatenate([ed, np.full(pad_e, max_n - 1, np.int32)])
        return SampledSubgraph(
            node_ids=nid, edge_src=es, edge_dst=ed,
            seeds=np.arange(len(seeds), dtype=np.int32),
            n_real_nodes=n_real_nodes, n_real_edges=n_real_edges)

    @staticmethod
    def max_sizes(n_seeds: int, fanouts: Sequence[int]) -> Tuple[int, int]:
        """Static worst-case (nodes, edges) for jit padding."""
        nodes = n_seeds
        layer = n_seeds
        edges = 0
        for f in fanouts:
            layer = layer * f
            nodes += layer
            edges += layer
        return nodes, edges
