"""BFS levels from one root a query (``traffic["query"] == "bfs"``).

A query kind is a module ``kinds/<query>.py`` whose ``Query`` draws each
query's arguments from the seed, calls the port's public traversal entry
on the live snapshot (``program``), counts the work the answer implies
(``work``), and for the check gives the plain reference's answer, the
control's, and the numbers that compare an answer with the reference's
(``compare``, aggregated over the sample by their maximum).
"""

import numpy as np
import torch

from repro_torch.core import analytics

from weaverbench import work
from weaverbench.graphs import LiveGraph, sub_seed
from weaverbench.reference import bfs as ref_bfs


class Query:
    """Levels from one root a query.  The roots are a pool of ``roots``
    vertices (Graph500 searches from 64 keys), drawn with the graph seed
    uniformly from the vertices whose out-degree in the first snapshot is
    at least ``root_min_out_degree`` (Graph500's kernel-2 rule), so every
    run searches the same graph from the same roots; the run's seed
    shuffles the pool anew each time the queries go through it."""

    def __init__(self, traffic: dict, live: LiveGraph, seed: int):
        self.seed = seed
        by_rank = live.outdeg[live.perm] >= traffic["root_min_out_degree"]
        ranks = by_rank.nonzero().squeeze(1).cpu().numpy()
        rng = np.random.default_rng(sub_seed(live.graph_seed, "roots"))
        ranks = rng.choice(ranks, size=traffic["roots"], replace=False)
        self.pool = live.perm.cpu().numpy()[ranks]

    def args(self, k: int) -> int:
        n = len(self.pool)
        rng = np.random.default_rng(sub_seed(self.seed, "roots", k // n))
        return int(self.pool[rng.permutation(n)[k % n]])

    def program(self, live: LiveGraph, root: int) -> torch.Tensor:
        return analytics.bfs_levels(live.src, live.dst, live.n, [root],
                                    dst_sorted=True)

    def control(self, live: LiveGraph, root: int) -> torch.Tensor:
        """The reference on the snapshot one write window behind: it
        breaks the guarantee that a query reads every write applied
        before it."""
        return ref_bfs.levels(live.stale_src(), live.dst, live.n, root)

    def work(self, out: torch.Tensor, live: LiveGraph) -> dict:
        """Counts as 0-d tensors on the device, read after the window."""
        top = out.masked_fill(out == work.UNREACHED, -1).max().to(torch.int64)
        return {"rounds": work.bfs_rounds(top),
                "traversed_edges": work.bfs_traversed_edges(
                    out, live.outdeg, live.directed)}

    def reference(self, live: LiveGraph, root: int) -> torch.Tensor:
        return ref_bfs.levels(live.src, live.dst, live.n, root)

    @staticmethod
    def compare(out: torch.Tensor, ref: torch.Tensor) -> dict:
        return {"levels_wrong": int((out != ref).sum())}
