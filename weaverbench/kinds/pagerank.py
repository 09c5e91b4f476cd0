"""fp32 PageRank over the whole snapshot (``traffic["query"] ==
"pagerank"``); a query kind as ``kinds/bfs.py`` describes one."""

import torch

from repro_torch.core import analytics

from weaverbench import work
from weaverbench.graphs import LiveGraph
from weaverbench.reference import pagerank as ref_pagerank


class Query:
    """``iters`` rounds of fp32 PageRank over the whole snapshot."""

    def __init__(self, traffic: dict, live: LiveGraph, seed: int):
        self.iters = traffic["iterations"]
        self.damping = traffic["damping"]

    def args(self, k) -> None:
        return None

    def program(self, live: LiveGraph, _) -> torch.Tensor:
        return analytics.pagerank(live.src, live.dst, live.n, self.iters,
                                  self.damping, dst_sorted=True)

    def control(self, live: LiveGraph, _) -> torch.Tensor:
        """The reference in bfloat16, the precision below the fp32 the
        configuration states."""
        return ref_pagerank.ranks(live.src, live.dst, live.n, self.iters,
                                  self.damping, torch.bfloat16)

    def work(self, out: torch.Tensor, live: LiveGraph) -> dict:
        return {"rounds": work.pagerank_rounds(self.iters),
                "least_bytes": work.pagerank_least_bytes(
                    live.src.numel(), live.n, self.iters)}

    def reference(self, live: LiveGraph, _) -> torch.Tensor:
        return ref_pagerank.ranks(live.src, live.dst, live.n, self.iters,
                                  self.damping)

    @staticmethod
    def compare(out: torch.Tensor, ref: torch.Tensor) -> dict:
        err = (out.to(torch.float64) - ref).abs_().div_(ref).max()
        return {"rank_rel_err": float(err)}
