"""The GAP Benchmark Suite's uniform random graph (``urand``, its
generator's ``MakeUniformEL``): ``edge_factor * 2**scale`` undirected
edges, both ends of each drawn uniformly over the vertices (Erdos-Renyi).
Self-loops are drawn again, so the count is exact; ids go through a
permutation."""

import torch

from weaverbench import graphs


def build(cfg: dict, seed: int, device) -> graphs.Graph:
    n = 2 ** cfg["scale"]
    g = graphs.generator(device, cfg["graph_seed"], "graph")

    def draw(count):
        return tuple(torch.randint(n, (count,), generator=g,
                                   dtype=torch.int32, device=device)
                     for _ in range(2))

    s, d = draw(cfg["edge_factor"] * n)
    redrawn = graphs.redraw_self_loops(s, d, draw)
    return graphs.undirected(n, s, d, cfg["graph_seed"], seed, redrawn)
