"""Graph500's Kronecker generator (specification 3.0, the reference
``kronecker_generator``): ``edge_factor * 2**scale`` undirected edges;
per bit level, the source bit is 1 with probability ``1 - (A + B)`` and
the destination bit then with ``1 - A / (A + B)`` or ``1 - C / (C + D)``.
Self-loops are drawn again, so the count is exact; ids go through a
permutation, as the specification asks."""

import torch

from weaverbench import graphs


def edges(count: int, scale: int, a: float, b: float, c: float,
          g: torch.Generator, device):
    src = torch.zeros(count, dtype=torch.int32, device=device)
    dst = torch.zeros(count, dtype=torch.int32, device=device)
    a_norm = a / (a + b)
    c_norm = c / (1.0 - a - b)
    for level in range(scale):
        ii = torch.rand(count, generator=g, device=device) > a + b
        thr = ii.to(torch.float32).mul_(c_norm - a_norm).add_(a_norm)
        jj = torch.rand(count, generator=g, device=device) > thr
        src |= ii.to(torch.int32) << level
        dst |= jj.to(torch.int32) << level
    return src, dst


def build(cfg: dict, seed: int, device) -> graphs.Graph:
    scale = cfg["scale"]
    n = 2 ** scale
    g = graphs.generator(device, cfg["graph_seed"], "graph")

    def draw(count):
        return edges(count, scale, cfg["a"], cfg["b"], cfg["c"], g, device)

    s, d = draw(cfg["edge_factor"] * n)
    redrawn = graphs.redraw_self_loops(s, d, draw)
    return graphs.undirected(n, s, d, cfg["graph_seed"], seed, redrawn)
