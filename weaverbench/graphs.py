"""Graph deployments generated on the device from a seed, and the live
snapshot that every query reads.

A configuration file names its ``generator``: ``generators/<name>.py``,
whose ``build(cfg, seed, device)`` returns a ``Graph``.  A graph is held
as two int32 edge arrays in CSC order (destination-major, sorted by
``(dst, src)``), the layout of the port's snapshot arrays
(``GraphArrays.csc_src`` / ``csc_dst``); an undirected graph holds both
directions of every edge.  Every draw comes from a ``torch.Generator`` on
the device.  The graph's structure and its write windows come from the
configuration's ``graph_seed`` (as Graph500's generator fixes its seeds),
so every run does the same work; ``--seed`` shuffles the vertex ids among
vertices of equal degree, so each run holds the same graphs under other
ids, with each destination's segment of the CSC arrays where every other
run has one of its length."""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Callable, Tuple

import numpy as np
import torch


def sub_seed(seed: int, *keys) -> int:
    """A 63-bit seed for one stream of draws (``keys`` name it), from
    the run's seed, which may be any whole number."""
    words = [int(seed) % 2**64] + [
        k % 2**64 if isinstance(k, int) else zlib.crc32(str(k).encode())
        for k in keys]
    hi, lo = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(hi) << 31) ^ int(lo)


def generator(device, seed: int, *keys) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, *keys))
    return g


@dataclass
class Graph:
    n: int
    src: torch.Tensor          # int32, CSC order
    dst: torch.Tensor          # int32, CSC order
    slot_of: torch.Tensor      # int32: the slot of each drawn edge end, in
                               # the order drawn (forward ends, then reverse)
    twin: torch.Tensor         # int32: the slot holding each slot's reverse
    perm: torch.Tensor         # vertex id of each rank
    graph_seed: int
    self_loops_redrawn: int


def redraw_self_loops(s: torch.Tensor, d: torch.Tensor,
                      draw: Callable[[int], Tuple[torch.Tensor, torch.Tensor]]
                      ) -> int:
    """Draws every edge whose ends meet again with ``draw(count)``, in
    place, until none does; returns how many draws that took."""
    loops = (s == d).nonzero().squeeze(1)
    redrawn = 0
    while loops.numel():
        redrawn += loops.numel()
        s[loops], d[loops] = draw(loops.numel())
        loops = loops[s[loops] == d[loops]]
    return redrawn


def _csc(src: torch.Tensor, dst: torch.Tensor):
    """The edges sorted by ``(dst, src)``, and the slot each edge, in the
    order given, lands in."""
    key = (dst.to(torch.int64) << 32) | src.to(torch.int64)
    del src, dst
    key, order = torch.sort(key)
    slot_of = torch.empty(order.numel(), dtype=torch.int32,
                          device=order.device)
    slot_of[order] = torch.arange(order.numel(), dtype=torch.int32,
                                  device=order.device)
    del order
    return ((key & 0xFFFFFFFF).to(torch.int32), (key >> 32).to(torch.int32),
            slot_of)


def _ids(degree: torch.Tensor, graph_seed: int, seed: int) -> torch.Tensor:
    """The id of each rank: a permutation drawn with the graph seed, then
    shuffled by ``seed`` among ranks of equal degree, so each id keeps its
    degree whatever the seed."""
    n, dev = degree.numel(), degree.device
    base = torch.randperm(n, generator=generator(dev, graph_seed, "ids"),
                          device=dev)
    shuffle = torch.randperm(n, generator=generator(dev, seed, "ids"),
                             device=dev)
    by_base = torch.argsort(degree * n + base)
    by_seed = torch.argsort(degree * n + shuffle)
    perm = torch.empty_like(base)
    perm[by_seed] = base[by_base]
    return perm


def undirected(n: int, s: torch.Tensor, d: torch.Tensor, graph_seed: int,
               seed: int, redrawn: int) -> Graph:
    """The graph of the undirected edges ``{s[i], d[i]}`` (ranks, no
    self-loop), each held in both directions, with ids from ``_ids``."""
    m = s.numel()
    degree = (torch.bincount(s.to(torch.int64), minlength=n)
              + torch.bincount(d.to(torch.int64), minlength=n))
    perm = _ids(degree, graph_seed, seed)
    perm32 = perm.to(torch.int32)
    src = torch.cat([perm32[s], perm32[d]])
    dst = torch.cat([perm32[d], perm32[s]])
    del s, d
    src, dst, slot_of = _csc(src, dst)
    twin = torch.empty_like(slot_of)
    twin[slot_of[:m].to(torch.int64)] = slot_of[m:]
    twin[slot_of[m:].to(torch.int64)] = slot_of[:m]
    return Graph(n, src, dst, slot_of, twin, perm, graph_seed, redrawn)


class LiveGraph:
    """The snapshot on the card, changed in place by one write window
    before each query.

    A write window is a batch of degree-preserving double-edge swaps:
    ``{a, b}, {c, d}`` become ``{a, d}, {c, b}``, two deletes and two
    creates that rewrite the four slots ``b <- a``, ``a <- b``, ``d <- c``,
    ``c <- d`` as ``b <- c``, ``a <- d``, ``d <- a``, ``c <- b``.  Every slot
    keeps its destination, so the destination-major order holds, and the
    graph stays undirected with every vertex's degree, so the generator's
    degree law holds on every snapshot.  The edges are picked one in each
    of as many equal strata of the slots in the order drawn and paired in
    turn; a pair that would make a self-loop, or that holds an edge another
    pick holds too, is left alone.  Window ``k`` depends only on the graph
    seed, ``k`` and the graph's structure, and ids enter only through the
    permutation, so every run's snapshots are the same graphs under its own
    ids, and a copy taken before the first window replays every later
    snapshot exactly."""

    directed = False

    def __init__(self, graph: Graph, fraction: float):
        self.n = graph.n
        self.src, self.dst = graph.src, graph.dst
        self.slot_of, self.twin = graph.slot_of, graph.twin
        self.perm = graph.perm
        self.picks = 2 * max(1, round(self.src.numel() * fraction / 4))
        self.count = 2 * self.picks     # slots a window writes
        self.graph_seed = graph.graph_seed
        self.outdeg = torch.bincount(self.src, minlength=self.n).to(
            torch.int32)                # swaps keep every degree
        self.last = None

    def clone(self) -> "LiveGraph":
        copy = object.__new__(type(self))
        copy.__dict__.update(self.__dict__)
        copy.src, copy.dst = self.src.clone(), self.dst.clone()
        copy.twin = self.twin.clone()
        return copy

    def write_window(self, k) -> None:
        """Window ``k``, launched without a wait on the device: every pair
        is written, a pair left alone with the values it had."""
        dev = self.src.device
        e, picks = self.slot_of.numel(), self.picks
        g = generator(dev, self.graph_seed, "write", k)
        i = torch.arange(picks, dtype=torch.int64, device=dev)
        lo, hi = i * e // picks, (i + 1) * e // picks
        u = torch.rand(picks, generator=g, dtype=torch.float64, device=dev)
        p = self.slot_of[lo + (u * (hi - lo)).to(torch.int64)].to(
            torch.int64)
        tw = self.twin[p].to(torch.int64)
        # a pair holding an edge that another pick holds too is left alone
        ps = torch.sort(p).values
        at = torch.searchsorted(ps, tw).clamp_(max=picks - 1)
        shared = (ps[at] == tw).view(-1, 2).any(1)
        p1, p2, q1, q2 = p[0::2], p[1::2], tw[0::2], tw[1::2]
        a, b = self.src[p1], self.dst[p1]
        c, d = self.src[p2], self.dst[p2]
        swap = (~shared & (c != b) & (a != d)).repeat(4)
        slots = torch.cat([p1, q2, p2, q1])
        old = self.src[slots]
        self.src[slots] = torch.where(swap, torch.cat([c, b, a, d]), old)
        self.twin[slots] = torch.where(
            swap, torch.cat([q2, p1, q1, p2]).to(torch.int32),
            self.twin[slots])
        self.last = (slots, old)

    def stale_src(self) -> torch.Tensor:
        """The source array as it was before the last write window."""
        slots, old = self.last
        src = self.src.clone()
        src[slots] = old
        return src
