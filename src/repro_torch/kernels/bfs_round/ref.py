"""Plain PyTorch version of one BFS relaxation round.

The round of ``core/analytics.bfs_levels`` as PyTorch's library kernels
run it: gather ``dist[src]``, clamp at INF - 1 and add 1 (so an
unreached source gives INF, with no overflow), segment min over ``dst``
(an ``amin`` scatter; a vertex with no in-edge gets INF), ``minimum``
with ``dist`` and the changed flag.  It runs on whatever device the
tensors lie on; this is what the CPU path runs and what the CUDA kernel
is held against on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..mv_visibility.ref import unpack_bits

INF = 2 ** 31 - 1


def round_(src: torch.Tensor, dst: torch.Tensor,
           dist: torch.Tensor) -> tuple:
    """``(nd, changed)``: the next levels and whether any differs from
    ``dist`` (a 0-d bool tensor on ``dist``'s device)."""
    src, dst = src.long(), dst.long()
    cand = dist[src].clamp_(max=INF - 1).add_(1)
    seg = cand.new_full(dist.shape, INF).scatter_reduce_(
        0, dst, cand, "amin", include_self=False)
    nd = torch.minimum(dist, seg)
    return nd, (nd != dist).any()


def start(n: int, sources: torch.Tensor) -> tuple:
    """``(levels, flags)`` before the first round, on ``sources``' device:
    two level buffers INF with 0 at each source, both flags 0."""
    dist = torch.full((n,), INF, dtype=torch.int32, device=sources.device)
    dist[sources] = 0
    return [dist, dist.clone()], torch.zeros(2, dtype=torch.int32,
                                             device=sources.device)


def relax(src: torch.Tensor, dst: torch.Tensor, cur: torch.Tensor,
          nxt: torch.Tensor, flags: torch.Tensor, parity: int,
          bits: Optional[torch.Tensor] = None) -> None:
    """The kernel's round (:func:`.kernel.relax`) in plain PyTorch, with
    no mirrors: ``nxt`` becomes :func:`round_` of ``cur`` (with ``bits``,
    int32 words of a visibility bit stream, over the edges whose bit is
    set: :func:`.kernel.relax_masked`), ``flags[parity]`` whether it
    changed, ``flags[parity ^ 1]`` 0."""
    if bits is not None:
        seen = unpack_bits(bits, src.numel())
        src, dst = src[seen], dst[seen]
    nd, changed = round_(src, dst, cur)
    nxt.copy_(nd)
    flags[parity] = changed
    flags[parity ^ 1] = 0
