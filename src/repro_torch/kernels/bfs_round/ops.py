"""Public wrapper of the BFS relaxation rounds (``core/analytics.bfs_levels``).

:class:`Rounds` holds one search's state on one device and runs its
rounds: on a card through the CUDA kernel (which launches or raises),
on the CPU through the plain version in :mod:`.ref`.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import kernel, ref


class Rounds:
    """The state of one BFS from ``sources`` (a 1-D int64 tensor, on the
    search's device) over ``n`` vertices: two level buffers that
    ping-pong (round r reads ``levels[r & 1]`` and writes the other), the
    two flags (round r sets ``flags[r & 1]`` and zeroes the other) and, on
    a card, each buffer's byte mirror."""

    def __init__(self, n: int, sources: torch.Tensor):
        if sources.is_cuda:
            self.levels, self.mirrors, self.flags = kernel.start(n, sources)
        else:
            self.levels, self.flags = ref.start(n, sources)
            self.mirrors = None

    def relax(self, src: torch.Tensor, dst: torch.Tensor, r: int,
              bits: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Round ``r`` (from 0) over the edges ``src`` -> ``dst`` (with
        ``bits``, a visibility bit stream of int32 words, over the edges
        whose bit is set); returns the levels it wrote.  ``flags[r & 1]``
        then holds bit 1 where a level changed and, on a card, bit 2 where
        an edge's end or a source lay outside [0, N)."""
        p = r & 1
        cur, nxt = self.levels[p], self.levels[p ^ 1]
        if self.mirrors is None:
            ref.relax(src, dst, cur, nxt, self.flags, p, bits)
        elif bits is None:
            kernel.relax(src, dst, cur, nxt, self.mirrors[p],
                         self.mirrors[p ^ 1], self.flags, p)
        else:
            kernel.relax_masked(src, dst, bits, cur, nxt, self.mirrors[p],
                                self.mirrors[p ^ 1], self.flags, p)
        return nxt
