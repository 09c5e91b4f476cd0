"""PageRank as the port defines it: ``iters`` synchronous rounds from
``1/n``, ``(1 - damping)/n`` teleport, out-degree clamped at 1 and no
redistribution of a dangling vertex's rank.  Sums by ``bincount`` in
float64; any other ``dtype`` (the control) sums with ``index_add_`` in
that dtype."""

from __future__ import annotations

import torch


def ranks(src: torch.Tensor, dst: torch.Tensor, n: int, iters: int,
          damping: float, dtype=torch.float64) -> torch.Tensor:
    src = src.to(torch.int64)
    dst = dst.to(torch.int64)
    deg = torch.bincount(src, minlength=n).to(dtype).clamp_(min=1)
    pr = torch.full((n,), 1.0 / n, dtype=dtype, device=src.device)
    for _ in range(iters):
        share = (pr / deg)[src]
        if dtype == torch.float64:
            agg = torch.bincount(dst, weights=share, minlength=n)
        else:
            agg = torch.zeros(n, dtype=dtype,
                              device=src.device).index_add_(0, dst, share)
        pr = (1.0 - damping) / n + damping * agg
    return pr
