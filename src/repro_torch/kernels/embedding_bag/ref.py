"""Plain PyTorch version of EmbeddingBag (sum/mean, per-sample weights).

A copy of the reference's jnp oracle: gather the rows, weight them (pads,
idx -1, read row 0 with weight 0), sum over the bag; mean mode divides
by the weights' sum clamped at 1e-9, not by the count.  idx (B, L) int
with -1 padding; weights (B, L).  It runs on whatever device the tensors
lie on; this is what the CPU path runs and what the CUDA kernel is held
against on the card.
"""

from __future__ import annotations

from typing import Optional

import torch


def embedding_bag_ref(table: torch.Tensor, idx: torch.Tensor,
                      weights: Optional[torch.Tensor] = None,
                      mode: str = "sum") -> torch.Tensor:
    valid = idx >= 0
    safe = torch.where(valid, idx, torch.zeros_like(idx)).long()
    rows = table[safe]                                   # (B, L, D)
    w = torch.ones(idx.shape, dtype=table.dtype, device=table.device) \
        if weights is None else weights.to(table.dtype)
    w = w * valid.to(table.dtype)
    out = torch.sum(rows * w[..., None], dim=1)          # (B, D)
    if mode == "mean":
        cnt = torch.clamp(torch.sum(w, dim=1, keepdim=True), min=1e-9)
        out = out / cnt
    return out
