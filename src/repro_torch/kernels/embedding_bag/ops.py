"""Public EmbeddingBag wrapper (sum/mean, -1 padding, per-sample weights).

A CUDA tensor goes to the CUDA kernel (which launches or raises); a CPU
tensor, or ``use_ref=True``, goes to the plain version in :mod:`.ref`.
Mean mode is the wrapper's division by the weights' sum clamped at 1e-9,
as in the reference's ops.py.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import kernel
from .ref import embedding_bag_ref


def embedding_bag(table: torch.Tensor, idx: torch.Tensor,
                  weights: Optional[torch.Tensor] = None, mode: str = "sum",
                  use_ref: bool = False) -> torch.Tensor:
    if use_ref or table.device.type == "cpu":
        return embedding_bag_ref(table, idx, weights, mode)
    w = None if weights is None else weights.to(table.dtype).contiguous()
    out = kernel.embedding_bag(table, idx.to(torch.int32).contiguous(), w)
    if mode == "mean":
        valid = (idx >= 0).to(table.dtype)
        w_eff = valid if w is None else w * valid
        cnt = torch.clamp(torch.sum(w_eff, dim=1, keepdim=True), min=1e-9)
        out = out / cnt
    return out
