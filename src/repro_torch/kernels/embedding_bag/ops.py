"""Public EmbeddingBag wrapper (sum/mean, -1 padding, per-sample weights).

A CUDA tensor goes to the CUDA kernel (which launches or raises), mean
mode included: the kernel divides by the weights' sum clamped at 1e-9,
as the reference's ops.py does, and int32 or int64 indices go to it as
they are.  A CPU tensor, or ``use_ref=True``, goes to the plain version
in :mod:`.ref`.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import kernel
from .ref import embedding_bag_ref


def embedding_bag(table: torch.Tensor, idx: torch.Tensor,
                  weights: Optional[torch.Tensor] = None, mode: str = "sum",
                  use_ref: bool = False) -> torch.Tensor:
    if use_ref or table.is_cpu:
        return embedding_bag_ref(table, idx, weights, mode)
    if idx.dtype not in (torch.int32, torch.int64):
        idx = idx.to(torch.int32)
    w = None if weights is None else weights.to(table.dtype).contiguous()
    return kernel.embedding_bag(table, idx.contiguous(), w,
                                mean=mode == "mean")
