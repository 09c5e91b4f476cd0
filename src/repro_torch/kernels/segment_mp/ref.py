"""Plain PyTorch version of fused message passing:

    y[v] = sum_{e : dst[e] = v} x[src[e]] @ W

the SpMM-regime hot op behind GIN/PNA aggregation.  It runs in the
inputs' dtype (as the reference's jnp oracle does), on whatever device
the tensors lie on.  This is what the CPU path runs and what the CUDA
kernel is held against on the card.
"""

from __future__ import annotations

import torch


def segment_matmul_reduce_ref(x: torch.Tensor, w: torch.Tensor,
                              edge_src: torch.Tensor, edge_dst: torch.Tensor,
                              n_nodes: int) -> torch.Tensor:
    msgs = x[edge_src] @ w
    out = msgs.new_zeros((n_nodes, msgs.shape[1]))
    return out.index_add_(0, edge_dst, msgs)
