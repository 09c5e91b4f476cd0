"""Message-passing primitive seam.

The port's GNN layers all route through these helpers, built on
``index_add_`` and ``scatter_reduce`` (the counterparts of the
reference's ``jax.ops.segment_*``).  Empty segments get
``jax.ops.segment_*``'s identities: 0 for sum, -inf (the dtype's lowest
integer) for max, +inf (the highest) for min.  ``set_use_kernel`` switches
:func:`propagate_matmul` to the hand-written CUDA kernel
(``repro_torch.kernels.segment_mp``); the plain gather -> matmul ->
scatter path is the semantic reference.

Sorted segment ids
------------------
Snapshots from the columnar engine arrive CSC (dst-major) sorted, and
the dynamic-graph pipeline emits batches in that orientation.  Every
helper takes ``sorted_ids``, and :func:`set_sorted_indices` flips the
module default, as in the reference.  ``index_add_`` and
``scatter_reduce`` have no sortedness hint, so the flag only matters
where a path can use it: the kernel path of :func:`propagate_matmul`
skips its sort by dst.  Passing unsorted ids with the flag set is
undefined behaviour, as in ``jax.ops``.
"""

from __future__ import annotations

import torch

_USE_KERNEL = False
_SORTED_DEFAULT = False


def set_use_kernel(flag: bool) -> None:
    """Route :func:`propagate_matmul` through the segment_mp kernel (CUDA
    tensors launch it or raise; CPU tensors take its plain version)."""
    global _USE_KERNEL
    _USE_KERNEL = flag


def set_sorted_indices(flag: bool) -> None:
    """Module default for ``sorted_ids``."""
    global _SORTED_DEFAULT
    _SORTED_DEFAULT = flag


def _sorted(flag: bool) -> bool:
    return bool(flag or _SORTED_DEFAULT)


def _fill(dtype: torch.dtype, op: str):
    """``jax.ops.segment_max``/``segment_min``'s value for an empty
    segment."""
    if dtype.is_floating_point:
        return float("-inf") if op == "amax" else float("inf")
    info = torch.iinfo(dtype)
    return info.min if op == "amax" else info.max


def _segment_reduce(messages: torch.Tensor, segments: torch.Tensor,
                    n: int, op: str) -> torch.Tensor:
    out = messages.new_full((n,) + tuple(messages.shape[1:]),
                            _fill(messages.dtype, op))
    idx = segments.long().view((-1,) + (1,) * (messages.dim() - 1))
    return out.scatter_reduce(0, idx.expand_as(messages), messages, op,
                              include_self=False)


def gather_src(x: torch.Tensor, edge_src: torch.Tensor) -> torch.Tensor:
    return x[edge_src]


def scatter_sum(messages: torch.Tensor, edge_dst: torch.Tensor,
                n_nodes: int, sorted_ids: bool = False) -> torch.Tensor:
    out = messages.new_zeros((n_nodes,) + tuple(messages.shape[1:]))
    return out.index_add(0, edge_dst, messages)


def scatter_mean(messages, edge_dst, n_nodes: int, sorted_ids: bool = False):
    s = scatter_sum(messages, edge_dst, n_nodes, sorted_ids)
    cnt = scatter_sum(messages.new_ones((messages.shape[0],)), edge_dst,
                      n_nodes, sorted_ids)
    return s / torch.clamp(cnt, min=1.0)[:, None]


def scatter_max(messages, edge_dst, n_nodes: int, sorted_ids: bool = False):
    return _segment_reduce(messages, edge_dst, n_nodes, "amax")


def scatter_min(messages, edge_dst, n_nodes: int, sorted_ids: bool = False):
    return _segment_reduce(messages, edge_dst, n_nodes, "amin")


def degree(edge_dst: torch.Tensor, n_nodes: int,
           sorted_ids: bool = False) -> torch.Tensor:
    ones = torch.ones(edge_dst.shape, dtype=torch.float32,
                      device=edge_dst.device)
    return scatter_sum(ones, edge_dst, n_nodes, sorted_ids)


def segment_softmax(logits: torch.Tensor, segments: torch.Tensor,
                    n_segments: int, sorted_ids: bool = False
                    ) -> torch.Tensor:
    """Softmax over variable-size groups (GAT edge attention), taken
    independently over every trailing column of ``logits``."""
    mx = scatter_max(logits, segments, n_segments, sorted_ids)
    mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    ex = torch.exp(logits - mx[segments])
    den = scatter_sum(ex, segments, n_segments, sorted_ids)
    return ex / torch.clamp(den[segments], min=1e-16)


def propagate_matmul(x: torch.Tensor, w: torch.Tensor,
                     edge_src: torch.Tensor, edge_dst: torch.Tensor,
                     n_nodes: int, dst_sorted: bool = False) -> torch.Tensor:
    """Fused gather -> matmul -> scatter-sum: y[v] = sum_{(u,v)} (x[u] @ w).

    With ``set_use_kernel(True)`` it runs through the segment_mp kernel
    (which has no backward and raises on inputs that require grad).
    """
    if _USE_KERNEL:
        from repro_torch.kernels.segment_mp import ops as smp_ops
        return smp_ops.segment_matmul_reduce(
            x, w, edge_src, edge_dst, n_nodes, dst_sorted=_sorted(dst_sorted))
    msgs = gather_src(x, edge_src) @ w
    return scatter_sum(msgs, edge_dst, n_nodes, sorted_ids=dst_sorted)
