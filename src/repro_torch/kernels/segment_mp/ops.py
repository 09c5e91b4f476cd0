"""Public wrappers of the segment_mp kernel, and the sorted-segment
reductions used by the node-program runtime.

``segment_matmul_reduce`` is fused message passing, ``y[v] = sum_{(u,v)}
x[u] @ W``: a CUDA tensor goes to the CUDA kernel (which launches or
raises); a CPU tensor goes to the plain PyTorch version in :mod:`.ref`.
Its layout prep runs on the tensors' device: a stable sort of the edges
by dst (skipped when the caller says they are sorted) and CSR row
pointers.  The reference's ``pack_edges``, which padded every dst block's
edges to whole tiles of the TPU's block-ELL layout, is replaced by this
CSR prep and not carried over: the CUDA kernel reads unpadded rows.

``segment_reduce_sorted`` reduces values over *pre-sorted* segment keys
and returns the compressed ``(unique_keys, reduced)`` form a frontier
exchange wants (the next hop's packed frontier IS the unique key set).
numpy inputs take ``ufunc.reduceat`` over the sorted runs; torch tensors
take ``scatter_reduce`` on their own device.
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernel, ref

_REDUCERS = {
    "min": (np.minimum, "amin"),
    "max": (np.maximum, "amax"),
    "sum": (np.add, "sum"),
}


def segment_starts(keys):
    """Run starts of a sorted key array: positions where a new segment
    begins (``keys`` must be non-decreasing)."""
    if isinstance(keys, torch.Tensor):
        if keys.numel() == 0:
            return torch.zeros(0, dtype=torch.int64, device=keys.device)
        new = torch.ones_like(keys, dtype=torch.bool)
        new[1:] = keys[1:] != keys[:-1]
        return torch.nonzero(new).flatten()
    if keys.size == 0:
        return np.zeros(0, np.int64)
    return np.flatnonzero(np.r_[True, keys[1:] != keys[:-1]])


def segment_reduce_sorted(values, keys, op: str = "min"):
    """Reduce ``values`` over equal runs of the SORTED ``keys``.

    Returns ``(unique_keys, reduced)`` — compressed form, one entry per
    distinct key in ascending order, of the same array type as the
    inputs.
    """
    ufunc, torch_op = _REDUCERS[op]
    if isinstance(keys, torch.Tensor):
        if keys.numel() == 0:
            return keys, values[:0]
        starts = segment_starts(keys)
        seg_ids = torch.cumsum(torch.ne(keys[1:], keys[:-1]), 0)
        seg_ids = torch.cat([seg_ids.new_zeros(1), seg_ids])
        out = values.new_empty(starts.numel())
        out.scatter_reduce_(0, seg_ids, values, torch_op, include_self=False)
        return keys[starts], out
    values = np.asarray(values)
    keys = np.asarray(keys)
    if keys.size == 0:
        return keys, values[:0]
    starts = segment_starts(keys)
    return keys[starts], ufunc.reduceat(values, starts)


def segment_count_sorted(keys):
    """(unique_keys, run_lengths) of a sorted key array."""
    if isinstance(keys, torch.Tensor):
        if keys.numel() == 0:
            return keys, torch.zeros(0, dtype=torch.int64, device=keys.device)
        starts = segment_starts(keys)
        ends = torch.cat([starts[1:], starts.new_tensor([keys.numel()])])
        return keys[starts], ends - starts
    keys = np.asarray(keys)
    if keys.size == 0:
        return keys, np.zeros(0, np.int64)
    starts = segment_starts(keys)
    return keys[starts], np.diff(np.r_[starts, keys.size])


def csr_indptr(dst_sorted: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """int32 row pointers (N+1,) of a non-decreasing dst array."""
    bounds = torch.arange(n_nodes + 1, dtype=dst_sorted.dtype,
                          device=dst_sorted.device)
    return torch.searchsorted(dst_sorted, bounds).int()


def segment_matmul_reduce(x: torch.Tensor, w: torch.Tensor,
                          edge_src: torch.Tensor, edge_dst: torch.Tensor,
                          n_nodes: int, dst_sorted: bool = False
                          ) -> torch.Tensor:
    """``y[v] = sum_{e: dst[e] = v} x[src[e]] @ w`` -> (n_nodes, F) in
    w's dtype.  On the CPU this is the plain version; on the card the
    edges are sorted by dst (stable; skipped when ``dst_sorted``, a
    promise the caller keeps), turned into CSR and handed to the kernel.
    """
    if x.device.type == "cpu":
        return ref.segment_matmul_reduce_ref(x, w, edge_src, edge_dst,
                                             n_nodes)
    if x.shape[0] != n_nodes:
        raise ValueError(f"x has {x.shape[0]} rows for {n_nodes} nodes")
    if edge_src.numel() >= 2**31:
        raise ValueError("segment_mp indexes edges with int32")
    src = edge_src.to(x.device)
    dst = edge_dst.to(x.device)
    if not dst_sorted:
        dst, order = torch.sort(dst, stable=True)
        src = src[order]
    indptr = csr_indptr(dst.contiguous(), n_nodes)
    return kernel.segment_mp(x.contiguous(), w.contiguous(),
                             src.int().contiguous(), indptr)
