"""Sorted-segment reductions used by the node-program runtime.

``segment_reduce_sorted`` reduces values over *pre-sorted* segment keys
and returns the compressed ``(unique_keys, reduced)`` form a frontier
exchange wants (the next hop's packed frontier IS the unique key set).
numpy inputs take ``ufunc.reduceat`` over the sorted runs; torch tensors
take ``scatter_reduce`` on their own device.

The block-ELL message-passing kernel of the reference package
(``pack_edges`` / ``segment_matmul_reduce``) belongs to the GNN slice and
is not here yet.
"""

from __future__ import annotations

import numpy as np
import torch

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
