"""CUDA kernel: EmbeddingBag sums ``out[b] = sum_j w[b, j] *
table[idx[b, j]]`` with -1 pads, and mean mode.

The source is ``src/repro_torch/csrc/embedding_bag.cu`` (``embedding_bag``),
built for ``sm_90a`` at first use and bound with ``ctypes`` (see
:mod:`repro_torch.kernels.build`).  The wrapper takes CUDA tensors only,
checks what it can see without reading the card (device, dtype, shape,
contiguity, ``requires_grad``), allocates the output with ``torch.empty``
and launches on the current stream; it never synchronises and reads no
device memory.  An index at or past the table's rows is caught by the
kernel, which traps: the CUDA error surfaces at the next synchronisation.
``launches["embedding_bag"]`` counts its calls that launched.

The launch shape is a static rule of the shapes and pointers
(:func:`repro_torch.kernels.vec.vec_bytes` and ``group_lanes``, and
:func:`bags_per_group`).

There is no backward: the reference kernel has none, so the wrapper
raises on an input that requires grad rather than return a result
without a gradient.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from .. import build
from ..vec import group_lanes, vec_bytes

SOURCE = "embedding_bag"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INDEX_DTYPES = {torch.int32: 0, torch.int64: 1}
#: independent row loads a group issues before its FMAs
UNROLL = 8
#: rows the kernel indexes (its staged row numbers are int32)
MAX_ROWS = 2 ** 31 - 1

#: launches per kernel since :func:`reset_launches`
launches: Dict[str, int] = {"embedding_bag": 0}

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
_ARGTYPES = [_P, _P, _P, _P, _I64, _I32, _I32, _I64, _I32, _I32, _I32, _I32,
             _I32, _I32, _P]
_bound = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def bind(lib: ctypes.CDLL) -> None:
    """Use ``lib`` (a build of ``csrc/embedding_bag.cu``) for the kernel."""
    global _bound
    lib.embedding_bag.argtypes = _ARGTYPES
    lib.embedding_bag.restype = ctypes.c_int
    _bound = lib


def _lib():
    if _bound is None:
        bind(build.load(SOURCE))
    return _bound


def bags_per_group(l: int) -> int:
    """Consecutive bags one group serves, so that it has at least
    :data:`UNROLL` rows to keep in flight (one bag when L >= UNROLL)."""
    return max(1, -(-UNROLL // max(l, 1)))


def check(table: torch.Tensor, idx: torch.Tensor,
          weights: Optional[torch.Tensor]) -> None:
    """Raise unless the inputs are what the kernel takes: contiguous CUDA
    tensors on one device, none requiring grad; table (V, D) fp32 or
    bf16 with V < 2^31, idx (B, L) int32 or int64, weights None or (B, L)
    in the table's dtype.  Reads metadata only: the indices' range is
    checked by the kernel."""
    ts = (table, idx) if weights is None else (table, idx, weights)
    for t in ts:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"expected a torch.Tensor, got {type(t)}")
    if any(t.requires_grad for t in ts):
        raise ValueError("embedding_bag has no backward: its inputs must "
                         "not require grad (use the plain version to train)")
    if not table.is_cuda:
        raise ValueError(f"the embedding_bag kernel takes CUDA tensors, got "
                         f"{table.device}")
    dev = table.get_device()
    for t in ts:
        if t.get_device() != dev:
            raise ValueError(f"tensors on {t.device} and {table.device}")
        if not t.is_contiguous():
            raise ValueError("embedding_bag inputs must be contiguous")
    if table.dtype not in _DTYPES or table.dim() != 2:
        raise TypeError(f"table must be 2-d fp32 or bf16, got {table.dtype} "
                        f"{tuple(table.shape)}")
    if table.shape[0] > MAX_ROWS:
        raise ValueError(f"{table.shape[0]} rows: the kernel indexes at "
                         f"most {MAX_ROWS}")
    if idx.dtype not in _INDEX_DTYPES or idx.dim() != 2:
        raise TypeError(f"idx must be 2-d int32 or int64, got {idx.dtype} "
                        f"{tuple(idx.shape)}")
    if weights is not None and (weights.dtype != table.dtype
                                or weights.shape != idx.shape):
        raise ValueError(f"weights {weights.dtype} {tuple(weights.shape)} "
                         f"for idx {tuple(idx.shape)} of a {table.dtype} "
                         f"table")


def embedding_bag(table: torch.Tensor, idx: torch.Tensor,
                  weights: Optional[torch.Tensor] = None,
                  mean: bool = False) -> torch.Tensor:
    """(B, D) in the table's dtype: ``sum_j w[b, j] * table[idx[b, j]]``,
    summed in fp32 and rounded once; pads (idx < 0) count as row 0 with
    weight 0, and ``weights=None`` means every weight is 1.  ``mean``
    divides by the bag's sum of effective weights clamped at 1e-9."""
    check(table, idx, weights)
    n_bags, l = idx.shape
    d = table.shape[1]
    out = table.new_empty((n_bags, d))
    if n_bags == 0 or d == 0:
        return out
    if l == 0:
        return out.zero_()
    es = table.element_size()
    vb = vec_bytes(d * es, es, table.data_ptr(), out.data_ptr())
    rc = build.launch_on(
        table, _lib().embedding_bag, table.data_ptr(), idx.data_ptr(),
        None if weights is None else weights.data_ptr(), out.data_ptr(),
        n_bags, l, d, table.shape[0], _DTYPES[table.dtype],
        _INDEX_DTYPES[idx.dtype], vb, group_lanes(d * es // vb),
        bags_per_group(l), int(mean))
    if rc != 0:
        raise RuntimeError(f"embedding_bag launch failed with CUDA error {rc}")
    launches["embedding_bag"] += 1
    return out
