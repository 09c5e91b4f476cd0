"""CUDA kernel: EmbeddingBag sums ``out[b] = sum_j w[b, j] *
table[idx[b, j]]`` with -1 pads.

The source is ``src/repro_torch/csrc/embedding_bag.cu`` (``embedding_bag``),
built for ``sm_90a`` at first use and bound with ``ctypes`` (see
:mod:`repro_torch.kernels.build`).  The wrapper takes CUDA tensors only,
checks them (including every index against the table's rows, one device
sync), allocates the output with ``torch.empty`` and launches on the
current stream.  ``launches["embedding_bag"]`` counts its calls that
launched.

There is no backward: the reference kernel has none, so the wrapper
raises on an input that requires grad rather than return a result
without a gradient.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from .. import build

SOURCE = "embedding_bag"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: launches per kernel since :func:`reset_launches`
launches: Dict[str, int] = {"embedding_bag": 0}

_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, _P, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
             ctypes.c_int32, _P]
_bound = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _lib():
    global _bound
    if _bound is None:
        lib = build.load(SOURCE)
        lib.embedding_bag.argtypes = _ARGTYPES
        lib.embedding_bag.restype = ctypes.c_int
        _bound = lib
    return _bound


def check(table: torch.Tensor, idx: torch.Tensor,
          weights: Optional[torch.Tensor]) -> None:
    """Raise unless the inputs are what the kernel takes: contiguous CUDA
    tensors on one device, none requiring grad; table (V, D) fp32 or
    bf16, idx (B, L) int32 with every entry < V, weights None or (B, L)
    in the table's dtype."""
    ts = [table, idx] + ([] if weights is None else [weights])
    for t in ts:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"expected a torch.Tensor, got {type(t)}")
    if any(t.requires_grad for t in ts):
        raise ValueError("embedding_bag has no backward: its inputs must "
                         "not require grad (use the plain version to train)")
    if table.device.type != "cuda":
        raise ValueError(f"the embedding_bag kernel takes CUDA tensors, got "
                         f"{table.device}")
    for t in ts:
        if t.device != table.device:
            raise ValueError(f"tensors on {t.device} and {table.device}")
        if not t.is_contiguous():
            raise ValueError("embedding_bag inputs must be contiguous")
    if table.dtype not in _DTYPES or table.dim() != 2:
        raise TypeError(f"table must be 2-d fp32 or bf16, got {table.dtype} "
                        f"{tuple(table.shape)}")
    if idx.dtype != torch.int32 or idx.dim() != 2:
        raise TypeError(f"idx must be 2-d int32, got {idx.dtype} "
                        f"{tuple(idx.shape)}")
    if weights is not None and (weights.dtype != table.dtype
                                or weights.shape != idx.shape):
        raise ValueError(f"weights {weights.dtype} {tuple(weights.shape)} "
                         f"for idx {tuple(idx.shape)} of a {table.dtype} "
                         f"table")
    if idx.numel() and int(idx.max()) >= table.shape[0]:
        raise IndexError(f"index {int(idx.max())} out of range for "
                         f"{table.shape[0]} rows")


def embedding_bag(table: torch.Tensor, idx: torch.Tensor,
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, D) in the table's dtype: ``sum_j w[b, j] * table[idx[b, j]]``,
    summed in fp32; pads (idx < 0) count as row 0 with weight 0, and
    ``weights=None`` means every weight is 1."""
    check(table, idx, weights)
    n_bags, l = idx.shape
    d = table.shape[1]
    out = torch.empty((n_bags, d), dtype=table.dtype, device=table.device)
    if n_bags == 0 or d == 0:
        return out
    if l == 0:
        return out.zero_()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        rc = _lib().embedding_bag(
            table.data_ptr(), idx.data_ptr(),
            None if weights is None else weights.data_ptr(), out.data_ptr(),
            n_bags, l, d, _DTYPES[table.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"embedding_bag launch failed with CUDA error {rc}")
    launches["embedding_bag"] += 1
    return out
