"""CUDA kernels: batched refinable-timestamp compares on the card.

The sources are ``src/repro_torch/csrc/mv_visibility.cu`` (``before``,
``visibility``, ``before_pairs``), built for ``sm_90a`` at first use and
bound with ``ctypes`` (see :mod:`repro_torch.kernels.build`).  Every
wrapper here takes CUDA tensors only, checks them, allocates its output
with ``torch.empty`` and launches on the current stream without
synchronising.  ``launches`` counts each kernel's launches (one per
launch, nowhere else), so a run can show which kernels its path went
through.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import torch

from .. import build

SOURCE = "mv_visibility"

#: launches per kernel since :func:`reset_launches`
launches: Dict[str, int] = {"before": 0, "visibility": 0, "before_pairs": 0}

_P = ctypes.c_void_p
_ARGTYPES = {
    "mv_before": [_P, _P, _P, ctypes.c_int64, ctypes.c_int32, _P],
    "mv_visibility": [_P, _P, _P, _P, ctypes.c_int64, ctypes.c_int32, _P],
    "mv_before_pairs": [_P, _P, _P, ctypes.c_int64, ctypes.c_int32, _P],
}
_bound = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _lib():
    global _bound
    if _bound is None:
        lib = build.load(SOURCE)
        for fn, args in _ARGTYPES.items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        _bound = lib
    return _bound


def check(tables: Sequence[torch.Tensor], q: torch.Tensor,
          per_row: bool) -> None:
    """Raise unless every table is a contiguous (N, C) int32 tensor of one
    shape and device, and ``q`` is a contiguous int32 ``(C,)`` stamp (or
    ``(N, C)`` rows when ``per_row``) on the same device."""
    ref = tables[0]
    for t in (*tables, q):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"expected a torch.Tensor, got {type(t)}")
        if t.dtype != torch.int32:
            raise TypeError(f"stamp rows must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("stamp rows must be contiguous")
        if t.device != ref.device:
            raise ValueError(f"tensors on {t.device} and {ref.device}")
    if ref.dim() != 2 or ref.shape[1] < 1:
        raise ValueError(f"stamp rows must be (N, C), got {tuple(ref.shape)}")
    for t in tables[1:]:
        if t.shape != ref.shape:
            raise ValueError(f"shapes {tuple(t.shape)} != {tuple(ref.shape)}")
    want = tuple(ref.shape) if per_row else (ref.shape[1],)
    if tuple(q.shape) != want:
        raise ValueError(f"query stamp shape {tuple(q.shape)}, want {want}")


def _launch(name: str, fn: str, tables: Sequence[torch.Tensor],
            q: torch.Tensor, per_row: bool) -> torch.Tensor:
    check(tables, q, per_row)
    dev = tables[0].device
    if dev.type != "cuda":
        raise ValueError(f"the {name} kernel takes CUDA tensors, got {dev}")
    n, c = tables[0].shape
    out = torch.empty((n,), dtype=torch.bool, device=dev)
    if n == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(_lib(), fn)(*(t.data_ptr() for t in tables),
                                 q.data_ptr(), out.data_ptr(), n, c, stream)
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed with CUDA error {rc}")
    launches[name] += 1
    return out


def before(rows: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``rows[i] ≺ q``: (N, C) int32, q (C,) int32 -> (N,) bool."""
    return _launch("before", "mv_before", (rows,), q, per_row=False)


def visibility(create: torch.Tensor, delete: torch.Tensor,
               q: torch.Tensor) -> torch.Tensor:
    """``create ≺ q and not delete ≺ q`` -> (N,) bool."""
    return _launch("visibility", "mv_visibility", (create, delete), q,
                   per_row=False)


def before_pairs(rows: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """``rows[i] ≺ qs[i]``: two (N, C) int32 tensors -> (N,) bool."""
    return _launch("before_pairs", "mv_before_pairs", (rows,), qs,
                   per_row=True)
