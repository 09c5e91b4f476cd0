"""CUDA kernel: fused message passing ``y[v] = sum_{(u,v)} x[u] @ W``.

The source is ``src/repro_torch/csrc/segment_mp.cu`` (``segment_mp``),
built for ``sm_90a`` at first use and bound with ``ctypes`` (see
:mod:`repro_torch.kernels.build`).  It takes the dst-sorted CSR layout
(``src`` ordered by dst, ``indptr`` row pointers) that
:func:`repro_torch.kernels.segment_mp.ops.segment_matmul_reduce` builds.
The wrapper takes CUDA tensors only, checks them, allocates the output
and scratch with ``torch.empty`` and launches on the current stream
without synchronising.  ``launches["segment_mp"]`` counts its calls that
launched (one per call, which runs the hub-splitting pass as well when
:func:`plan` finds rows above ``CHUNK`` edges).

There is no backward: neither the reference kernel nor any reference
model differentiates through it, so the wrapper raises on an input that
requires grad rather than return a result without a gradient.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from .. import build

SOURCE = "segment_mp"
#: edges above which a dst row is split into chunks of this many edges,
#: each summed by its own warp (hubs, the pipeline's padding sentinel);
#: short chunks also keep a hub's fp32 sum close to the exact one
CHUNK = 256
#: widest output row the kernel takes (a W tile must fit in shared memory)
MAX_F = 512
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: launches per kernel since :func:`reset_launches`
launches: Dict[str, int] = {"segment_mp": 0}

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
             _I64, _I32, _I32, _I32, _I32, _I64, _I32, _I32, _P]
_bound = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _lib():
    global _bound
    if _bound is None:
        lib = build.load(SOURCE)
        lib.segment_mp.argtypes = _ARGTYPES
        lib.segment_mp.restype = ctypes.c_int
        _bound = lib
    return _bound


def tile_d(f: int) -> int:
    """Columns of x summed per pass: a (tile, F) fp32 W tile stays within
    64 KB of shared memory, at most 128 (4 columns per lane)."""
    return 128 if f <= 128 else 64 if f <= 256 else 32


def plan(indptr: torch.Tensor, chunk: int = CHUNK
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Split every dst row with more than ``chunk`` edges into chunks of at
    most ``chunk`` edges.  Returns int32 ``(heavy_rows, heavy_ptr,
    chunk_lo, chunk_hi)``: the split rows in ascending order, each one's
    range of chunks (``heavy_ptr``, len H+1) and each chunk's edge range.
    Runs on ``indptr``'s device."""
    deg = indptr[1:] - indptr[:-1]
    rows = torch.nonzero(deg > chunk).flatten()
    n_ch = (deg[rows] + chunk - 1) // chunk
    ptr = torch.zeros(rows.numel() + 1, dtype=torch.int64,
                      device=indptr.device)
    torch.cumsum(n_ch, 0, out=ptr[1:])
    owner = torch.repeat_interleave(
        torch.arange(rows.numel(), device=indptr.device), n_ch)
    j = torch.arange(owner.numel(), device=indptr.device) - ptr[owner]
    lo = indptr[rows][owner].long() + j * chunk
    hi = torch.minimum(lo + chunk, indptr[rows + 1][owner].long())
    return rows.int(), ptr.int(), lo.int(), hi.int()


def check(x: torch.Tensor, w: torch.Tensor, src: torch.Tensor,
          indptr: torch.Tensor) -> None:
    """Raise unless the inputs are what the kernel takes: CUDA tensors on
    one device, contiguous, x (N, D) and w (D, F) of one dtype (fp32 or
    bf16) with F <= MAX_F, int32 src (E,) and indptr (N+1,), none
    requiring grad."""
    ts = (x, w, src, indptr)
    for t in ts:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"expected a torch.Tensor, got {type(t)}")
    if any(t.requires_grad for t in ts):
        raise ValueError("segment_mp has no backward: its inputs must not "
                         "require grad (use the plain version to train)")
    if x.device.type != "cuda":
        raise ValueError(f"the segment_mp kernel takes CUDA tensors, got "
                         f"{x.device}")
    for t in ts:
        if t.device != x.device:
            raise ValueError(f"tensors on {t.device} and {x.device}")
        if not t.is_contiguous():
            raise ValueError("segment_mp inputs must be contiguous")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"x and w must share fp32 or bf16, got {x.dtype} "
                        f"and {w.dtype}")
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"shapes x {tuple(x.shape)}, w {tuple(w.shape)}")
    if not 1 <= w.shape[1] <= MAX_F:
        raise ValueError(f"F = {w.shape[1]} outside 1..{MAX_F}")
    if src.dtype != torch.int32 or indptr.dtype != torch.int32:
        raise TypeError("src and indptr must be int32")
    if src.dim() != 1 or tuple(indptr.shape) != (x.shape[0] + 1,):
        raise ValueError(f"src {tuple(src.shape)}, indptr "
                         f"{tuple(indptr.shape)} for N = {x.shape[0]}")


def segment_mp(x: torch.Tensor, w: torch.Tensor, src: torch.Tensor,
               indptr: torch.Tensor) -> torch.Tensor:
    """y (N, F) in w's dtype: ``y[v] = sum_{e in indptr[v]:indptr[v+1]}
    x[src[e]] @ w``, summed in fp32."""
    check(x, w, src, indptr)
    n, d = x.shape
    f = w.shape[1]
    dev = x.device
    y = torch.empty((n, f), dtype=w.dtype, device=dev)
    if n == 0:
        return y
    rows, ptr, lo, hi = plan(indptr)
    partial = torch.empty((lo.numel(), d), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().segment_mp(
            x.data_ptr(), w.data_ptr(), src.data_ptr(), indptr.data_ptr(),
            rows.data_ptr(), ptr.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            partial.data_ptr(), y.data_ptr(), n, d, f, tile_d(f),
            rows.numel(), lo.numel(), CHUNK, _DTYPES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"segment_mp launch failed with CUDA error {rc}")
    launches["segment_mp"] += 1
    return y
