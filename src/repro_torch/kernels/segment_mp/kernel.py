"""CUDA kernel: fused message passing ``y[v] = sum_{(u,v)} x[u] @ W``.

The source is ``src/repro_torch/csrc/segment_mp.cu`` (``segment_mp``),
built for ``sm_90a`` at first use and bound with ``ctypes`` (see
:mod:`repro_torch.kernels.build`).  It takes the dst-sorted CSR layout
(``src`` ordered by dst, ``indptr`` row pointers) that
:func:`repro_torch.kernels.segment_mp.ops.segment_matmul_reduce` builds.

:func:`select_order` is the static rule that picks which rows the kernel
gathers: ``"transform"`` (h = x @ W first, then sum h rows) when an fp32
h row is narrower than an x row, else ``"aggregate"`` (sum x rows, then
@ W).  Hub rows are split into chunks by a plan that the kernel builds
on the card (:func:`plan` is its plain version, :func:`plan_on_card`
the kernel's), whose sizes the wrapper takes from N and E alone
(:func:`max_chunks`); the same plan over the chunks' partials splits the
largest hubs a second time.  The wrapper takes CUDA tensors
only, checks their metadata, allocates the output and fp32 scratch with
``torch.empty`` and launches on the current stream; it never
synchronises and reads no device memory.  ``launches["segment_mp"]``
counts its calls that launched, ``launches["segment_mp_aggregate"]`` and
``["segment_mp_transform"]`` those of each order.

There is no backward: neither the reference kernel nor any reference
model differentiates through it, so the wrapper raises on an input that
requires grad rather than return a result without a gradient.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from .. import build
from ..vec import group_lanes, vec_bytes

SOURCE = "segment_mp"
#: edges above which a dst row is split into chunks of this many edges,
#: each summed by its own group of lanes (hubs, the pipeline's padding
#: sentinel); short chunks also keep a hub's fp32 sum close to the exact
#: one
CHUNK = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ORDERS = {"aggregate": 0, "transform": 1}

#: launches per kernel since :func:`reset_launches`
launches: Dict[str, int] = {"segment_mp": 0, "segment_mp_aggregate": 0,
                            "segment_mp_transform": 0}

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
_ARGTYPES = [_P] * 11 + [_I64, _I32, _I32, _I64, _I64] + [_I32] * 5 + [_P]
_PLAN_ARGTYPES = [_P, _I64, _I32, _P, _P, _P]
#: rows per block of the plan's kernels (csrc/segment_mp.cu, kPlanRows)
PLAN_ROWS = 1024
_bound = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def bind(lib: ctypes.CDLL) -> None:
    """Use ``lib`` (a build of ``csrc/segment_mp.cu``) for the kernel."""
    global _bound
    lib.segment_mp.argtypes = _ARGTYPES
    lib.segment_mp.restype = ctypes.c_int
    lib.segment_mp_plan.argtypes = _PLAN_ARGTYPES
    lib.segment_mp_plan.restype = ctypes.c_int
    _bound = lib


def _lib():
    if _bound is None:
        bind(build.load(SOURCE))
    return _bound


def select_order(d: int, f: int, dtype: torch.dtype) -> str:
    """``"transform"`` when an fp32 row of h = x @ W (F * 4 bytes) is
    narrower than a row of x (D * element bytes), so that gathering h
    moves fewer bytes per edge; ``"aggregate"`` otherwise (ties
    included)."""
    return "transform" if f * 4 < d * dtype.itemsize else "aggregate"


def max_chunks(n: int, e: int, chunk: int = CHUNK) -> int:
    """Rows of chunk partials the plan can need, from N and E alone: rows
    above ``chunk`` edges take ceil(deg / chunk) chunks each, at most
    E / chunk + 1 per such row, and at most E // (chunk + 1) rows (and N)
    are such rows."""
    return -(-e // chunk) + min(n, e // (chunk + 1))


def plan(indptr: torch.Tensor, chunk: int = CHUNK) -> torch.Tensor:
    """int32 ``chunk_ptr`` (N+1,): row v's chunks are ``chunk_ptr[v]`` ..
    ``chunk_ptr[v+1]`` (an exclusive prefix sum of ceil(deg / chunk) over
    the rows above ``chunk`` edges; other rows have none).  Chunk k of row
    v covers edges ``indptr[v] + (k - chunk_ptr[v]) * chunk`` up to
    ``chunk`` further, clipped at ``indptr[v+1]``.  ``indptr`` may be any
    row-pointer array: ``plan(plan(indptr))`` is the second level, chunks
    of the partials of the rows that have more than ``chunk``.  This is
    the plain version, on ``indptr``'s device; the kernel builds the same
    plan itself (:func:`plan_on_card`)."""
    deg = indptr[1:] - indptr[:-1]
    n_ch = torch.where(deg > chunk, (deg + (chunk - 1)) // chunk,
                       torch.zeros_like(deg))
    ptr = torch.zeros(indptr.numel(), dtype=torch.int32,
                      device=indptr.device)
    torch.cumsum(n_ch, 0, dtype=torch.int32, out=ptr[1:])
    return ptr


def plan_on_card(indptr: torch.Tensor, chunk: int = CHUNK) -> torch.Tensor:
    """:func:`plan` as the kernel builds it (``segment_mp_plan``), for a
    CUDA int32 ``indptr`` of N+1 >= 2 entries; nothing is read back."""
    n = indptr.numel() - 1
    out = indptr.new_empty(n + 1)
    counts = indptr.new_empty(-(-n // PLAN_ROWS) + 1)
    rc = build.launch_on(indptr, _lib().segment_mp_plan, indptr.data_ptr(),
                         n, chunk, counts.data_ptr(), out.data_ptr())
    if rc != 0:
        raise RuntimeError(f"segment_mp_plan failed with CUDA error {rc}")
    return out


def check(x: torch.Tensor, w: torch.Tensor, src: torch.Tensor,
          indptr: torch.Tensor) -> None:
    """Raise unless the inputs are what the kernel takes: CUDA tensors on
    one device, contiguous, x (N, D) and w (D, F) of one dtype (fp32 or
    bf16), int32 src (E,) and indptr (N+1,), none requiring grad.
    Reads metadata only."""
    ts = (x, w, src, indptr)
    for t in ts:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"expected a torch.Tensor, got {type(t)}")
    if any(t.requires_grad for t in ts):
        raise ValueError("segment_mp has no backward: its inputs must not "
                         "require grad (use the plain version to train)")
    if not x.is_cuda:
        raise ValueError(f"the segment_mp kernel takes CUDA tensors, got "
                         f"{x.device}")
    dev = x.get_device()
    for t in ts:
        if t.get_device() != dev:
            raise ValueError(f"tensors on {t.device} and {x.device}")
        if not t.is_contiguous():
            raise ValueError("segment_mp inputs must be contiguous")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"x and w must share fp32 or bf16, got {x.dtype} "
                        f"and {w.dtype}")
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"shapes x {tuple(x.shape)}, w {tuple(w.shape)}")
    if w.shape[1] < 1:
        raise ValueError("F must be at least 1")
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
    y = w.new_empty((n, f))
    if n == 0:
        return y
    order = select_order(d, f, x.dtype)
    if order == "transform":                 # gather rows of h = x @ w
        width, es, ptrs = f, 4, ()
    else:                                    # gather rows of x
        width, es, ptrs = d, x.element_size(), (x.data_ptr(),)
    vb = vec_bytes(width * es, es, *ptrs)
    scratch = x.new_empty((n, width), dtype=torch.float32)
    n_part = max_chunks(n, src.numel())      # chunks of a hub's edges
    n_part2 = max_chunks(n, n_part)          # chunks of its partials
    partial = x.new_empty((n_part + n_part2, width), dtype=torch.float32)
    # the plan's two levels and the workspace of its scan, built by the
    # kernel
    ints = indptr.new_empty(2 * (n + 1) + -(-n // PLAN_ROWS) + 1)
    rc = build.launch_on(
        x, _lib().segment_mp, x.data_ptr(), w.data_ptr(), src.data_ptr(),
        indptr.data_ptr(), ints.data_ptr(), partial.data_ptr(),
        ints[n + 1:].data_ptr(), partial[n_part:].data_ptr(),
        ints[2 * (n + 1):].data_ptr(), scratch.data_ptr(), y.data_ptr(), n,
        d, f, n_part, n_part2, CHUNK, _ORDERS[order], vb,
        group_lanes(width * es // vb), _DTYPES[x.dtype])
    if rc != 0:
        raise RuntimeError(f"segment_mp launch failed with CUDA error {rc}")
    launches["segment_mp"] += 1
    launches[f"segment_mp_{order}"] += 1
    return y
