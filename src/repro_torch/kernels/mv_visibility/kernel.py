"""CUDA kernels: batched refinable-timestamp compares on the card.

The sources are ``src/repro_torch/csrc/mv_visibility.cu`` (``before``,
``visibility``, ``before_pairs``, ``visibility_residue``), built for
``sm_90a`` at first use and bound with ``ctypes`` (see
:mod:`repro_torch.kernels.build`).

Two kinds of entry:

* Device-facing (:func:`before`, :func:`visibility`, :func:`before_pairs`):
  CUDA tensors in, a CUDA tensor out.  Each checks its tensors, allocates
  its output with ``torch.empty`` and launches on the current stream
  without synchronising.  Each returns one bool per row, or with
  ``bits=True`` one int32 word per 32 rows (bit k of the stream is row k,
  least significant bit first).  :func:`visibility_residue` writes the
  visibility bits and, into the caller's buffer, the list of rows whose
  create or delete stamp is concurrent with the query, in one launch.
* Host-facing (:func:`before_host`, :func:`before_pairs_host`,
  :func:`visibility_host`): numpy stamp rows in, a numpy bool mask out,
  in one round trip: the inputs are packed into a pinned host buffer,
  copied to the card in one asynchronous copy, compared by one launch of
  the bit form, the bit words copied back in one asynchronous copy, and
  the stream waited on once.  Inputs over :data:`PACK_LIMIT` bytes skip
  the pinned buffer: each array goes to the card as a pageable copy (the
  CUDA runtime overlaps its own staging copy with the transfer, where
  packing costs a copy on one core first, and pinning a buffer that
  large costs more than the call).  The buffers (:class:`Staging`, one
  per device) grow by doubling and are kept between calls, so a warm
  call allocates nothing.  They belong to the one thread that drives a
  deployment: two threads calling a host entry on one device at once
  would share them.  (A CPU twin of a deployment runs in another
  process, with its own.)

``launches`` counts each kernel's launches (one per launch, nowhere
else), so a run can show which kernels its path went through.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import numpy as np
import torch

from .. import build

SOURCE = "mv_visibility"
#: widest stamp row the kernels take (one warp's tiles of two tables fill
#: a block's 227 KB of shared memory)
MAX_C = 226

#: host-entry inputs above this many bytes are copied to the card from
#: the caller's arrays (pageable) instead of packed into pinned memory;
#: it lies between the sizes phase 2 of chip_smoke.py times the two
#: ways (N 1,024: packed faster; N 1,398,769: pageable faster)
PACK_LIMIT = 1 << 20

#: launches per kernel since :func:`reset_launches`
launches: Dict[str, int] = {"before": 0, "visibility": 0, "before_pairs": 0,
                            "visibility_residue": 0}

#: flag bits of a residue entry ``row << FLAG_BITS | flags`` (the CUDA
#: source's module note): the create or the delete stamp concurrent with
#: the query, and each one before it
CREATE_CONC, DELETE_CONC, CREATE_BEFORE, DELETE_BEFORE = 1, 2, 4, 8
FLAG_BITS = 4

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
_ARGTYPES = {
    "mv_before": [_P, _P, _P, _I64, _I32, _I32, _P],
    "mv_visibility": [_P, _P, _P, _P, _I64, _I32, _I32, _P],
    "mv_before_pairs": [_P, _P, _P, _I64, _I32, _I32, _P],
    "mv_visibility_residue": [_P, _P, _P, _P, _P, _I64, _I64, _I32, _P],
    "mv_compare_host": [_P, _P, _I64, _P, _P, _P, _P, _P, _I64, _I32, _I32,
                        _P],
}
#: the compare modes of ``mv_compare_host``
_MODES = {"before": 0, "before_pairs": 1, "visibility": 2}
_bound = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def bind(lib: ctypes.CDLL) -> None:
    """Use ``lib`` (a build of ``csrc/mv_visibility.cu``) for the kernels."""
    global _bound
    for fn, args in _ARGTYPES.items():
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = ctypes.c_int
    _bound = lib


def _lib():
    if _bound is None:
        bind(build.load(SOURCE))
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


def check_host(tables: Sequence[np.ndarray], q: np.ndarray,
               per_row: bool) -> None:
    """Raise unless every table is an (N, C) integer array of one shape
    and ``q`` an integer ``(C,)`` stamp (or ``(N, C)`` rows when
    ``per_row``)."""
    for a in (*tables, q):
        if not isinstance(a, np.ndarray):
            raise TypeError(f"expected a numpy array, got {type(a)}")
        if not np.issubdtype(a.dtype, np.integer):
            raise TypeError(f"stamp rows must be integers, got {a.dtype}")
    rows = tables[0]
    if rows.ndim != 2 or rows.shape[1] < 1:
        raise ValueError(f"stamp rows must be (N, C), got {rows.shape}")
    for t in tables[1:]:
        if t.shape != rows.shape:
            raise ValueError(f"shapes {t.shape} != {rows.shape}")
    want = rows.shape if per_row else (rows.shape[1],)
    if q.shape != want:
        raise ValueError(f"query stamp shape {q.shape}, want {want}")


def _check_width(c: int) -> None:
    if c > MAX_C:
        raise ValueError(f"stamp rows of width {c} > {MAX_C}: wider than "
                         f"the kernels stage")


def _launch(name: str, fn: str, tables: Sequence[torch.Tensor],
            q: torch.Tensor, per_row: bool, bits: bool) -> torch.Tensor:
    """Launch ``fn`` into a new output: a bool per row, or with ``bits``
    an int32 word per 32 rows."""
    check(tables, q, per_row)
    dev = tables[0].device
    if dev.type != "cuda":
        raise ValueError(f"the {name} kernel takes CUDA tensors, got {dev}")
    n, c = tables[0].shape
    _check_width(c)
    out = (torch.empty(((n + 31) // 32,), dtype=torch.int32, device=dev)
           if bits else torch.empty((n,), dtype=torch.bool, device=dev))
    if n == 0:
        return out
    rc = build.launch_on(tables[0], getattr(_lib(), fn),
                         *(t.data_ptr() for t in tables), q.data_ptr(),
                         out.data_ptr(), n, c, int(bits))
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed with CUDA error {rc}")
    launches[name] += 1
    return out


def before(rows: torch.Tensor, q: torch.Tensor,
           bits: bool = False) -> torch.Tensor:
    """``rows[i] ≺ q``: (N, C) int32, q (C,) int32 -> (N,) bool, or with
    ``bits`` (ceil(N / 32),) int32 words."""
    return _launch("before", "mv_before", (rows,), q, False, bits)


def visibility(create: torch.Tensor, delete: torch.Tensor,
               q: torch.Tensor, bits: bool = False) -> torch.Tensor:
    """``create[i] ≺ q and not delete[i] ≺ q``: two (N, C) int32 tensors,
    q (C,) int32 -> (N,) bool, or with ``bits`` (ceil(N / 32),) int32
    words."""
    return _launch("visibility", "mv_visibility", (create, delete), q,
                   False, bits)


def before_pairs(rows: torch.Tensor, qs: torch.Tensor,
                 bits: bool = False) -> torch.Tensor:
    """``rows[i] ≺ qs[i]``: two (N, C) int32 tensors -> (N,) bool, or with
    ``bits`` (ceil(N / 32),) int32 words."""
    return _launch("before_pairs", "mv_before_pairs", (rows,), qs, True,
                   bits)


def visibility_residue(create: torch.Tensor, delete: torch.Tensor,
                       q: torch.Tensor, res: torch.Tensor) -> torch.Tensor:
    """One launch: the visibility bits (``create[i] ≺ q and not
    delete[i] ≺ q``, (ceil(N / 32),) int32 words) returned, and in ``res``
    (a contiguous int64 CUDA tensor of ``1 + cap`` entries) the count of
    rows whose create or delete stamp is concurrent with ``q`` at
    ``res[0]``, then up to ``cap`` entries ``row << FLAG_BITS | flags`` in
    no set order.  The count keeps counting past ``cap``."""
    check((create, delete), q, per_row=False)
    dev = create.device
    if dev.type != "cuda":
        raise ValueError(f"the visibility_residue kernel takes CUDA tensors, "
                         f"got {dev}")
    if (not isinstance(res, torch.Tensor) or res.dtype != torch.int64
            or res.dim() != 1 or res.numel() < 1 or not res.is_contiguous()
            or res.device != dev):
        raise ValueError(f"the residue list must be a contiguous 1-D int64 "
                         f"tensor of 1 + cap entries on {dev}")
    n, c = create.shape
    _check_width(c)
    out = torch.empty(((n + 31) // 32,), dtype=torch.int32, device=dev)
    if n == 0:
        res[0] = 0
        return out
    rc = build.launch_on(create, _lib().mv_visibility_residue,
                         create.data_ptr(), delete.data_ptr(), q.data_ptr(),
                         out.data_ptr(), res.data_ptr(), res.numel() - 1,
                         n, c)
    if rc != 0:
        raise RuntimeError(f"mv_visibility_residue launch failed with CUDA "
                           f"error {rc}")
    launches["visibility_residue"] += 1
    return out


# ---------------------------------------------------------------------------
# Host-facing entries: one round trip per call
# ---------------------------------------------------------------------------

def _round4(x: int) -> int:
    return (x + 3) & ~3


class Staging:
    """One device's buffers for the host entries: a pinned host buffer
    (the packed inputs, if packed, then the returned bit words), the
    device input buffer and the device bit buffer, each grown by doubling
    and kept."""

    def __init__(self, device: torch.device):
        self.device = device
        self.host = torch.empty((0,), dtype=torch.int32)
        self.host_np = self.host.numpy()
        self.dev_in = torch.empty((0,), dtype=torch.int32, device=device)
        self.dev_bits = torch.empty((0,), dtype=torch.int32, device=device)

    @staticmethod
    def _grown(have: int, need: int) -> int:
        return max(need, 2 * have, 1024)

    def reserve(self, host_words: int, in_words: int,
                bit_words: int) -> None:
        if host_words > self.host.numel():
            self.host = torch.empty(
                (self._grown(self.host.numel(), host_words),),
                dtype=torch.int32, pin_memory=True)
            self.host_np = self.host.numpy()
        if in_words > self.dev_in.numel():
            self.dev_in = torch.empty(
                (self._grown(self.dev_in.numel(), in_words),),
                dtype=torch.int32, device=self.device)
        if bit_words > self.dev_bits.numel():
            self.dev_bits = torch.empty(
                (self._grown(self.dev_bits.numel(), bit_words),),
                dtype=torch.int32, device=self.device)


_staging: Dict[int, Staging] = {}


def staging(device) -> Staging:
    """The host entries' buffers on ``device`` (made at first use)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the stamp-compare kernels run on a CUDA device, "
                         f"got {dev}")
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    st = _staging.get(idx)
    if st is None:
        st = _staging[idx] = Staging(torch.device("cuda", idx))
    return st


def free_staging() -> None:
    """Drop every device's host-entry buffers (they are made again, at
    the size the next call needs, by the next call)."""
    _staging.clear()


def _host_round_trip(name: str, tables: Sequence[np.ndarray],
                     q: np.ndarray, device) -> np.ndarray:
    """One round trip of ``name``'s compare (see the module note)."""
    per_row = name == "before_pairs"
    check_host(tables, q, per_row)
    n, c = tables[0].shape
    st = staging(device)
    if n == 0:
        return np.zeros((0,), bool)
    _check_width(c)
    # the inputs' regions in dev_in (and, when packed, in the pinned
    # buffer), each 16-byte aligned: [rows | qs], [q | rows] or
    # [q | create | delete]
    regions = (*tables, q) if per_row else (q, *tables)
    offs, in_words = [], 0
    for a in regions:
        offs.append(in_words)
        in_words = _round4(in_words + a.size)
    bit_words = (n + 31) // 32
    packed = in_words * 4 <= PACK_LIMIT
    bits_off = in_words if packed else 0        # in the pinned buffer
    st.reserve(bits_off + bit_words, in_words, bit_words)
    buf = st.host_np
    for a, off in zip(regions, offs):
        if packed:
            np.copyto(buf[off:off + a.size].reshape(a.shape), a,
                      casting="unsafe")
        else:                   # pageable, on the stream the launch takes
            st.dev_in[off:off + a.size].copy_(torch.from_numpy(
                np.ascontiguousarray(a, np.int32)).view(-1))
    dev_in = st.dev_in.data_ptr()
    ptr = [dev_in + off * 4 for off in offs]
    if per_row:
        rows, other, q_ptr = ptr[0], ptr[1], 0
    else:
        rows, other, q_ptr = ptr[1], ptr[2] if len(ptr) == 3 else 0, ptr[0]
    rc = build.launch_on(
        st.dev_in, _lib().mv_compare_host, st.host.data_ptr(), dev_in,
        in_words * 4 if packed else 0, rows, other, q_ptr,
        st.dev_bits.data_ptr(), st.host.data_ptr() + bits_off * 4, n, c,
        _MODES[name])
    if rc != 0:
        raise RuntimeError(f"mv_compare_host ({name}) failed with CUDA "
                           f"error {rc}")
    launches[name] += 1
    torch.cuda.current_stream(st.device).synchronize()
    words = buf[bits_off:bits_off + bit_words].view(np.uint8)
    return np.unpackbits(words, count=n, bitorder="little").view(bool)


def before_host(rows: np.ndarray, q: np.ndarray,
                device="cuda") -> np.ndarray:
    """``rows[i] ≺ q`` on the card from host arrays: (N, C) integer rows,
    (C,) q -> (N,) numpy bool, in one round trip (see the module note)."""
    return _host_round_trip("before", (rows,), q, device)


def before_pairs_host(rows: np.ndarray, qs: np.ndarray,
                      device="cuda") -> np.ndarray:
    """``rows[i] ≺ qs[i]`` on the card from two (N, C) host arrays ->
    (N,) numpy bool, in one round trip (see the module note)."""
    return _host_round_trip("before_pairs", (rows,), qs, device)


def visibility_host(create: np.ndarray, delete: np.ndarray, q: np.ndarray,
                    device="cuda") -> np.ndarray:
    """``create[i] ≺ q and not delete[i] ≺ q`` on the card from two (N, C)
    host arrays and a (C,) q -> (N,) numpy bool, in one round trip (see
    the module note)."""
    return _host_round_trip("visibility", (create, delete), q, device)
