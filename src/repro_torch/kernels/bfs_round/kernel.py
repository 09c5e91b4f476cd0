"""CUDA kernel: one BFS relaxation round, gather, +1 and segment min fused.

The source is ``src/repro_torch/csrc/bfs_round.cu`` (``bfs_round``,
``bfs_round_masked``, ``bfs_start``), built for ``sm_90a`` at first use
and bound with ``ctypes`` (see :mod:`repro_torch.kernels.build`). The
wrappers take CUDA tensors only, check what they can see without reading
the card (device, dtype, shape, contiguity, that the two level buffers
do not overlap), allocate with ``torch.empty`` and launch on the current
stream; they never synchronise and read no device memory.
``launches["bfs_round"]`` counts the rounds launched,
``launches["bfs_round_masked"]`` the masked ones,
``launches["bfs_start"]`` the states set up.

State, for levels in [0, INF]: two int32 level buffers that ping-pong
between rounds, each with a one-byte mirror that the round's gathers
read (the level below 254, 255 for INF, 254 for "read the int32";
:func:`code` is the rule), and two int32 flags.  :func:`start` sets it
up; :func:`relax` runs one round from ``cur`` into ``nxt``.  Given
``nxt >= cur`` everywhere, ``nxt == cur`` at every vertex with no
in-edge and each mirror equal to its buffer (true of what :func:`start`
returns, with the buffers swapped every round), ``nxt`` becomes
``min(cur, min over edges (u, v) of min(cur[u], INF - 1) + 1)``:
:func:`.ref.round_` of ``cur``, bit for bit, and its mirror follows.
``flags[parity]`` gets bit 1 where that lowers some ``cur[v]`` and bit 2
where an edge's end lies outside ``[0, N)`` (the edge is then skipped);
``flags[parity ^ 1]`` is zeroed for the next round.  :func:`relax_masked`
runs the same round over the edges whose bit is set in a visibility bit
stream (``mv_visibility``'s bit form): :func:`.ref.round_` over those
edges alone.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import torch

from .. import build
from .ref import INF

SOURCE = "bfs_round"
#: bits of a round's flag
LOWERED, BAD_INDEX = 1, 2
#: mirror bytes: a level at or above WIDE (and below INF) reads the int32
WIDE, UNREACHED = 254, 255

#: launches per kernel since :func:`reset_launches`
launches: Dict[str, int] = {"bfs_round": 0, "bfs_round_masked": 0,
                            "bfs_start": 0}

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
_ARGTYPES = [_P] * 7 + [_I64, _I32, _I32, _I32, _P]
_MASKED_ARGTYPES = [_P] * 8 + [_I64, _I32, _I32, _I32, _P]
_START_ARGTYPES = [_P] * 6 + [_I64, _I32, _P]
_bound = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def bind(lib: ctypes.CDLL) -> None:
    """Use ``lib`` (a build of ``csrc/bfs_round.cu``) for the kernel."""
    global _bound
    lib.bfs_round.argtypes = _ARGTYPES
    lib.bfs_round.restype = ctypes.c_int
    lib.bfs_round_masked.argtypes = _MASKED_ARGTYPES
    lib.bfs_round_masked.restype = ctypes.c_int
    lib.bfs_start.argtypes = _START_ARGTYPES
    lib.bfs_start.restype = ctypes.c_int
    _bound = lib


def _lib():
    if _bound is None:
        bind(build.load(SOURCE))
    return _bound


def code(levels: torch.Tensor) -> torch.Tensor:
    """The mirror's bytes of int32 ``levels`` (plain version, for tests)."""
    return torch.where(levels == INF, UNREACHED,
                       levels.clamp(max=WIDE)).to(torch.uint8)


def mirror_bytes(n: int) -> int:
    """A mirror's allocation: N bytes rounded up to whole 4-byte words
    (the kernel lowers a byte by a compare-and-swap on its word)."""
    return -(-n // 4) * 4


def start(n: int, sources: torch.Tensor
          ) -> Tuple[List[torch.Tensor], List[torch.Tensor], torch.Tensor]:
    """``(levels, mirrors, flags)`` before the first round, on
    ``sources``' device: both int32 level buffers INF with 0 at each
    source (a negative source counts from N; one outside [-N, N) sets
    bit 2 of ``flags[0]``, which the first round reports), both mirrors
    alike, both flags 0.  ``sources`` is a 1-D CUDA int64 tensor."""
    if not 0 <= n < 2 ** 31:
        raise ValueError(f"{n} vertices: the kernel takes int32 ids")
    if not sources.is_cuda or sources.dtype != torch.int64 \
            or sources.dim() != 1:
        raise ValueError(f"sources must be a 1-D CUDA int64 tensor, got "
                         f"{sources.dtype} {tuple(sources.shape)} on "
                         f"{sources.device}")
    sources = sources.contiguous()
    dev = sources.device
    levels = [torch.empty(n, dtype=torch.int32, device=dev) for _ in "ab"]
    mirrors = [torch.empty(mirror_bytes(n), dtype=torch.uint8, device=dev)
               for _ in "ab"]
    flags = torch.empty(2, dtype=torch.int32, device=dev)
    rc = build.launch_on(sources, _lib().bfs_start,
                         *(t.data_ptr() for t in (*levels, *mirrors, flags,
                                                  sources)),
                         sources.numel(), n)
    if rc != 0:
        raise RuntimeError(f"bfs_start launch failed with CUDA error {rc}")
    launches["bfs_start"] += 1
    return levels, mirrors, flags


def check(src: torch.Tensor, dst: torch.Tensor, cur: torch.Tensor,
          nxt: torch.Tensor, cur8: torch.Tensor, nxt8: torch.Tensor,
          flags: torch.Tensor) -> None:
    """Raise unless the inputs are what the kernel takes: contiguous
    tensors, int32 src and dst (E,), cur and nxt (N,) and flags (2,),
    uint8 mirrors of :func:`mirror_bytes` (N), all on one CUDA device,
    cur and nxt not overlapping.  Reads metadata only."""
    ts = (src, dst, cur, nxt, cur8, nxt8, flags)
    for t in ts:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"expected a torch.Tensor, got {type(t)}")
        want = torch.uint8 if t is cur8 or t is nxt8 else torch.int32
        if t.dtype != want:
            raise TypeError(f"bfs_round takes int32 edges, levels and flags "
                            f"and uint8 mirrors, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("bfs_round inputs must be contiguous")
    if src.dim() != 1 or dst.shape != src.shape:
        raise ValueError(f"src {tuple(src.shape)} and dst "
                         f"{tuple(dst.shape)} must be one (E,) shape")
    if cur.dim() != 1 or nxt.shape != cur.shape:
        raise ValueError(f"cur {tuple(cur.shape)} and nxt "
                         f"{tuple(nxt.shape)} must be one (N,) shape")
    m = mirror_bytes(cur.numel())
    if tuple(cur8.shape) != (m,) or tuple(nxt8.shape) != (m,):
        raise ValueError(f"mirrors must be ({m},) bytes for N = "
                         f"{cur.numel()}, got {tuple(cur8.shape)} and "
                         f"{tuple(nxt8.shape)}")
    if tuple(flags.shape) != (2,):
        raise ValueError(f"flags must be (2,), got {tuple(flags.shape)}")
    if not src.is_cuda:
        raise ValueError(f"the bfs_round kernel takes CUDA tensors, got "
                         f"{src.device}")
    if any(t.device != src.device for t in ts):
        raise ValueError(f"tensors on {sorted({str(t.device) for t in ts})}")
    if any(t.data_ptr() % 4 for t in (cur8, nxt8)):
        raise ValueError("mirrors must start on a 4-byte boundary")
    for a, b in ((cur, nxt), (cur8, nxt8)):
        pa, pb, size = a.data_ptr(), b.data_ptr(), a.numel() * a.itemsize
        if size and pa < pb + size and pb < pa + size:
            raise ValueError("the two level buffers must be distinct")


def relax(src: torch.Tensor, dst: torch.Tensor, cur: torch.Tensor,
          nxt: torch.Tensor, cur8: torch.Tensor, nxt8: torch.Tensor,
          flags: torch.Tensor, parity: int) -> None:
    """One round on the card (the module's contract), in place on ``nxt``,
    ``nxt8`` and ``flags``."""
    check(src, dst, cur, nxt, cur8, nxt8, flags)
    if parity not in (0, 1):
        raise ValueError(f"parity must be 0 or 1, got {parity}")
    vec = int(src.data_ptr() % 16 == 0 and dst.data_ptr() % 16 == 0)
    rc = build.launch_on(src, _lib().bfs_round,
                         *(t.data_ptr() for t in (src, dst, cur, nxt, cur8,
                                                  nxt8, flags)),
                         src.numel(), cur.numel(), parity, vec)
    if rc != 0:
        raise RuntimeError(f"bfs_round launch failed with CUDA error {rc}")
    launches["bfs_round"] += 1


def relax_masked(src: torch.Tensor, dst: torch.Tensor, bits: torch.Tensor,
                 cur: torch.Tensor, nxt: torch.Tensor, cur8: torch.Tensor,
                 nxt8: torch.Tensor, flags: torch.Tensor,
                 parity: int) -> None:
    """One round on the card over the edges whose bit is set in ``bits``
    (contiguous int32, ceil(E / 32) words, bit k = edge k, least
    significant first), in place as :func:`relax`."""
    check(src, dst, cur, nxt, cur8, nxt8, flags)
    if parity not in (0, 1):
        raise ValueError(f"parity must be 0 or 1, got {parity}")
    words = (src.numel() + 31) // 32
    if (not isinstance(bits, torch.Tensor) or bits.dtype != torch.int32
            or tuple(bits.shape) != (words,) or not bits.is_contiguous()
            or bits.device != src.device):
        raise ValueError(f"visibility bits must be a contiguous ({words},) "
                         f"int32 tensor on {src.device}")
    vec = int(src.data_ptr() % 16 == 0 and dst.data_ptr() % 16 == 0)
    rc = build.launch_on(src, _lib().bfs_round_masked,
                         *(t.data_ptr() for t in (src, dst, bits, cur, nxt,
                                                  cur8, nxt8, flags)),
                         src.numel(), cur.numel(), parity, vec)
    if rc != 0:
        raise RuntimeError(f"bfs_round_masked launch failed with CUDA error "
                           f"{rc}")
    launches["bfs_round_masked"] += 1
