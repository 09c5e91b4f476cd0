"""Plain PyTorch versions of the multi-version visibility kernels.

Stamp rows are ``[epoch, c_0..c_{G-1}]`` int32 in the ``(N, C)``
row-major layout the partitions hold; a row whose epoch is INT32_MAX
means "no stamp" (never deleted).  Visible at q  <=>  create ≺ q  and
not (delete ≺ q), with ``≺`` the epoch-then-vector-clock happens-before
(see ``repro_torch.core.clock``).  These are what the CPU path runs and
what the CUDA kernels are held against on the card.
"""

from __future__ import annotations

import torch

NO_STAMP = 2**31 - 1


def before_pairs(rows: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """``rows[i] ≺ qs[i]``: (N, C) int32 against (N, C) or (1, C) -> (N,)
    bool."""
    is_no = rows[:, 0] == NO_STAMP
    lower = rows[:, 0] < qs[:, 0]
    same = rows[:, 0] == qs[:, 0]
    le = (rows[:, 1:] <= qs[:, 1:]).all(dim=1)
    eq = (rows[:, 1:] == qs[:, 1:]).all(dim=1)
    return ~is_no & (lower | (same & le & ~eq))


def before(rows: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``rows[i] ≺ q``: (N, C) int32, q (C,) int32 -> (N,) bool."""
    return before_pairs(rows, q.unsqueeze(0))


def visibility(create: torch.Tensor, delete: torch.Tensor,
               q: torch.Tensor) -> torch.Tensor:
    """create/delete (N, C) int32, q (C,) int32 -> (N,) bool."""
    return before(create, q) & ~before(delete, q)


def concurrent(rows: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``rows[i]`` concurrent with q: (N, C) int32, q (C,) -> (N,) bool
    (not ``NO_STAMP``, same epoch, vector-incomparable or equal; the
    packed row does not carry the issuing gatekeeper, so equal vectors
    count here and the caller's :class:`Stamp` settles them)."""
    same = (rows[:, 0] != NO_STAMP) & (rows[:, 0] == q[0])
    le = (rows[:, 1:] <= q[1:]).all(dim=1)
    ge = (rows[:, 1:] >= q[1:]).all(dim=1)
    return same & (le == ge)


def visibility_residue(create: torch.Tensor, delete: torch.Tensor,
                       q: torch.Tensor) -> tuple:
    """``(bits, entries)``: the visibility bits (:func:`pack_bits` of
    :func:`visibility`) and, sorted by row, one int64 entry ``row << 4 |
    flags`` for each row whose create or delete stamp is concurrent with
    q (flag bits: 1 create concurrent, 2 delete concurrent, 4 create ≺ q,
    8 delete ≺ q), the kernel's residue mode."""
    cb, db = before(create, q), before(delete, q)
    cc, dc = concurrent(create, q), concurrent(delete, q)
    rows = (cc | dc).nonzero().squeeze(1)
    flags = (cc[rows].long() | dc[rows].long() << 1 | cb[rows].long() << 2
             | db[rows].long() << 3)
    return pack_bits(cb & ~db), rows << 4 | flags


def unpack_bits(words: torch.Tensor, n: int) -> torch.Tensor:
    """(ceil(N / 32),) int32 words -> (N,) bool, the inverse of
    :func:`pack_bits`."""
    shifts = torch.arange(8, dtype=torch.uint8, device=words.device)
    b = words.contiguous().view(torch.uint8)
    return ((b.unsqueeze(1) >> shifts) & 1).view(-1)[:n].bool()


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """(N,) bool -> (ceil(N / 32),) int32 words, bit k of the stream = row
    k, least significant bit first (the kernels' bit form; the bytes of
    the words are ``np.packbits(mask, bitorder="little")``, zero-padded)."""
    n = mask.shape[0]
    words = (n + 31) // 32
    if words == 0:
        return torch.zeros((0,), dtype=torch.int32, device=mask.device)
    bits = torch.zeros((words * 32,), dtype=torch.uint8, device=mask.device)
    bits[:n] = mask
    bits = bits.view(words * 4, 8)
    packed = bits[:, 0].clone()           # byte j: rows 8j .. 8j + 7
    for k in range(1, 8):
        packed |= bits[:, k] << k
    return packed.view(torch.int32)       # little-endian words
