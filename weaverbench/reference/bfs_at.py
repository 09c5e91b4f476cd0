"""BFS levels at a refinable timestamp over a record of edge versions, in
plain PyTorch, importing nothing of ``repro_torch``: the generator's own
record of every version it wrote (``generators/urand_mv.Record``), not
the port's table.

A version is ``src``, ``dst`` and its create and delete stamps, packed
int32 rows ``[epoch, c_0..c_{G-1}]`` (``2**31 - 1`` in the epoch: no
stamp), given as rows (:func:`visible`) or as indices into a table of
the transactions' stamps (:func:`levels_at`).  ``≺`` is the vector-clock order written out: a lower epoch,
or the same epoch with every entry ``<=`` and not all equal.  A stamp
neither ``≺ T`` nor ``T ≺`` is concurrent with T, and counts as before T
(the timeline oracle's node-program rule: a query goes after a write it
is not ordered with; in this traffic no earlier decision of the oracle
orders a query before a write).  A version is visible at T where its
create stamp is before T and its delete stamp is not.  The levels are
``reference/bfs.levels`` over the visible versions, and the port's
visibility is held to the multiset of the visible versions' ends
(:func:`pair_keys`, :func:`pair_difference`)."""

from __future__ import annotations

import torch

from weaverbench.reference import bfs as ref_bfs

NO_STAMP = 2**31 - 1


def precedes(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a[i] ≺ b[i]`` for packed rows (either side (N, C) or (1, C))."""
    present = (a[:, 0] != NO_STAMP) & (b[:, 0] != NO_STAMP)
    lower = a[:, 0] < b[:, 0]
    same = a[:, 0] == b[:, 0]
    le = (a[:, 1:] <= b[:, 1:]).all(dim=1)
    eq = (a[:, 1:] == b[:, 1:]).all(dim=1)
    return present & (lower | (same & le & ~eq))


def before(rows: torch.Tensor, q: torch.Tensor, refine: bool = True
           ) -> torch.Tensor:
    """Rows ordered before the query ``q`` ((C,)): ``≺ q``, and with
    ``refine`` also those concurrent with it."""
    q = q.reshape(1, -1)
    out = precedes(rows, q)
    if refine:
        out |= (rows[:, 0] != NO_STAMP) & ~out & ~precedes(q, rows)
    return out


def visible(create: torch.Tensor, delete: torch.Tensor, q: torch.Tensor,
            refine: bool = True) -> torch.Tensor:
    """(N,) bool: the versions visible at ``q``."""
    return before(create, q, refine) & ~before(delete, q, refine)


def levels_at(src: torch.Tensor, dst: torch.Tensor, made: torch.Tensor,
              gone: torch.Tensor, stamps: torch.Tensor, q: torch.Tensor,
              n: int, root: int, refine: bool = True):
    """``(levels, visible)``: int32 BFS levels from ``root`` over the
    versions visible at ``q`` (``reference.bfs.UNREACHED`` where none),
    and the (N,) bool visibility of each version.  Version i was created
    by the stamp ``stamps[made[i]]`` and deleted by ``stamps[gone[i]]``
    (a no-stamp row where it was not)."""
    b = before(stamps, q, refine)
    vis = b[made.long()] & ~b[gone.long()]
    return ref_bfs.levels(src[vis], dst[vis], n, root), vis


def pair_keys(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """The sorted int64 keys ``src << 32 | dst`` of a multiset of edges."""
    return torch.sort((src.to(torch.int64) << 32)
                      | dst.to(torch.int64)).values


def pair_difference(a: torch.Tensor, b: torch.Tensor) -> int:
    """The edges in one of two multisets (:func:`pair_keys`) and not in
    the other, each counted as often as its counts differ."""
    if a.numel() == b.numel() and torch.equal(a, b):
        return 0
    keys, inv = torch.unique(torch.cat([a, b]), return_inverse=True)
    na, m = a.numel(), keys.numel()
    diff = (torch.bincount(inv[:na], minlength=m)
            - torch.bincount(inv[na:], minlength=m))
    return int(diff.abs().sum())


def mask_of_bits(words: torch.Tensor, n: int) -> torch.Tensor:
    """(N,) bool of a bit stream held as int32 words, bit k = row k,
    least significant bit first."""
    b = words.contiguous().view(torch.uint8).to(torch.int32)
    k = torch.arange(8, dtype=torch.int32, device=words.device)
    return ((b.unsqueeze(1) >> k) & 1).reshape(-1)[:n].bool()
