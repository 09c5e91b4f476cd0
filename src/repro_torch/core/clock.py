"""Refinable timestamps: epoch-extended vector clocks (paper §3.3, §4.3).

A stamp is ``(epoch, clock[G], gk, ctr)`` where ``clock`` is the issuing
gatekeeper's vector clock at issue time, ``gk`` the issuing gatekeeper id
and ``ctr`` that gatekeeper's local counter (== clock[gk]); ``(gk, ctr)``
uniquely identifies the transaction, matching the paper's "transactions
are identified by their unique vector clocks".

Ordering rules (X ≺ Y):
* lower epoch  ≺  higher epoch (cluster-manager barrier guarantees all
  pre-failure stamps precede all post-failure stamps, §4.3);
* same epoch: vector-clock happens-before — X[i] <= Y[i] for all i and
  X != Y.  Incomparable stamps are CONCURRENT and may need the oracle.

``visibility_mask`` is the batched (torch) form used by the analytics/data
plane: given per-object creation/deletion stamps as int32 tensors, compute
which objects exist in the snapshot at a query stamp.  The CUDA kernels
``repro_torch.kernels.mv_visibility`` implement the same contract; this
module is their semantic reference.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


class Order(enum.Enum):
    BEFORE = -1
    EQUAL = 0
    AFTER = 1
    CONCURRENT = 2


@dataclass(frozen=True)
class Stamp:
    """A refinable timestamp."""

    epoch: int
    clock: Tuple[int, ...]
    gk: int          # issuing gatekeeper
    ctr: int         # issuing gatekeeper's counter at issue (== clock[gk])

    def key(self) -> Tuple[int, Tuple[int, ...], int]:
        """Unique transaction identity — the paper identifies transactions
        by their (unique) vector clocks; the issuing gatekeeper
        disambiguates identical vectors from different gatekeepers."""
        return (self.epoch, self.clock, self.gk)

    def __repr__(self) -> str:  # compact for debugging
        return f"S(e{self.epoch},{list(self.clock)},g{self.gk})"


def compare(a: Stamp, b: Stamp) -> Order:
    if a.epoch != b.epoch:
        return Order.BEFORE if a.epoch < b.epoch else Order.AFTER
    if a.clock == b.clock:
        # identical vectors: same transaction iff same issuing gatekeeper;
        # otherwise indistinguishable but distinct -> concurrent
        return Order.EQUAL if a.gk == b.gk else Order.CONCURRENT
    le = all(x <= y for x, y in zip(a.clock, b.clock))
    if le:
        return Order.BEFORE
    ge = all(x >= y for x, y in zip(a.clock, b.clock))
    if ge:
        return Order.AFTER
    return Order.CONCURRENT


def happens_before(a: Stamp, b: Stamp) -> bool:
    return compare(a, b) is Order.BEFORE


def concurrent(a: Stamp, b: Stamp) -> bool:
    return compare(a, b) is Order.CONCURRENT


def merge(clock_a: Sequence[int], clock_b: Sequence[int]) -> Tuple[int, ...]:
    """Elementwise max (gatekeeper announce handling)."""
    return tuple(max(x, y) for x, y in zip(clock_a, clock_b))


ZERO = None  # set below


def zero(n_gk: int, epoch: int = 0) -> Stamp:
    return Stamp(epoch=epoch, clock=(0,) * n_gk, gk=-1, ctr=0)


# --------------------------------------------------------------------------
# Batched (data-plane) forms.  Stamps are packed as int32 rows:
#   row = [epoch, c_0, ..., c_{G-1}]                       (width G + 1)
# A sentinel row of all INT32_MAX means "no stamp" (e.g. never-deleted).
# --------------------------------------------------------------------------

NO_STAMP = np.iinfo(np.int32).max


def pack(stamp: Optional[Stamp], n_gk: int) -> np.ndarray:
    if stamp is None:
        return np.full((n_gk + 1,), NO_STAMP, dtype=np.int32)
    return np.asarray([stamp.epoch, *stamp.clock], dtype=np.int32)


def pack_many(stamps: Sequence[Optional[Stamp]], n_gk: int) -> np.ndarray:
    if len(stamps) == 0:
        return np.zeros((0, n_gk + 1), dtype=np.int32)
    return np.stack([pack(s, n_gk) for s in stamps])


def _np_before(rows: np.ndarray, q: np.ndarray) -> np.ndarray:
    """rows[i] ≺ q, elementwise over a (N, G+1) array vs a (G+1,) stamp."""
    is_no = rows[:, 0] == NO_STAMP
    lower_epoch = rows[:, 0] < q[0]
    same_epoch = rows[:, 0] == q[0]
    le = np.all(rows[:, 1:] <= q[1:], axis=1)
    eq = np.all(rows[:, 1:] == q[1:], axis=1)
    return np.where(is_no, False, lower_epoch | (same_epoch & le & ~eq))


def visibility_mask_np(create_rows: np.ndarray, delete_rows: np.ndarray,
                       q: np.ndarray) -> np.ndarray:
    """Object visible at q  <=>  create ≺ q  and  not(delete ≺ q).

    Conservative: concurrent creates are NOT visible, concurrent deletes
    ARE visible (the shard resolves true concurrency via the oracle; the
    batched path only answers the comparable majority — paper §4.2).
    """
    return _np_before(create_rows, q) & ~_np_before(delete_rows, q)


def concurrent_mask_np(rows: np.ndarray, q: np.ndarray) -> np.ndarray:
    """rows[i] possibly concurrent with q (numpy analog of
    :func:`concurrent_mask`).

    Same epoch and vector-incomparable, plus the equal-vector case (equal
    vectors from *different* gatekeepers are distinct-but-concurrent; the
    packed row does not carry the gatekeeper id, so callers must resolve
    equal-vector hits against the original :class:`Stamp`).
    """
    is_no = rows[:, 0] == NO_STAMP
    same_epoch = rows[:, 0] == q[0]
    le = np.all(rows[:, 1:] <= q[1:], axis=1)
    ge = np.all(rows[:, 1:] >= q[1:], axis=1)
    eq = le & ge
    return (~is_no) & same_epoch & ((~le & ~ge) | eq)


def _torch_before(rows: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Torch form of :func:`_np_before` (any device)."""
    is_no = rows[:, 0] == NO_STAMP
    lower_epoch = rows[:, 0] < q[0]
    same_epoch = rows[:, 0] == q[0]
    le = torch.all(rows[:, 1:] <= q[1:], dim=1)
    eq = torch.all(rows[:, 1:] == q[1:], dim=1)
    return ~is_no & (lower_epoch | (same_epoch & le & ~eq))


def visibility_mask(create_rows: torch.Tensor, delete_rows: torch.Tensor,
                    q: torch.Tensor) -> torch.Tensor:
    """Torch version of :func:`visibility_mask_np`."""
    return _torch_before(create_rows, q) & ~_torch_before(delete_rows, q)


def concurrent_mask(rows: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Torch version of :func:`concurrent_mask_np`: rows[i] ≈ q (same
    epoch, vector-incomparable or equal)."""
    is_no = rows[:, 0] == NO_STAMP
    same_epoch = rows[:, 0] == q[0]
    le = torch.all(rows[:, 1:] <= q[1:], dim=1)
    ge = torch.all(rows[:, 1:] >= q[1:], dim=1)
    return ~is_no & same_epoch & ((~le & ~ge) | (le & ge))
