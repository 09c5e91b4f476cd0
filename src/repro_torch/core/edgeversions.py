"""Edge versions of a multi-version graph held on one device (§4.1, §4.2).

:class:`~repro_torch.core.mvgraph.PartitionColumns` keeps a Python
:class:`~repro_torch.core.clock.Stamp` and a dict entry per row on the
host, which a graph of a hundred million edges cannot afford.  An
:class:`EdgeVersionTable` keeps the versions on the device instead, one
row a version:

* ``src``, ``dst``: int32 ends;
* ``create_rows``, ``delete_rows``: packed ``(N, C)`` int32 stamp rows
  (``clock.pack``: ``[epoch, c_0..c_{G-1}]``, ``C = G + 1``; an
  all-``NO_STAMP`` delete row means "not deleted", all-``NO_STAMP`` rows
  on both sides mean "purged").

The rows are a base region in destination order (the first
``sorted_rows``) followed by a log of appended versions in the order
written.  A write appends new versions
(:meth:`append`) and sets the delete stamps of the versions it replaces
(:meth:`delete`).  GC purges the versions deleted before a stamp that
every later query follows (:meth:`purge_deleted_before`), and once more
than :data:`~repro_torch.core.mvgraph.COMPACT_DEAD_FRAC` of the rows are
purged, :meth:`maybe_compact` drops them and merges the log back into
destination order, as ``PartitionColumns.maybe_compact`` does for a
partition.

Beside the device table, the host keeps the original :class:`Stamp`
objects of only the rows written since the oldest gatekeeper's last
clock announce (:attr:`EdgeVersionTable.recent`): only those rows can be
concurrent with a later query, and a packed row cannot tell two
gatekeepers' equal vectors apart.  Each one is dropped once every
announced clock covers it (:meth:`settle`).  A query reads the table at
its own refinable timestamp through
:func:`repro_torch.core.analytics.bfs_levels_at`.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..kernels.mv_visibility import ops as mv_ops
from . import clock
from .clock import NO_STAMP, Stamp
from .mvgraph import COMPACT_DEAD_FRAC, COMPACT_MIN_ROWS


def _covers(floor: Stamp, s: Stamp) -> bool:
    """Every clock at or past ``floor`` follows or equals ``s``."""
    return s.epoch < floor.epoch or (
        s.epoch == floor.epoch
        and all(a <= b for a, b in zip(s.clock, floor.clock)))


class EdgeVersionTable:
    """The edge versions of ``n_nodes`` vertices on ``src``'s device (see
    the module note).  ``src`` and ``dst`` are the base load in
    destination order, all created at ``stamp`` (default
    ``clock.zero(n_gk)``: epoch 0, a zero clock, before every
    transaction).  ``capacity`` rows are allocated at once so that
    appends between compactions move nothing; the table grows past it
    when it must."""

    def __init__(self, n_gk: int, n_nodes: int, src: torch.Tensor,
                 dst: torch.Tensor, stamp: Optional[Stamp] = None,
                 capacity: Optional[int] = None):
        if src.shape != dst.shape or src.dim() != 1:
            raise ValueError(f"src {tuple(src.shape)} and dst "
                             f"{tuple(dst.shape)} must be one (E,) shape")
        self.n_gk, self.c = n_gk, n_gk + 1
        self.n_nodes = n_nodes
        self.device = src.device
        e = src.numel()
        self._alloc(max(e, capacity or 0))
        self._src[:e] = src
        self._dst[:e] = dst
        base = clock.pack(stamp if stamp is not None else clock.zero(n_gk),
                          n_gk)
        self._create[:e] = torch.from_numpy(base).to(self.device)
        self._delete[:e] = NO_STAMP
        self.n = e                      # rows in use
        self.sorted_rows = e            # the base region's rows
        self.dead = 0                   # purged rows among them
        #: rows deleted and not yet purged (int64, on the device)
        self.deleted = torch.empty(0, dtype=torch.int64, device=self.device)
        #: row -> [create Stamp, delete Stamp] of the rows written since
        #: the oldest gatekeeper's last announce (None: older)
        self.recent: Dict[int, List[Optional[Stamp]]] = {}

    def _alloc(self, cap: int) -> None:
        dev = self.device
        self._src = torch.empty(cap, dtype=torch.int32, device=dev)
        self._dst = torch.empty(cap, dtype=torch.int32, device=dev)
        self._create = torch.empty((cap, self.c), dtype=torch.int32,
                                   device=dev)
        self._delete = torch.empty((cap, self.c), dtype=torch.int32,
                                   device=dev)

    @property
    def capacity(self) -> int:
        return self._src.numel()

    @property
    def src(self) -> torch.Tensor:
        return self._src[:self.n]

    @property
    def dst(self) -> torch.Tensor:
        return self._dst[:self.n]

    @property
    def create_rows(self) -> torch.Tensor:
        return self._create[:self.n]

    @property
    def delete_rows(self) -> torch.Tensor:
        return self._delete[:self.n]

    def clone(self) -> "EdgeVersionTable":
        copy = object.__new__(type(self))
        copy.__dict__.update(self.__dict__)
        for name in ("_src", "_dst", "_create", "_delete", "deleted"):
            setattr(copy, name, getattr(self, name).clone())
        copy.recent = {r: list(s) for r, s in self.recent.items()}
        return copy

    # ---- writes ------------------------------------------------------------
    def append(self, src: torch.Tensor, dst: torch.Tensor,
               create: torch.Tensor) -> int:
        """New versions ``src -> dst`` created at the packed ``(k, C)``
        rows ``create``, not deleted; returns the first new row."""
        k, first = src.numel(), self.n
        if first + k > self.capacity:
            self._grow(first + k)
        end = first + k
        self._src[first:end] = src
        self._dst[first:end] = dst
        self._create[first:end] = create
        self._delete[first:end] = NO_STAMP
        self.n = end
        return first

    def _grow(self, need: int) -> None:
        old = (self._src, self._dst, self._create, self._delete)
        self._alloc(max(need, self.capacity + self.capacity // 4))
        for new, a in zip((self._src, self._dst, self._create, self._delete),
                          old):
            new[:self.n] = a[:self.n]

    def delete(self, rows: torch.Tensor, stamps: torch.Tensor) -> None:
        """Versions ``rows`` (int64 on the device, live and not deleted)
        deleted at the packed ``(k, C)`` rows ``stamps``."""
        self._delete[rows] = stamps
        self.deleted = torch.cat([self.deleted, rows])

    def remember(self, rows, stamps, side: int) -> None:
        """Keep the original Stamps of rows written since the oldest
        gatekeeper's last announce: ``stamps[i]`` is the create
        (``side`` 0) or delete (``side`` 1) Stamp of row ``rows[i]``,
        replacing the one kept."""
        for r, s in zip(rows, stamps):
            self.recent.setdefault(r, [None, None])[side] = s

    def settle(self, floor: Stamp) -> None:
        """Drop the kept Stamps that every announced clock covers:
        ``floor`` is their least entries (every gatekeeper's clock is at
        or past it), so each covered stamp precedes every later query."""
        self.recent = {r: s for r, s in self.recent.items()
                       if any(x is not None and not _covers(floor, x)
                              for x in s)}

    # ---- GC ----------------------------------------------------------------
    def purge_deleted_before(self, q: Stamp) -> int:
        """Purge every deleted version whose delete stamp precedes ``q``
        (one ``before`` pass over the rows deleted since the last purge):
        invisible at ``q``, it is invisible at every stamp that follows
        ``q``.  Returns how many were purged."""
        rows = self.deleted
        if rows.numel() == 0:
            return 0
        qt = torch.from_numpy(clock.pack(q, self.n_gk)).to(self.device)
        gone = mv_ops.before_mask(self._delete[rows], qt)
        purged = rows[gone]
        self._create[purged] = NO_STAMP
        self._delete[purged] = NO_STAMP
        self.deleted = rows[~gone]
        k = int(purged.numel())
        self.dead += k
        return k

    def dead_fraction(self) -> float:
        return self.dead / self.n if self.n else 0.0

    def maybe_compact(self, dead_frac: float = COMPACT_DEAD_FRAC,
                      min_rows: int = COMPACT_MIN_ROWS
                      ) -> Optional[torch.Tensor]:
        """:meth:`compact` when more than ``dead_frac`` of the rows are
        purged (the partition columns' rule); returns its map, or None."""
        if self.n < min_rows or self.dead_fraction() <= dead_frac:
            return None
        return self.compact()

    def compact(self) -> torch.Tensor:
        """Drop the purged rows and sort the rest into destination order,
        by ``(dst, src)`` and then by row, so the base region and the log
        become one sorted base.  Returns the old-to-new row map (int64,
        -1 where purged); the deleted rows and the kept Stamps follow
        it."""
        n = self.n
        keep = (self._create[:n, 0] != NO_STAMP).nonzero().squeeze(1)
        key = (self._dst[keep].to(torch.int64) << 32) \
            | self._src[keep].to(torch.int64)
        keep = keep[torch.sort(key, stable=True).indices]
        del key
        m = keep.numel()
        for a in (self._src, self._dst, self._create, self._delete):
            a[:m] = a[keep]
        new_of_old = torch.full((n,), -1, dtype=torch.int64,
                                device=self.device)
        new_of_old[keep] = torch.arange(m, device=self.device)
        self.deleted = new_of_old[self.deleted]
        if self.recent:
            rows = list(self.recent)
            moved = new_of_old[torch.tensor(rows, device=self.device)]
            self.recent = {int(r): self.recent[old]
                           for old, r in zip(rows, moved.tolist()) if r >= 0}
        self.n, self.dead, self.sorted_rows = m, 0, m
        return new_of_old
