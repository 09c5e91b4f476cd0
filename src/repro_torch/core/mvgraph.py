"""In-memory multi-version graph partition held by a shard server (§4.1).

Every write marks the object with the refinable timestamp of its
transaction instead of mutating in place:

* a vertex/edge has ``create_ts`` and (optionally) ``delete_ts``;
* a property is a list of timestamped versions per key; reads at stamp T
  return the latest version visible at T.

Visibility at stamp ``T`` (for snapshot reads by node programs, §4.2):
``create_ts ≺ T  and  not (delete_ts ≺ T)``.  If a relevant stamp is
*concurrent* with T, the caller (shard server) must refine through the
timeline oracle — this module reports concurrency instead of guessing.

Columnar mirror (data-plane hot path)
-------------------------------------
Besides the per-object dict structures (which serve the shard's own
node-program reads), every partition incrementally maintains a
struct-of-arrays mirror, :class:`PartitionColumns`:

* vertices: ``v_gid`` (slot -> global interned vid id), packed
  ``v_create`` / ``v_delete`` stamp matrices of shape ``(N, G+1)`` int32
  (row = ``[epoch, c_0..c_{G-1}]``, all-``NO_STAMP`` = absent), plus the
  original :class:`~repro_torch.core.clock.Stamp` objects for oracle
  refinement of truly concurrent rows;
* edges: ``e_src`` / ``e_dst`` interned-id columns with the same packed
  stamp matrices;
* property *versions* as columns too: per table (vertex / edge) an
  append-only log of (owner slot, interned key id, interned value id,
  float mirror, packed stamp) rows — the latest row visible at ``T`` per
  (owner, key) is the property value at ``T``, so node programs that
  filter on edge properties or read weights run on the data plane
  (``repro_torch.core.frontier``) without touching a Python dict;
* a monotone ``version`` and per-table patch logs so snapshot caches can
  do **delta refresh**: re-evaluate only slots whose stamps changed since
  the cached build instead of rescanning O(V+E) objects.

Columns are append-mostly: creates append a slot, deletes/GC patch the
slot's stamp rows in place (GC "purges" a slot by writing all-``NO_STAMP``
rows, which no query stamp can ever see).  Vertex ids are interned
through a :class:`VidIntern` shared across all partitions of a deployment
so that edge endpoints are cross-shard-resolvable integers at write time
— the snapshot engine (``repro_torch.core.analytics``) never touches a Python
string on the per-object path.

GC compaction
-------------
Purged slots (all-``NO_STAMP`` rows) used to accumulate forever.  When
the dead fraction of a partition's columns exceeds
:data:`COMPACT_DEAD_FRAC`, :meth:`PartitionColumns.maybe_compact`
rewrites every table keeping only live slots and appends a
:class:`CompactionEvent` (old→new slot maps plus the pre-compaction
patch logs) to ``events`` so snapshot caches can *remap* their cached
rows instead of rebuilding cold — see
``analytics.SnapshotEngine._consume_changes``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from . import clock as _clock
from .clock import NO_STAMP, Order, Stamp, compare, pack


@dataclass
class Versioned:
    value: object
    ts: Stamp
    slot: int = -1          # row in the partition's property columns


@dataclass
class MVEdge:
    eid: int
    src: str
    dst: str
    create_ts: Stamp
    delete_ts: Optional[Stamp] = None
    props: Dict[str, List[Versioned]] = field(default_factory=dict)


@dataclass
class MVVertex:
    vid: str
    create_ts: Stamp
    delete_ts: Optional[Stamp] = None
    out_edges: Dict[int, MVEdge] = field(default_factory=dict)
    props: Dict[str, List[Versioned]] = field(default_factory=dict)


class ConcurrencyUnresolved(Exception):
    """A visibility decision needs the timeline oracle."""

    def __init__(self, a: Stamp, b: Stamp):
        super().__init__(f"concurrent stamps {a} vs {b}")
        self.pair = (a, b)


def _before(a: Stamp, b: Stamp,
            refine: Optional[Callable[[Stamp, Stamp], Order]] = None) -> bool:
    o = compare(a, b)
    if o is Order.CONCURRENT:
        if refine is None:
            raise ConcurrencyUnresolved(a, b)
        o = refine(a, b)
    return o is Order.BEFORE


def visible(create_ts: Stamp, delete_ts: Optional[Stamp], at: Stamp,
            refine: Optional[Callable[[Stamp, Stamp], Order]] = None) -> bool:
    if not _before(create_ts, at, refine):
        return False
    if delete_ts is not None and _before(delete_ts, at, refine):
        return False
    return True


class VidIntern:
    """Process-wide vid -> dense int32 id table (shared by all partitions
    of one deployment so edge endpoints resolve across shards)."""

    __slots__ = ("ids", "vids")

    def __init__(self) -> None:
        self.ids: Dict[str, int] = {}
        self.vids: List[str] = []

    def intern(self, vid: str) -> int:
        i = self.ids.get(vid)
        if i is None:
            i = len(self.vids)
            self.ids[vid] = i
            self.vids.append(vid)
        return i

    def __len__(self) -> int:
        return len(self.vids)


class PropIntern:
    """Per-partition value/key intern table.

    Hashable objects are deduplicated (value -> dense id); unhashable
    values get a fresh id each time (they can never be filter targets
    anyway).  ``lookup`` probes without inserting — the frontier runtime
    uses it to translate a filter constant into this partition's id
    space (-1 = the partition has never seen the value)."""

    __slots__ = ("ids", "vals")

    def __init__(self) -> None:
        self.ids: Dict[object, int] = {}
        self.vals: List[object] = []

    def intern(self, v) -> int:
        try:
            i = self.ids.get(v)
        except TypeError:                 # unhashable: fresh id, no dedup
            self.vals.append(v)
            return len(self.vals) - 1
        if i is None:
            i = len(self.vals)
            self.ids[v] = i
            self.vals.append(v)
        return i

    def lookup(self, v) -> int:
        try:
            return self.ids.get(v, -1)
        except TypeError:
            return -1

    def __len__(self) -> int:
        return len(self.vals)


class _GrowRows:
    """Growable (N, C) int32 matrix with amortized O(1) row appends."""

    __slots__ = ("c", "n", "buf")

    def __init__(self, c: int, cap: int = 64) -> None:
        self.c = c
        self.n = 0
        self.buf = np.empty((cap, c), np.int32)

    def _reserve(self, k: int) -> None:
        if self.n + k > self.buf.shape[0]:
            nu = np.empty((max(2 * self.buf.shape[0], self.n + k, 64),
                           self.c), np.int32)
            nu[:self.n] = self.buf[:self.n]
            self.buf = nu

    def append(self, row: np.ndarray) -> int:
        self._reserve(1)
        self.buf[self.n] = row
        self.n += 1
        return self.n - 1

    def extend(self, rows: np.ndarray) -> int:
        """Append a whole (K, C) block in one memcpy; returns the first
        new row index (group-commit bulk apply)."""
        k = rows.shape[0]
        self._reserve(k)
        self.buf[self.n:self.n + k] = rows
        start = self.n
        self.n += k
        return start

    def set(self, i: int, row: np.ndarray) -> None:
        self.buf[i] = row

    def view(self) -> np.ndarray:
        return self.buf[:self.n]

    def reset_to(self, rows: np.ndarray) -> None:
        """Replace contents (compaction rebuild)."""
        self.n = rows.shape[0]
        if self.n > self.buf.shape[0]:
            self.buf = np.empty((max(64, self.n * 5 // 4), self.c), np.int32)
        self.buf[:self.n] = rows


class _GrowInts:
    """Growable (N,) int32 vector with amortized O(1) appends (the
    reallocation policy is dtype-agnostic, so the float subclass only
    overrides its buffer)."""

    __slots__ = ("n", "buf")

    def __init__(self, cap: int = 64) -> None:
        self.n = 0
        self.buf = np.empty((cap,), np.int32)

    def _reserve(self, k: int) -> None:
        if self.n + k > self.buf.shape[0]:
            nu = np.empty((max(2 * self.buf.shape[0], self.n + k, 64),),
                          self.buf.dtype)
            nu[:self.n] = self.buf[:self.n]
            self.buf = nu

    def append(self, x) -> int:
        self._reserve(1)
        self.buf[self.n] = x
        self.n += 1
        return self.n - 1

    def extend(self, xs: np.ndarray) -> int:
        """Append a (K,) block in one memcpy; returns the first new
        index."""
        k = xs.shape[0]
        self._reserve(k)
        self.buf[self.n:self.n + k] = xs
        start = self.n
        self.n += k
        return start

    def view(self) -> np.ndarray:
        return self.buf[:self.n]

    def reset_to(self, xs: np.ndarray) -> None:
        self.n = xs.shape[0]
        if self.n > self.buf.shape[0]:
            self.buf = np.empty((max(64, self.n * 5 // 4),), self.buf.dtype)
        self.buf[:self.n] = xs


class _GrowFloats(_GrowInts):
    """Growable (N,) float64 vector (numeric mirror of property values)."""

    def __init__(self, cap: int = 64) -> None:
        self.n = 0
        self.buf = np.empty((cap,), np.float64)


class _GrowInts64(_GrowInts):
    """Growable (N,) int64 vector (edge ids are client-side 64-bit:
    ``(client_id << 32) | counter``)."""

    def __init__(self, cap: int = 64) -> None:
        self.n = 0
        self.buf = np.empty((cap,), np.int64)


class _PropTable:
    """Append-only property-version columns for one owner table.

    One row per ``set_*_prop`` call: owner slot, interned key id,
    interned value id, float mirror (NaN when the value is not a real
    number), packed stamp row + original :class:`Stamp` for oracle
    refinement.  Purges (GC / owner re-create) overwrite the stamp row
    with all-``NO_STAMP`` and log the row in ``patch`` — the same
    delta-refresh contract as ``v_patch``/``e_patch``, consumed through
    :meth:`cursor` by :class:`~repro_torch.core.frontier.ShardPlan` to keep
    its property views fresh at O(changed).  :meth:`compact` returns an
    old→new row map (mirrored into :class:`CompactionEvent` as
    ``vp_map``/``ep_map``), so consumers can remap cached property state
    across a compaction instead of re-reading the whole table.

    Group-commit batch mode (:meth:`begin_batch` / :meth:`end_batch`):
    appends between the two calls are buffered in Python lists (slot
    numbering assigned eagerly, so same-batch purges still resolve) and
    flushed as ONE column extend + ONE patch-log extend — a
    :class:`WriteBatch` applies with one stamp-matrix append per table
    instead of one per op.  Consumers never observe the open batch: the
    shard applies a batch atomically within one simulator event."""

    def __init__(self, c: int) -> None:
        self.c = c
        self._no_row = np.full((c,), NO_STAMP, np.int32)
        self.owner = _GrowInts()
        self.key = _GrowInts()
        self.val = _GrowInts()
        self.num = _GrowFloats()
        self.stamp = _GrowRows(c)
        self.stamp_obj: List[Optional[Stamp]] = []
        self.ver: List[Optional["Versioned"]] = []   # backrefs for remap
        self.by_owner: Dict[int, List[int]] = {}
        self.patch: List[int] = []
        self._batch: Optional[dict] = None     # open bulk-append buffer

    @property
    def n(self) -> int:
        return self.owner.n

    def cursor(self) -> List[int]:
        """Consume cursor ``[n_rows, len(patch)]`` for delta consumers
        (appends are implied by row growth, in-place purges by the patch
        log).  The patch log is cleared at compaction — a consumer that
        observes a new :class:`CompactionEvent` remaps its rows through
        the event's ``vp_map``/``ep_map`` and recovers the unread patch
        tail from ``old_vp_patch``/``old_ep_patch``."""
        return [self.n, len(self.patch)]

    @staticmethod
    def _as_num(value) -> float:
        if isinstance(value, bool) or not isinstance(
                value, (int, float, np.integer, np.floating)):
            return float("nan")
        try:
            return float(value)
        except (TypeError, OverflowError):  # pragma: no cover - exotic
            return float("nan")

    def append(self, owner_slot: int, key_id: int, val_id: int,
               value, row: np.ndarray, ts: Stamp,
               ver: Optional["Versioned"] = None) -> int:
        b = self._batch
        if b is None:
            slot = self.owner.append(owner_slot)
            self.key.append(key_id)
            self.val.append(val_id)
            self.num.append(self._as_num(value))
            self.stamp.append(row)
        else:
            slot = b["base"] + len(b["owner"])
            b["owner"].append(owner_slot)
            b["key"].append(key_id)
            b["val"].append(val_id)
            b["num"].append(self._as_num(value))
            b["stamp"].append(row)
        self.stamp_obj.append(ts)
        self.ver.append(ver)
        self.by_owner.setdefault(owner_slot, []).append(slot)
        return slot

    def purge(self, slot: int) -> None:
        if slot < 0:
            return
        b = self._batch
        if b is not None and slot >= b["base"]:   # row still buffered
            b["stamp"][slot - b["base"]] = self._no_row
        else:
            self.stamp.set(slot, self._no_row)
        self.stamp_obj[slot] = None
        self.ver[slot] = None
        (self.patch if b is None else b["patch"]).append(slot)

    # ---- group-commit bulk append (see class docstring) ------------------
    def begin_batch(self) -> None:
        assert self._batch is None, "nested property batch"
        self._batch = {"base": self.n, "owner": [], "key": [], "val": [],
                       "num": [], "stamp": [], "patch": []}

    def end_batch(self) -> None:
        b = self._batch
        self._batch = None
        if b["owner"]:
            self.owner.extend(np.asarray(b["owner"], np.int32))
            self.key.extend(np.asarray(b["key"], np.int32))
            self.val.extend(np.asarray(b["val"], np.int32))
            self.num.extend(np.asarray(b["num"], np.float64))
            self.stamp.extend(np.stack(b["stamp"]))
        if b["patch"]:
            self.patch.extend(b["patch"])

    def purge_owner(self, owner_slot: int) -> int:
        """Purge every version row of one owner (re-create / owner GC)."""
        rows = self.by_owner.pop(owner_slot, [])
        for r in rows:
            self.purge(r)
        return len(rows)

    def compact(self, owner_map: np.ndarray
                ) -> Tuple[np.ndarray, List[int], int]:
        """Drop purged rows / rows of dropped owners; remap the rest.

        Returns ``(row_map, old_patch, old_n)``: the old→new row map
        (-1 = dropped), the FULL pre-compaction patch log (old
        numbering) and the pre-compaction row count — the same remap
        contract as :class:`CompactionEvent`'s ``v_map``/``e_map``, so
        plan caches can carry property state across a compaction at
        O(changed) instead of re-reading the whole table."""
        n = self.n
        old_patch = self.patch
        if n == 0:
            self.by_owner = {}
            self.patch = []
            return np.empty((0,), np.int64), old_patch, 0
        owner = self.owner.view()
        live = self.stamp.view()[:, 0] != NO_STAMP
        ow = np.where(owner < owner_map.size, owner_map[owner], -1)
        live &= ow >= 0
        row_map = np.where(live, np.cumsum(live) - 1, -1).astype(np.int64)
        keep_l = np.nonzero(live)[0].tolist()
        drop_l = np.nonzero(~live)[0].tolist()
        keep = np.asarray(keep_l, np.int64)
        self.owner.reset_to(ow[keep].astype(np.int32))
        self.key.reset_to(self.key.view()[keep])
        self.val.reset_to(self.val.view()[keep])
        self.num.reset_to(self.num.view()[keep])
        self.stamp.reset_to(self.stamp.view()[keep])
        self.stamp_obj = [self.stamp_obj[i] for i in keep_l]
        for i in drop_l:
            if self.ver[i] is not None:
                self.ver[i].slot = -1
        self.ver = [self.ver[i] for i in keep_l]
        for new_row, ver in enumerate(self.ver):
            if ver is not None:
                ver.slot = new_row
        self.by_owner = {}
        for new_row, o in enumerate(self.owner.view().tolist()):
            self.by_owner.setdefault(o, []).append(new_row)
        self.patch = []
        return row_map, old_patch, n


@dataclass
class CompactionEvent:
    """One compaction, as seen by a snapshot cache.

    ``v_map`` / ``e_map`` translate pre-compaction slots to
    post-compaction slots (-1 = dropped); ``old_v_patch`` /
    ``old_e_patch`` are the FULL pre-compaction patch logs (old
    numbering) so a consumer that had only read a prefix can recover the
    unread tail; ``old_n_v`` / ``old_n_e`` are the pre-compaction table
    sizes.  ``vp_map`` / ``ep_map`` (and the matching ``old_*p_patch`` /
    ``old_n_*p`` fields) are the same contract for the vertex/edge
    PROPERTY tables, so crossing a compaction no longer forces a full
    property re-read."""

    v_map: np.ndarray
    e_map: np.ndarray
    old_v_patch: List[int]
    old_e_patch: List[int]
    old_n_v: int
    old_n_e: int
    vp_map: np.ndarray
    ep_map: np.ndarray
    old_vp_patch: List[int]
    old_ep_patch: List[int]
    old_n_vp: int
    old_n_ep: int


#: compact a partition's columns when this fraction of slots is purged
COMPACT_DEAD_FRAC = 0.25
#: ... but never bother below this many total slots
COMPACT_MIN_ROWS = 64
#: retained CompactionEvents (each holds O(n) maps); consumers that lag
#: further behind fall back to a cold rebuild
MAX_COMPACTION_EVENTS = 8


class PartitionColumns:
    """Struct-of-arrays mirror of one partition (see module docstring).

    Slots are stable between compactions: a vid (or (src, eid) edge key)
    keeps its slot across delete / GC / re-create; only its stamp rows
    are patched.  ``v_patch`` / ``e_patch`` log every in-place patch
    (appends are implied by the growth of ``n_v`` / ``n_e``); consumers
    track their own read offsets.  A compaction renumbers slots and
    resets the logs; consumers catch up through ``events`` (see
    :class:`CompactionEvent`).
    """

    def __init__(self, n_gk: int, intern: Optional[VidIntern] = None,
                 vals: Optional[PropIntern] = None) -> None:
        self.n_gk = n_gk
        self.c = n_gk + 1
        self.intern = intern if intern is not None else VidIntern()
        self._no_row = np.full((self.c,), NO_STAMP, np.int32)
        # vertex table
        self.v_gid = _GrowInts()
        self.v_create = _GrowRows(self.c)
        self.v_delete = _GrowRows(self.c)
        self.v_create_stamp: List[Optional[Stamp]] = []
        self.v_delete_stamp: List[Optional[Stamp]] = []
        self.v_slot: Dict[int, int] = {}          # gid -> slot
        # edge table
        self.e_src = _GrowInts()
        self.e_dst = _GrowInts()
        self.e_eid = _GrowInts64()        # edge id (get_edges replies)
        self.e_create = _GrowRows(self.c)
        self.e_delete = _GrowRows(self.c)
        self.e_create_stamp: List[Optional[Stamp]] = []
        self.e_delete_stamp: List[Optional[Stamp]] = []
        self.e_slot: Dict[Tuple[int, int], int] = {}  # (src gid, eid) -> slot
        # property version columns.  Keys are always interned
        # per-partition; VALUES may share one deployment-wide table
        # (Weaver passes it) so ragged replies can ship value IDS and
        # let the client decode — per-partition ids would be meaningless
        # off-shard and force eager value decode at the shard.
        self.keys = PropIntern()
        self.vals = vals if vals is not None else PropIntern()
        self.vals_shared = vals is not None
        self.v_props = _PropTable(self.c)
        self.e_props = _PropTable(self.c)
        # change log
        self.version = 0
        self.v_patch: List[int] = []
        self.e_patch: List[int] = []
        # compaction history (consumers remap through these); event
        # numbering is absolute: total events ever = events_dropped +
        # len(events), a consumer behind events_dropped must cold-rebuild
        self.events: List[CompactionEvent] = []
        self.events_dropped = 0
        self.n_compactions = 0
        # open group-commit buffer (see begin_batch)
        self._batch: Optional[dict] = None

    @property
    def n_v(self) -> int:
        return self.v_gid.n

    @property
    def n_e(self) -> int:
        return self.e_src.n

    def cursor(self) -> List[int]:
        """Consume cursor ``[n_v, n_e, len(v_patch), len(e_patch),
        total_compaction_events]`` — the delta-refresh contract shared by
        :class:`~repro_torch.core.analytics.SnapshotEngine` and
        :class:`~repro_torch.core.frontier.ShardPlan`.  A consumer whose stored
        event count falls behind ``events_dropped`` has lost remap
        history and must rebuild cold."""
        return [self.n_v, self.n_e, len(self.v_patch), len(self.e_patch),
                self.events_dropped + len(self.events)]

    # ---- group-commit bulk apply -----------------------------------------
    # Between begin_batch and end_batch, new-slot appends buffer in
    # Python lists (slots numbered eagerly so same-batch deletes/purges
    # resolve against the buffer) and in-place patch-log entries buffer
    # too; end_batch flushes ONE matrix extend per column and ONE
    # patch-log extend per table — a whole WriteBatch costs one append
    # instead of one per op.  Consumers never see the open buffer: the
    # shard applies a batch atomically within one simulator event.

    def begin_batch(self) -> None:
        assert self._batch is None, "nested column batch"
        self._batch = {
            "v_base": self.n_v, "e_base": self.n_e,
            "v_gid": [], "v_create": [], "v_delete": [],
            "e_src": [], "e_dst": [], "e_eid": [],
            "e_create": [], "e_delete": [],
            "v_patch": [], "e_patch": [],
        }
        self.v_props.begin_batch()
        self.e_props.begin_batch()

    def end_batch(self) -> None:
        b = self._batch
        self._batch = None
        if b["v_gid"]:
            self.v_gid.extend(np.asarray(b["v_gid"], np.int32))
            self.v_create.extend(np.stack(b["v_create"]))
            self.v_delete.extend(np.stack(b["v_delete"]))
        if b["e_src"]:
            self.e_src.extend(np.asarray(b["e_src"], np.int32))
            self.e_dst.extend(np.asarray(b["e_dst"], np.int32))
            self.e_eid.extend(np.asarray(b["e_eid"], np.int64))
            self.e_create.extend(np.stack(b["e_create"]))
            self.e_delete.extend(np.stack(b["e_delete"]))
        if b["v_patch"]:
            self.v_patch.extend(b["v_patch"])
        if b["e_patch"]:
            self.e_patch.extend(b["e_patch"])
        self.v_props.end_batch()
        self.e_props.end_batch()
        self.version += 1

    def _set_row(self, mat: _GrowRows, pend_key: str, base_key: str,
                 slot: int, row: np.ndarray) -> None:
        """In-place stamp write that lands in the batch buffer when the
        slot is still buffered."""
        b = self._batch
        if b is not None and slot >= b[base_key]:
            b[pend_key][slot - b[base_key]] = row
        else:
            mat.set(slot, row)

    def _log_patch(self, patch_key: str, slot: int) -> None:
        b = self._batch
        if b is not None:
            b[patch_key].append(slot)
        elif patch_key == "v_patch":
            self.v_patch.append(slot)
        else:
            self.e_patch.append(slot)

    # ---- vertex events ---------------------------------------------------
    def vertex_created(self, vid: str, ts: Stamp) -> None:
        gid = self.intern.intern(vid)
        slot = self.v_slot.get(gid)
        row = pack(ts, self.n_gk)
        b = self._batch
        if slot is None:
            if b is None:
                self.v_slot[gid] = self.v_gid.append(gid)
                self.v_create.append(row)
                self.v_delete.append(self._no_row)
            else:
                self.v_slot[gid] = b["v_base"] + len(b["v_gid"])
                b["v_gid"].append(gid)
                b["v_create"].append(row)
                b["v_delete"].append(self._no_row)
            self.v_create_stamp.append(ts)
            self.v_delete_stamp.append(None)
        else:  # re-create after delete (slot reuse keeps ordering stable)
            self._set_row(self.v_create, "v_create", "v_base", slot, row)
            self._set_row(self.v_delete, "v_delete", "v_base", slot,
                          self._no_row)
            self.v_create_stamp[slot] = ts
            self.v_delete_stamp[slot] = None
            self._log_patch("v_patch", slot)
            # the dict path replaces the MVVertex, dropping its property
            # history — mirror that (old versions must not resurface)
            self.v_props.purge_owner(slot)
        self.version += 1

    def vertex_deleted(self, vid: str, ts: Stamp) -> None:
        slot = self.v_slot[self.intern.intern(vid)]
        self._set_row(self.v_delete, "v_delete", "v_base", slot,
                      pack(ts, self.n_gk))
        self.v_delete_stamp[slot] = ts
        self._log_patch("v_patch", slot)
        self.version += 1

    def vertex_purged(self, vid: str) -> None:
        """GC: the slot can never be visible again (all-NO_STAMP rows)."""
        slot = self.v_slot[self.intern.intern(vid)]
        self._set_row(self.v_create, "v_create", "v_base", slot,
                      self._no_row)
        self._set_row(self.v_delete, "v_delete", "v_base", slot,
                      self._no_row)
        self.v_create_stamp[slot] = None
        self.v_delete_stamp[slot] = None
        self._log_patch("v_patch", slot)
        self.v_props.purge_owner(slot)
        self.version += 1

    # ---- edge events -----------------------------------------------------
    def edge_created(self, src: str, dst: str, eid: int, ts: Stamp) -> None:
        sg = self.intern.intern(src)
        dg = self.intern.intern(dst)
        key = (sg, eid)
        slot = self.e_slot.get(key)
        row = pack(ts, self.n_gk)
        b = self._batch
        if slot is None:
            if b is None:
                self.e_slot[key] = self.e_src.append(sg)
                self.e_dst.append(dg)
                self.e_eid.append(eid)
                self.e_create.append(row)
                self.e_delete.append(self._no_row)
            else:
                self.e_slot[key] = b["e_base"] + len(b["e_src"])
                b["e_src"].append(sg)
                b["e_dst"].append(dg)
                b["e_eid"].append(eid)
                b["e_create"].append(row)
                b["e_delete"].append(self._no_row)
            self.e_create_stamp.append(ts)
            self.e_delete_stamp.append(None)
        else:
            self._set_row(self.e_create, "e_create", "e_base", slot, row)
            self._set_row(self.e_delete, "e_delete", "e_base", slot,
                          self._no_row)
            self.e_create_stamp[slot] = ts
            self.e_delete_stamp[slot] = None
            self._log_patch("e_patch", slot)
            self.e_props.purge_owner(slot)   # dict path drops old versions
        self.version += 1

    def edge_deleted(self, src: str, eid: int, ts: Stamp) -> None:
        slot = self.e_slot[(self.intern.intern(src), eid)]
        self._set_row(self.e_delete, "e_delete", "e_base", slot,
                      pack(ts, self.n_gk))
        self.e_delete_stamp[slot] = ts
        self._log_patch("e_patch", slot)
        self.version += 1

    def edge_purged(self, src: str, eid: int) -> None:
        slot = self.e_slot[(self.intern.intern(src), eid)]
        self._set_row(self.e_create, "e_create", "e_base", slot,
                      self._no_row)
        self._set_row(self.e_delete, "e_delete", "e_base", slot,
                      self._no_row)
        self.e_create_stamp[slot] = None
        self.e_delete_stamp[slot] = None
        self._log_patch("e_patch", slot)
        self.e_props.purge_owner(slot)
        self.version += 1

    # ---- property events -------------------------------------------------
    def vertex_prop_set(self, vid: str, key: str, value, ts: Stamp,
                        ver: Optional[Versioned] = None) -> int:
        slot = self.v_slot[self.intern.intern(vid)]
        row = self.v_props.append(slot, self.keys.intern(key),
                                  self.vals.intern(value), value,
                                  pack(ts, self.n_gk), ts, ver)
        self.version += 1
        return row

    def edge_prop_set(self, src: str, eid: int, key: str, value, ts: Stamp,
                      ver: Optional[Versioned] = None) -> int:
        slot = self.e_slot[(self.intern.intern(src), eid)]
        row = self.e_props.append(slot, self.keys.intern(key),
                                  self.vals.intern(value), value,
                                  pack(ts, self.n_gk), ts, ver)
        self.version += 1
        return row

    def vertex_prop_purged(self, row: int) -> None:
        self.v_props.purge(row)
        self.version += 1

    def edge_prop_purged(self, row: int) -> None:
        self.e_props.purge(row)
        self.version += 1

    # ---- GC compaction ---------------------------------------------------
    def dead_fraction(self) -> float:
        n = self.n_v + self.n_e
        if n == 0:
            return 0.0
        dead = int((self.v_create.view()[:, 0] == NO_STAMP).sum()) \
            + int((self.e_create.view()[:, 0] == NO_STAMP).sum())
        return dead / n

    def maybe_compact(self, dead_frac: float = COMPACT_DEAD_FRAC,
                      min_rows: int = COMPACT_MIN_ROWS) -> bool:
        if self.n_v + self.n_e < min_rows \
                or self.dead_fraction() <= dead_frac:
            return False
        self.compact()
        return True

    def compact(self) -> None:
        """Drop every purged (all-``NO_STAMP``) slot and renumber.

        Row order is preserved, so snapshot compaction ordering is
        unaffected; the old→new maps plus the pre-compaction patch logs
        are appended to ``events`` for cache remapping."""
        assert self._batch is None, "compaction inside an open batch"
        v_live = self.v_create.view()[:, 0] != NO_STAMP
        e_live = self.e_create.view()[:, 0] != NO_STAMP
        v_map = np.where(v_live, np.cumsum(v_live) - 1, -1).astype(np.int64)
        e_map = np.where(e_live, np.cumsum(e_live) - 1, -1).astype(np.int64)
        old_v_patch, old_e_patch = self.v_patch, self.e_patch
        old_n_v, old_n_e = self.n_v, self.n_e
        # property tables follow their owners (compact first: the event
        # carries their row maps alongside the owner-table maps)
        vp_map, old_vp_patch, old_n_vp = self.v_props.compact(v_map)
        ep_map, old_ep_patch, old_n_ep = self.e_props.compact(e_map)
        self.events.append(CompactionEvent(
            v_map=v_map, e_map=e_map,
            old_v_patch=old_v_patch, old_e_patch=old_e_patch,
            old_n_v=old_n_v, old_n_e=old_n_e,
            vp_map=vp_map, ep_map=ep_map,
            old_vp_patch=old_vp_patch, old_ep_patch=old_ep_patch,
            old_n_vp=old_n_vp, old_n_ep=old_n_ep))
        while len(self.events) > MAX_COMPACTION_EVENTS:
            self.events.pop(0)
            self.events_dropped += 1
        vk = np.nonzero(v_live)[0]
        ek = np.nonzero(e_live)[0]
        # vertex table
        self.v_gid.reset_to(self.v_gid.view()[vk])
        self.v_create.reset_to(self.v_create.view()[vk])
        self.v_delete.reset_to(self.v_delete.view()[vk])
        vk_l = vk.tolist()
        self.v_create_stamp = [self.v_create_stamp[i] for i in vk_l]
        self.v_delete_stamp = [self.v_delete_stamp[i] for i in vk_l]
        self.v_slot = {g: int(v_map[s]) for g, s in self.v_slot.items()
                       if v_map[s] >= 0}
        # edge table
        self.e_src.reset_to(self.e_src.view()[ek])
        self.e_dst.reset_to(self.e_dst.view()[ek])
        self.e_eid.reset_to(self.e_eid.view()[ek])
        self.e_create.reset_to(self.e_create.view()[ek])
        self.e_delete.reset_to(self.e_delete.view()[ek])
        ek_l = ek.tolist()
        self.e_create_stamp = [self.e_create_stamp[i] for i in ek_l]
        self.e_delete_stamp = [self.e_delete_stamp[i] for i in ek_l]
        self.e_slot = {k: int(e_map[s]) for k, s in self.e_slot.items()
                       if e_map[s] >= 0}
        self.v_patch = []
        self.e_patch = []
        self.n_compactions += 1
        self.version += 1


class MVGraphPartition:
    """One shard's partition of the multi-version graph."""

    def __init__(self, n_gk: Optional[int] = None,
                 intern: Optional[VidIntern] = None,
                 prop_vals: Optional[PropIntern] = None) -> None:
        self.vertices: Dict[str, MVVertex] = {}
        self._eid = 0
        self._n_gk = n_gk
        self._intern = intern
        self._prop_vals = prop_vals
        self.columns: Optional[PartitionColumns] = None
        if n_gk is not None:
            self.columns = PartitionColumns(n_gk, intern, vals=prop_vals)

    def _cols(self, ts: Stamp) -> PartitionColumns:
        """Column mirror, created lazily when G is first observable."""
        if self.columns is None:
            self.columns = PartitionColumns(len(ts.clock), self._intern,
                                            vals=self._prop_vals)
        return self.columns

    # ---- write path (called by shard at a transaction's stamp) ----------
    def create_vertex(self, vid: str, ts: Stamp) -> MVVertex:
        v = self.vertices.get(vid)
        if v is not None and v.delete_ts is None:
            # re-create of live vertex: id reuse is an application error
            raise KeyError(f"vertex {vid} already exists")
        v = MVVertex(vid, create_ts=ts)
        self.vertices[vid] = v
        self._cols(ts).vertex_created(vid, ts)
        return v

    def delete_vertex(self, vid: str, ts: Stamp) -> None:
        v = self.vertices[vid]
        v.delete_ts = ts
        cols = self._cols(ts)
        cols.vertex_deleted(vid, ts)
        for e in v.out_edges.values():
            if e.delete_ts is None:
                e.delete_ts = ts
                cols.edge_deleted(vid, e.eid, ts)

    def create_edge(self, src: str, dst: str, ts: Stamp,
                    eid: Optional[int] = None) -> MVEdge:
        v = self.vertices[src]
        if eid is None:
            self._eid += 1
            eid = self._eid
        e = MVEdge(eid, src, dst, create_ts=ts)
        v.out_edges[eid] = e
        self._cols(ts).edge_created(src, dst, eid, ts)
        return e

    def delete_edge(self, src: str, eid: int, ts: Stamp) -> None:
        e = self.vertices[src].out_edges[eid]
        e.delete_ts = ts
        self._cols(ts).edge_deleted(src, eid, ts)

    def set_vertex_prop(self, vid: str, key: str, value, ts: Stamp) -> None:
        ver = Versioned(value, ts)
        self.vertices[vid].props.setdefault(key, []).append(ver)
        ver.slot = self._cols(ts).vertex_prop_set(vid, key, value, ts, ver)

    def set_edge_prop(self, src: str, eid: int, key: str, value, ts: Stamp) -> None:
        ver = Versioned(value, ts)
        self.vertices[src].out_edges[eid].props.setdefault(key, []).append(ver)
        ver.slot = self._cols(ts).edge_prop_set(src, eid, key, value, ts, ver)

    # ---- op-dict dispatch (shard replica apply) ---------------------------
    def apply_op(self, op: dict, ts: Stamp) -> None:
        """Apply one forwarded (store-validated) write op at its stamp."""
        k = op["op"]
        if k == "create_vertex":
            self.create_vertex(op["vid"], ts)
        elif k == "delete_vertex":
            self.delete_vertex(op["vid"], ts)
        elif k == "create_edge":
            self.create_edge(op["src"], op["dst"], ts, eid=op.get("eid"))
        elif k == "delete_edge":
            self.delete_edge(op["src"], op["eid"], ts)
        elif k == "set_vertex_prop":
            self.set_vertex_prop(op["vid"], op["key"], op["value"], ts)
        elif k == "set_edge_prop":
            self.set_edge_prop(op["src"], op["eid"], op["key"],
                               op["value"], ts)

    def apply_batch(self, items: List[Tuple[Stamp, List[dict]]]) -> int:
        """Apply a whole group-committed :class:`WriteBatch` payload —
        ``[(stamp, ops), ...]`` in commit-stamp order — flushing the
        column mirror ONCE (one stamp-matrix append + one patch-log
        extend per table instead of one per op, see
        :meth:`PartitionColumns.begin_batch`).  Returns the op count."""
        if not items:
            return 0
        n = 0
        cols = self._cols(items[0][0])
        cols.begin_batch()
        try:
            for ts, ops in items:
                for op in ops:
                    self.apply_op(op, ts)
                    n += 1
        finally:
            cols.end_batch()
        return n

    # ---- snapshot read path (node programs at T_prog) --------------------
    def vertex_at(self, vid: str, at: Stamp, refine=None) -> Optional[MVVertex]:
        v = self.vertices.get(vid)
        if v is None or not visible(v.create_ts, v.delete_ts, at, refine):
            return None
        return v

    def out_edges_at(self, vid: str, at: Stamp, refine=None) -> List[MVEdge]:
        v = self.vertex_at(vid, at, refine)
        if v is None:
            return []
        return [e for e in v.out_edges.values()
                if visible(e.create_ts, e.delete_ts, at, refine)]

    def prop_at(self, versions: List[Versioned], at: Stamp, refine=None):
        """Latest property version visible at ``at``."""
        best: Optional[Versioned] = None
        for ver in versions:
            if _before(ver.ts, at, refine):
                if best is None or _before(best.ts, ver.ts, refine):
                    best = ver
        return None if best is None else best.value

    def vertex_prop_at(self, vid: str, key: str, at: Stamp, refine=None):
        v = self.vertex_at(vid, at, refine)
        if v is None or key not in v.props:
            return None
        return self.prop_at(v.props[key], at, refine)

    def edge_prop_at(self, e: MVEdge, key: str, at: Stamp, refine=None):
        if key not in e.props:
            return None
        return self.prop_at(e.props[key], at, refine)

    # ---- GC (paper §4.5) --------------------------------------------------
    def collect(self, horizon: Stamp) -> int:
        """Drop versions deleted strictly before ``horizon``."""
        n = 0
        cols = self.columns
        dead_v = []
        for vid, v in self.vertices.items():
            if v.delete_ts is not None and compare(v.delete_ts, horizon) is Order.BEFORE:
                dead_v.append(vid)
                n += 1
                continue
            dead_e = [eid for eid, e in v.out_edges.items()
                      if e.delete_ts is not None
                      and compare(e.delete_ts, horizon) is Order.BEFORE]
            for eid in dead_e:
                del v.out_edges[eid]
                if cols is not None:
                    cols.edge_purged(vid, eid)
                n += 1
            for key, versions in list(v.props.items()):
                if len(versions) > 1:
                    keep = [ver for i, ver in enumerate(versions)
                            if i == len(versions) - 1
                            or not compare(versions[i + 1].ts, horizon) is Order.BEFORE]
                    if cols is not None:
                        kept = set(map(id, keep))
                        for ver in versions:
                            if id(ver) not in kept:
                                cols.vertex_prop_purged(ver.slot)
                    n += len(versions) - len(keep)
                    v.props[key] = keep
        for vid in dead_v:
            if cols is not None:
                # edge/vertex purge also purges their property rows
                for eid in self.vertices[vid].out_edges:
                    cols.edge_purged(vid, eid)
                cols.vertex_purged(vid)
            del self.vertices[vid]
        if cols is not None:
            cols.maybe_compact()
        return n

    # ---- stats ------------------------------------------------------------
    def n_live(self) -> Tuple[int, int]:
        nv = sum(1 for v in self.vertices.values() if v.delete_ts is None)
        ne = sum(sum(1 for e in v.out_edges.values() if e.delete_ts is None)
                 for v in self.vertices.values())
        return nv, ne
