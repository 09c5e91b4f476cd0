"""Frontier-batched node-program runtime on the columnar data plane.

The per-vertex path (``nodeprog.run_entries_scalar``) interprets one
Python callback per delivered vertex against the multi-version dicts.
This module executes a whole per-shard *frontier* in one vectorized step
against the stamped columns the partition already maintains
(:class:`~repro_torch.core.mvgraph.PartitionColumns`):

* :class:`ShardPlan` — a per-shard sorted-CSR snapshot *slice* at the
  program stamp ``T_prog``: one batched visibility pass over the packed
  stamp matrices (the same `mv_visibility` contract the global snapshot
  engine uses, truly-concurrent stamps refined through the shard's
  timeline-oracle cache in ONE request), the visible out-edges sorted by
  ``(src gid, dst gid)``, and lazily-materialized latest-visible
  property columns per key (edge filters, weights, vertex values).
  Plans survive write traffic: instead of rebuilding whenever
  ``PartitionColumns.version`` bumps, :meth:`ShardPlan.refresh`
  delta-consumes the partition's patch logs and
  :class:`~repro_torch.core.mvgraph.CompactionEvent` remaps — the same
  O(changed) contract the global ``SnapshotEngine`` has — re-evaluating
  only changed and unsettled stamps (at most one incremental oracle
  round trip) and splicing the sorted-CSR slice in place.  A cold
  rebuild happens only on first contact, when the compaction-event
  history no longer covers the plan's cursor, or when the new query
  stamp does not dominate the plan stamp.
* :class:`Frontier` — the packed exchange unit: a gid array plus
  optional per-entry float (``vals``, e.g. sssp distances) and int
  (``tags``) payload columns, an optional :class:`Ragged` side table
  (per-entry variable-length payloads, e.g. the clustering protocol's
  packed neighbour lists), and a shared ``meta`` dict.  Shards exchange
  ONE such message per destination shard per hop instead of one
  ``(dst, params)`` tuple per emitted vertex.
* :class:`Ragged` / :class:`RaggedReply` — segment-offset ragged
  columns for neighbourhood-returning queries: ``Ragged`` rides inside
  a frontier (wire side), ``RaggedReply`` is the *output* payload kind
  (``get_edges`` returns every delivered entry's full edge list —
  eids, endpoints, optional property columns — from one batched gather
  over the plan's sorted-CSR slice).
* :func:`execute_step` — runs a program's registered ``frontier_step``
  (see ``nodeprog.frontier_impl``) over one plan + frontier, returning
  the batch outputs, the global next frontier and the charged service
  time.  Per-destination neighbour aggregation goes through
  ``repro_torch.kernels.segment_mp.ops.segment_reduce_sorted`` — the
  CSR-sorted plan makes the sorted-segment contract free.

The plan/fallback contract: a program participates iff it registered a
``frontier_step`` AND ``frontier_ok(params)`` accepts the root
parameters (e.g. an unhashable edge-filter constant forces the scalar
path).  The decision is a pure function of ``(name, root params)``, so
every shard of one query independently agrees; follow-up hops carry
:class:`Frontier` objects, which imply the batched path.  Results are
identical to the scalar path at the same stamp (randomized equivalence
is enforced by ``tests/test_frontier_prog.py``); the only caveat is
``sssp`` under a *binding* ``max_depth``, where the scalar path itself
is delivery-order dependent.

:func:`run_local` drives a whole program synchronously outside the
simulator (equivalence tests, wall-clock benchmarks).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from . import clock
from .clock import NO_STAMP, Order, Stamp, compare


@dataclass
class Ragged:
    """Segment-offset ragged columns: R rows of variable length packed as
    CSR-style ``(offsets, values)``.

    The exchange unit for *per-entry variable-length* payloads (the
    structural gap between OLTP-style point replies and analytics-style
    neighbourhood-returning queries): ``offsets`` has shape ``(R+1,)``
    and row ``i`` is ``values[offsets[i]:offsets[i+1]]``.  ``keys`` is an
    optional per-ROW int64 column (e.g. the origin gid of each packed
    neighbour list) and ``extra`` holds named per-POSITION int64 columns
    aligned with ``values``.  A :class:`Frontier` carrying a ``Ragged``
    uses its ``tags`` as row indices into it (see ``Frontier``)."""

    offsets: np.ndarray                    # (R+1,) int64 row bounds
    values: np.ndarray                     # (T,) int64, T = offsets[-1]
    keys: Optional[np.ndarray] = None      # (R,) int64 per-row key
    extra: Dict[str, np.ndarray] = field(default_factory=dict)

    def __len__(self) -> int:              # number of rows
        return int(self.offsets.size - 1)

    def lens(self) -> np.ndarray:
        return self.offsets[1:] - self.offsets[:-1]

    def nbytes(self) -> int:
        n = 8 * (self.offsets.size + self.values.size)
        if self.keys is not None:
            n += 8 * self.keys.size
        for col in self.extra.values():
            n += 8 * col.size
        return n

    def take(self, rows: np.ndarray) -> "Ragged":
        """Row subset (new compact numbering) — used to pack ONE message
        per destination shard with only the rows its entries reference."""
        rows = np.asarray(rows, np.int64)
        ln = self.lens()[rows]
        off = np.concatenate([np.zeros(1, np.int64), np.cumsum(ln)])
        total = int(off[-1])
        if total:
            pos = (np.arange(total, dtype=np.int64)
                   - np.repeat(off[:-1], ln) + np.repeat(self.offsets[rows], ln))
        else:
            pos = np.zeros(0, np.int64)
        return Ragged(
            offsets=off, values=self.values[pos],
            keys=None if self.keys is None else self.keys[rows],
            extra={k: v[pos] for k, v in self.extra.items()})

    @staticmethod
    def concat(parts: List["Ragged"]) -> "Ragged":
        """Row-wise concatenation (coalesced deliveries); a consumer's
        ``tags`` into part ``i`` must be rebased by the row offset
        ``sum(len(parts[:i]))`` — :func:`_merge_frontiers` does."""
        if len(parts) == 1:
            return parts[0]
        totals = [int(p.offsets[-1]) for p in parts]
        starts = [0] + list(np.cumsum(totals[:-1]))
        offsets = np.concatenate(
            [p.offsets[:-1] + s for p, s in zip(parts, starts)]
            + [np.asarray([sum(totals)], np.int64)]).astype(np.int64)
        keys = (None if parts[0].keys is None
                else np.concatenate([p.keys for p in parts]))
        extra = {k: np.concatenate([p.extra[k] for p in parts])
                 for k in parts[0].extra}
        return Ragged(offsets=offsets,
                      values=np.concatenate([p.values for p in parts]),
                      keys=keys, extra=extra)


def ragged_offsets(lens: np.ndarray) -> np.ndarray:
    """(R+1,) segment offsets from per-row lengths."""
    return np.concatenate([np.zeros(1, np.int64),
                           np.cumsum(np.asarray(lens, np.int64))])


def blank_ragged_rows(rg: Ragged, mask: np.ndarray) -> Ragged:
    """Ship rows the receiver already caches as zero-length MARKERS:
    keys stay (the receiver reconstitutes by key), values and aligned
    ``extra`` positions drop — the wire dedup for per-row side tables
    (clustering phase 1 ships each origin's packed neighbour list once
    per destination shard).  ``mask`` is a per-row boolean: True rows
    are blanked."""
    keep = ~np.asarray(mask, bool)
    ln = rg.lens() * keep
    off = ragged_offsets(ln)
    total = int(off[-1])
    if total:
        pos = (np.arange(total, dtype=np.int64)
               - np.repeat(off[:-1], ln) + np.repeat(rg.offsets[:-1], ln))
    else:
        pos = np.zeros(0, np.int64)
    return Ragged(offsets=off, values=rg.values[pos], keys=rg.keys,
                  extra={k: v[pos] for k, v in rg.extra.items()})


def fill_ragged_rows(rg: Ragged, lookup: dict) -> Tuple[Ragged, int]:
    """Receiver-side inverse of :func:`blank_ragged_rows`: zero-length
    rows whose key is in ``lookup`` (key -> ``(values, extra_dict)``)
    get their packed payload re-inserted.  Returns the filled ragged
    and the number of reconstituted rows (0 leaves ``rg`` untouched —
    legitimately empty keyed rows without a cache entry pass through)."""
    if rg.keys is None or len(rg) == 0:
        return rg, 0
    ln = rg.lens()
    fills = {}
    for i in np.nonzero(ln == 0)[0].tolist():
        hit = lookup.get(int(rg.keys[i]))
        if hit is not None:
            fills[i] = hit
    if not fills:
        return rg, 0
    vals: List[np.ndarray] = []
    extras: Dict[str, List[np.ndarray]] = {k: [] for k in rg.extra}
    new_ln = ln.copy()
    for i in range(len(rg)):
        hit = fills.get(i)
        if hit is not None:
            v, ex = hit
            vals.append(v)
            new_ln[i] = v.size
            for k in extras:
                extras[k].append(ex[k])
        else:
            sl = slice(int(rg.offsets[i]), int(rg.offsets[i + 1]))
            vals.append(rg.values[sl])
            for k in extras:
                extras[k].append(rg.extra[k][sl])
    filled = Ragged(
        offsets=ragged_offsets(new_ln),
        values=(np.concatenate(vals).astype(np.int64) if vals
                else np.zeros(0, np.int64)),
        keys=rg.keys,
        extra={k: (np.concatenate(v).astype(np.int64) if v
                   else np.zeros(0, np.int64))
               for k, v in extras.items()})
    return filled, len(fills)


class RaggedReply:
    """Ragged per-entry program OUTPUT: every delivered entry's full edge
    list (ids + endpoints + optional property columns) from ONE batched
    gather over the shard plan's sorted-CSR slice.

    This is the reply-side payload *kind* (``kind == "ragged"``): the
    scalar path ships one Python list per visited entry, the batched path
    ships one of these per ``frontier_step`` — the coordinator (or
    ``reduce``) decodes rows lazily via :meth:`lists`.  Gid→vid decoding
    goes through the deployment-wide :class:`~repro_torch.core.mvgraph.
    VidIntern` (shared by construction, so the reference costs nothing on
    the simulated wire); ``nbytes`` models the packed columns."""

    kind = "ragged"

    __slots__ = ("intern", "roots", "offsets", "eids", "dsts", "props",
                 "vals")

    def __init__(self, intern, roots: np.ndarray, offsets: np.ndarray,
                 eids: np.ndarray, dsts: np.ndarray,
                 props: Optional[Dict[str, list]] = None,
                 vals=None):
        self.intern = intern
        self.roots = roots                 # (R,) int64 root gids
        self.offsets = offsets             # (R+1,) int64
        self.eids = eids                   # (T,) edge ids
        self.dsts = dsts                   # (T,) int64 dst gids
        self.props = props                 # key -> (T,)-aligned value list,
        #                                    OR (T,) int64 value-id columns
        #                                    when ``vals`` is set
        # deployment-wide PropIntern value table (shared by construction,
        # like ``intern``): when present, property columns stay packed
        # value IDS end to end and rows decode lazily in lists()
        self.vals = vals

    def __len__(self) -> int:
        return int(self.roots.size)

    def total(self) -> int:
        return int(self.eids.size)

    def nbytes(self) -> int:
        n = 64 + 8 * (self.roots.size + self.offsets.size
                      + self.eids.size + self.dsts.size)
        if self.props:
            n += 8 * self.total() * len(self.props)
        return n

    def lists(self) -> List[list]:
        """Decode to the scalar path's per-entry form: one
        ``[(eid, dst_vid), ...]`` list per root (plus a per-edge property
        dict when property columns were requested)."""
        vids = self.intern.vids
        eids = self.eids.tolist()
        dsts = self.dsts.tolist()
        props = self.props
        if props is not None and self.vals is not None:
            table = self.vals.vals
            props = {k: [table[i] if i >= 0 else None
                         for i in np.asarray(col).tolist()]
                     for k, col in props.items()}
        out: List[list] = []
        for i in range(len(self)):
            lo, hi = int(self.offsets[i]), int(self.offsets[i + 1])
            if props is None:
                out.append([(eids[p], vids[dsts[p]]) for p in range(lo, hi)])
            else:
                out.append([(eids[p], vids[dsts[p]],
                             {k: col[p] for k, col in props.items()})
                            for p in range(lo, hi)])
        return out


def reply_nbytes(outputs: List[object]) -> int:
    """Simulated wire size of a report's output payload: ragged replies
    model their packed columns, everything else the legacy 32B/output."""
    n = 0
    for o in outputs:
        n += o.nbytes() if isinstance(o, RaggedReply) else 32
    return n


@dataclass
class Frontier:
    """Packed per-hop delivery: one message per destination shard.

    ``tags`` is an optional per-entry int64 column; when ``ragged`` is
    present, tags are ROW INDICES into it (the clustering protocol ships
    each origin's packed neighbour list once per destination shard and
    tags every (neighbour, origin) entry with its origin's row), and
    routing/coalescing re-base them when rows are subset or
    concatenated.  Without ``ragged``, tags are a plain integer payload
    (e.g. per-origin reply counts on the wedge-closing return hop)."""

    gids: np.ndarray                       # (F,) int64 vertex intern ids
    vals: Optional[np.ndarray] = None      # (F,) float64 payload (sssp dist)
    depth: int = 0                         # hop depth (shared)
    meta: dict = field(default_factory=dict)   # shared params
    tags: Optional[np.ndarray] = None      # (F,) int64 payload / ragged rows
    ragged: Optional[Ragged] = None        # shared ragged side table

    def __len__(self) -> int:
        return int(self.gids.size)

    def nbytes(self) -> int:
        """Simulated wire size: packed arrays, not per-entry tuples."""
        n = 64 + 8 * self.gids.size
        if self.vals is not None:
            n += 8 * self.vals.size
        if self.tags is not None:
            n += 8 * self.tags.size
        if self.ragged is not None:
            n += self.ragged.nbytes()
        return n


def _before_rows(rows: np.ndarray, q: np.ndarray,
                 device: str) -> np.ndarray:
    """rows ≺ q through the snapshot engine's kernel route on ``device``."""
    from . import analytics
    return analytics._before_batch(rows, q, device)


def _edge_key(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Packed (src << 32 | dst) sort keys — the engine's convention."""
    from . import analytics
    return analytics._sort_key(src, dst)


def _remap_ids(smap: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Translate a sorted-unique slot-id set through a compaction map,
    dropping dead slots."""
    from . import analytics
    r = analytics.remap_slots(smap, ids)
    return np.unique(r[r >= 0])


def _merge_unsettled(old: np.ndarray, ids: np.ndarray,
                     mask: np.ndarray) -> np.ndarray:
    """Replace the membership of ``ids`` in the sorted-unique unsettled
    set ``old`` according to ``mask``."""
    return np.union1d(np.setdiff1d(old, ids, assume_unique=True), ids[mask])


class ShardPlan:
    """Sorted-CSR snapshot slice of ONE partition at one stamp.

    ``refine_batch(stamps) -> {stamp.key(): bool}`` resolves stamps that
    are truly concurrent with ``at`` (True = before the program); all
    concurrent stamps of a build — create/delete AND property versions —
    are queued and resolved in ONE such call, so a plan build (or delta
    refresh) costs at most one oracle round trip.

    Delta refresh contract
    ----------------------
    A plan records consume cursors into its partition's change feed
    (``PartitionColumns.cursor()`` + the per-``_PropTable`` cursors).
    :meth:`refresh` brings the plan up to date at O(changed) stamp work
    instead of an O(V+E) rebuild:

    * in-place stamp patches (delete / GC purge / re-create) are read
      from the ``v_patch`` / ``e_patch`` / prop ``patch`` tails;
    * appended rows extend the visibility arrays and the gid→slot map;
    * :class:`~repro_torch.core.mvgraph.CompactionEvent` entries remap every
      cached slot pointer (CSR ``eslot``, unsettled sets, visibility
      arrays) to the post-compaction numbering, recovering the unread
      pre-compaction patch tails; a consumer whose cursor lags the
      bounded event history returns False — the caller MUST then build a
      fresh plan (a stale *settled* plan is no longer trustworthy: the
      missed patches may have changed visibility at every stamp);
    * the stamp may advance (``plan.at ≼ at``): previously *unsettled*
      rows (present stamps not strictly vector-before the old stamp) are
      re-evaluated at the new stamp, everything settled is reused as-is;
    * changed rows' keep-decisions are spliced into the sorted CSR slice
      by ``np.delete`` / ``np.insert`` (O(changed) decisions + one
      memcpy), and cached property views are patched per affected owner.

    ``settled`` means NO unsettled rows remain anywhere (vertex, edge or
    property stamps) — visibility is then identical at every later
    stamp, and the shard may serve later query stamps from this plan
    without refreshing (point-read hot path).
    """

    def __init__(self, cols, at: Stamp, n_gk: int,
                 refine_batch: Optional[Callable] = None,
                 device_plane=None, device: str = "cuda"):
        self.at = at
        self.device = device
        self.version = cols.version
        self.cols = cols
        self.n_gk = n_gk
        self.q = clock.pack(at, n_gk)
        self._refine_batch = refine_batch
        self._plane = device_plane
        self._prop_cache: Dict[Tuple[str, str], tuple] = {}
        #: rows evaluated by this build (simulated-cost accounting)
        self.built_rows = (cols.n_v + cols.n_e
                           + cols.v_props.n + cols.e_props.n)
        #: rows re-evaluated by the latest :meth:`refresh`
        self.last_refresh_rows = 0
        # change-feed consume cursors (see class docstring)
        self._consumed = cols.cursor()
        self._p_consumed = {"v": cols.v_props.cursor(),
                            "e": cols.e_props.cursor()}

        nv, ne = cols.n_v, cols.n_e
        pend: List[tuple] = []
        # device-plane path: the create/delete stamp masks come from the
        # resident blocks (one launch, shared across every consumer of
        # the same query stamp); property stamps are not on the plane and
        # evaluate through _before_rows either way
        mk = None
        if device_plane is not None:
            device_plane.sync([cols])
            device_plane.before_all(self.q)
            mk = device_plane.masks_for(cols)
        vc, vd = cols.v_create.view(), cols.v_delete.view()
        cb = self._eval(vc, cols.v_create_stamp, pend,
                        pre=None if mk is None else mk[0])
        db = self._eval(vd, cols.v_delete_stamp, pend,
                        pre=None if mk is None else mk[1])
        ec, ed = cols.e_create.view(), cols.e_delete.view()
        ecb = self._eval(ec, cols.e_create_stamp, pend,
                         pre=None if mk is None else mk[2])
        edb = self._eval(ed, cols.e_delete_stamp, pend,
                         pre=None if mk is None else mk[3])
        # property stamps are evaluated eagerly (one bool per version
        # row) — the per-key views are derived lazily from these masks
        # with no further oracle traffic
        self._p_before = {
            t: self._eval(pt.stamp.view(), pt.stamp_obj, pend)
            for t, pt in (("v", cols.v_props), ("e", cols.e_props))}
        self._resolve(pend)

        self.v_visible = (cb & ~db) if nv else np.zeros(0, bool)
        self.e_vis = (ecb & ~edb) if ne else np.zeros(0, bool)

        # gid -> vertex slot (dense over the intern table seen so far)
        gids = cols.v_gid.view()
        self._slot_of = np.full(int(gids.max()) + 1 if nv else 1, -1,
                                np.int64)
        self._slot_of[gids] = np.arange(nv, dtype=np.int64)

        # visible out-edges of visible sources, sorted by (src, dst) gid
        if ne:
            src = cols.e_src.view().astype(np.int64)
            sslot = np.where(src < self._slot_of.size,
                             self._slot_of[np.minimum(src,
                                                      self._slot_of.size - 1)],
                             -1)
            keep = self.e_vis & (sslot >= 0)
            keep[keep] &= self.v_visible[sslot[keep]]
            self.e_keep = keep
            rows = np.nonzero(keep)[0]
            dst = cols.e_dst.view().astype(np.int64)[rows]
            key = _edge_key(src[rows], dst)
            order = np.argsort(key, kind="stable")
            self._ekey = key[order]
            self.esrc = src[rows][order]
            self.edst = dst[order]
            self.eslot = rows[order]          # edge slot per CSR position
        else:
            self.e_keep = np.zeros(0, bool)
            self._ekey = np.zeros(0, np.int64)
            self.esrc = np.zeros(0, np.int64)
            self.edst = np.zeros(0, np.int64)
            self.eslot = np.zeros(0, np.int64)

        self._uadj: Optional[tuple] = None   # lazy dedup'd adjacency

        # rows whose visibility can still change as the stamp advances
        self.v_unsettled = np.nonzero(self._unsett(vc, vd, cb, db))[0]
        self.e_unsettled = np.nonzero(self._unsett(ec, ed, ecb, edb))[0]
        self.p_unsettled = {}
        for t, pt in (("v", cols.v_props), ("e", cols.e_props)):
            rows = pt.stamp.view()
            pres = rows[:, 0] != NO_STAMP if pt.n else np.zeros(0, bool)
            self.p_unsettled[t] = np.nonzero(pres & ~self._p_before[t])[0]
        self._recheck_settled()

    # ------------------------------------------------------------ visibility
    @staticmethod
    def _unsett(create_rows, delete_rows, cb, db) -> np.ndarray:
        if create_rows.shape[0] == 0:
            return np.zeros(0, bool)
        return (((create_rows[:, 0] != NO_STAMP) & ~cb)
                | ((delete_rows[:, 0] != NO_STAMP) & ~db))

    def _recheck_settled(self) -> None:
        self.settled = not (self.v_unsettled.size or self.e_unsettled.size
                            or self.p_unsettled["v"].size
                            or self.p_unsettled["e"].size)

    def _eval(self, rows: np.ndarray, stamp_of, pend: List[tuple],
              ids: Optional[np.ndarray] = None,
              pre: Optional[np.ndarray] = None) -> np.ndarray:
        """rows ≺ q, queueing truly-concurrent stamps on ``pend`` for the
        single batched resolution.  ``ids`` maps local row positions back
        to table slots when ``rows`` is a gathered subset.  ``pre`` is a
        precomputed ≺-mask (the device plane's sharded launch) — bit-
        identical to the host evaluation, so only the concurrent-residue
        queueing runs here."""
        if rows.shape[0] == 0:
            return np.zeros(0, bool)
        out = (np.array(pre, dtype=bool) if pre is not None
               else _before_rows(rows, self.q, self.device))
        if self._refine_batch is not None:
            for li in np.nonzero(
                    clock.concurrent_mask_np(rows, self.q))[0].tolist():
                s = stamp_of[li if ids is None else int(ids[li])]
                if s is not None and compare(s, self.at) is Order.CONCURRENT:
                    pend.append((out, li, s))
        return out

    def _resolve(self, pend: List[tuple]) -> None:
        """ONE oracle round trip for every queued concurrent stamp."""
        if not pend:
            return
        got = self._refine_batch([s for _, _, s in pend])
        for arr, i, s in pend:
            arr[i] = bool(got[s.key()])

    # --------------------------------------------------------- delta refresh
    def _consume_compactions(self, ch_v: List[np.ndarray],
                             ch_e: List[np.ndarray],
                             ch_p: Dict[str, List[np.ndarray]]
                             ) -> Tuple[int, int, Dict[str, int]]:
        """Catch up with column compactions (cursor known to be covered
        by the event history).  Remaps every cached slot pointer —
        including the property-row masks, via the event's
        ``vp_map``/``ep_map`` — to the new numbering and recovers the
        unread pre-compaction patch tails into ``ch_v`` / ``ch_e`` /
        ``ch_p``.  Returns the consume cursors in post-compaction
        numbering (the dict maps ``"v"``/``"e"`` to the consumed
        property-row count)."""
        from . import analytics
        cols = self.cols
        nv0, ne0, lv0, le0, ev0 = self._consumed
        p_cur = {t: list(self._p_consumed[t]) for t in ("v", "e")}
        for ev in cols.events[ev0 - cols.events_dropped:]:
            ch_v.append(analytics.patch_tail(ev.old_v_patch, lv0, nv0))
            ch_e.append(analytics.patch_tail(ev.old_e_patch, le0, ne0))
            lv0 = le0 = 0
            v_kept = ev.v_map[:nv0] >= 0
            e_kept = ev.e_map[:ne0] >= 0
            self.v_visible = self.v_visible[v_kept]
            self.e_vis = self.e_vis[e_kept]
            self.e_keep = self.e_keep[e_kept]
            # property rows: same remap contract as the owner tables —
            # O(changed) across the compaction, no full re-read
            for t, pm, pp in (("v", ev.vp_map, ev.old_vp_patch),
                              ("e", ev.ep_map, ev.old_ep_patch)):
                pn0, pl0 = p_cur[t]
                ch_p[t].append(analytics.patch_tail(pp, pl0, pn0))
                p_kept = pm[:pn0] >= 0
                self._p_before[t] = self._p_before[t][p_kept]
                self.p_unsettled[t] = _remap_ids(pm, self.p_unsettled[t])
                for i in range(len(ch_p[t])):
                    ch_p[t][i] = _remap_ids(pm, ch_p[t][i])
                p_cur[t] = [int(p_kept.sum()), 0]
            # CSR slice: renumber eslot, drop edges the compaction killed
            new_slot = analytics.remap_slots(ev.e_map, self.eslot)
            dead = np.nonzero(new_slot < 0)[0]
            if dead.size:
                self._ekey = np.delete(self._ekey, dead)
                self.esrc = np.delete(self.esrc, dead)
                self.edst = np.delete(self.edst, dead)
                new_slot = np.delete(new_slot, dead)
            self.eslot = new_slot
            self.v_unsettled = _remap_ids(ev.v_map, self.v_unsettled)
            self.e_unsettled = _remap_ids(ev.e_map, self.e_unsettled)
            for lst, smap in ((ch_v, ev.v_map), (ch_e, ev.e_map)):
                for i in range(len(lst)):
                    lst[i] = _remap_ids(smap, lst[i])
            nv0 = int(v_kept.sum())
            ne0 = int(e_kept.sum())
        # vertex slots renumbered: rebuild the gid -> slot map (gids are
        # stable, so this is pure integer scatter, no stamp work)
        gids = self.cols.v_gid.view()
        top = int(gids.max()) + 1 if cols.n_v else 1
        self._slot_of = np.full(top, -1, np.int64)
        self._slot_of[gids] = np.arange(cols.n_v, dtype=np.int64)
        # owner slots renumbered, so the per-owner cached views are
        # stale; dropped and rebuilt lazily on next access (pure column
        # gather over the already-maintained _p_before masks — no stamp
        # or oracle work)
        self._prop_cache = {}
        return nv0, ne0, {t: p_cur[t][0] for t in ("v", "e")}

    def refresh(self, at: Stamp,
                refine_batch: Optional[Callable] = None) -> bool:
        """Delta-consume column changes (optionally advancing the plan
        stamp to a later ``at``).  Returns False when a cold rebuild is
        required: the compaction-event history no longer covers this
        plan's cursor, or ``at`` does not dominate the plan stamp.  On
        True, the plan is exactly equal to ``ShardPlan(cols, at, ...)``
        built fresh (same visibility, same CSR edge multiset, same
        property views), and ``last_refresh_rows`` holds the number of
        rows whose stamps were re-evaluated."""
        cols = self.cols
        o = compare(self.at, at)
        if o not in (Order.EQUAL, Order.BEFORE):
            return False
        if self._consumed[4] < cols.events_dropped:
            return False
        if refine_batch is not None:
            self._refine_batch = refine_batch
        if self._plane is not None:
            # keep the device-resident block tracking the change feed
            # (O(changed) row scatters); the gathered subset below is
            # evaluated by its own _before_rows launch — the delta set
            # is tiny by contract, and the masks are bit-identical
            self._plane.sync([cols])
        stamp_moved = o is Order.BEFORE
        self.at = at
        self.q = clock.pack(at, self.n_gk)

        ch_v: List[np.ndarray] = []
        ch_e: List[np.ndarray] = []
        ch_p: Dict[str, List[np.ndarray]] = {"v": [], "e": []}
        compacted = self._consumed[4] < cols.events_dropped + len(cols.events)
        if compacted:
            nv0, ne0, p_n0 = self._consume_compactions(ch_v, ch_e, ch_p)
            lv0 = le0 = 0
        else:
            nv0, ne0, lv0, le0, _ = self._consumed
            p_n0 = None
        from . import analytics
        if len(cols.v_patch) > lv0:
            ch_v.append(analytics.patch_tail(cols.v_patch, lv0, nv0))
        if len(cols.e_patch) > le0:
            ch_e.append(analytics.patch_tail(cols.e_patch, le0, ne0))
        nv, ne = cols.n_v, cols.n_e
        if nv > nv0:
            self.v_visible = np.concatenate(
                [self.v_visible, np.zeros(nv - nv0, bool)])
            new_gids = cols.v_gid.view()[nv0:nv].astype(np.int64)
            top = int(new_gids.max()) + 1
            if top > self._slot_of.size:
                self._slot_of = np.concatenate(
                    [self._slot_of,
                     np.full(top - self._slot_of.size, -1, np.int64)])
            self._slot_of[new_gids] = np.arange(nv0, nv, dtype=np.int64)
            ch_v.append(np.arange(nv0, nv, dtype=np.int64))
        if ne > ne0:
            self.e_vis = np.concatenate(
                [self.e_vis, np.zeros(ne - ne0, bool)])
            self.e_keep = np.concatenate(
                [self.e_keep, np.zeros(ne - ne0, bool)])
            ch_e.append(np.arange(ne0, ne, dtype=np.int64))

        cat = lambda parts: (np.unique(np.concatenate(parts)) if parts
                             else np.zeros(0, np.int64))
        ids_v, ids_e = cat(ch_v), cat(ch_e)
        if stamp_moved:
            ids_v = np.union1d(ids_v, self.v_unsettled)
            ids_e = np.union1d(ids_e, self.e_unsettled)
        p_ids: Dict[str, np.ndarray] = {}
        for t, pt in (("v", cols.v_props), ("e", cols.e_props)):
            # compacted: _consume_compactions already remapped the masks
            # and recovered the unread pre-compaction tail into ch_p, so
            # the same O(changed) delta path applies either way
            n0, lp0 = (p_n0[t], 0) if compacted else self._p_consumed[t]
            chp = ch_p[t]
            if len(pt.patch) > lp0:
                chp.append(analytics.patch_tail(pt.patch, lp0, n0))
            if pt.n > n0:
                self._p_before[t] = np.concatenate(
                    [self._p_before[t], np.zeros(pt.n - n0, bool)])
                chp.append(np.arange(n0, pt.n, dtype=np.int64))
            ids = cat(chp)
            if stamp_moved:
                ids = np.union1d(ids, self.p_unsettled[t])
            p_ids[t] = ids
            self._p_consumed[t] = pt.cursor()

        # ---- evaluate every changed/unsettled row, ONE oracle pass -----
        pend: List[tuple] = []
        vc = cols.v_create.view()[ids_v]
        vd = cols.v_delete.view()[ids_v]
        cb = self._eval(vc, cols.v_create_stamp, pend, ids=ids_v)
        db = self._eval(vd, cols.v_delete_stamp, pend, ids=ids_v)
        ec = cols.e_create.view()[ids_e]
        ed = cols.e_delete.view()[ids_e]
        ecb = self._eval(ec, cols.e_create_stamp, pend, ids=ids_e)
        edb = self._eval(ed, cols.e_delete_stamp, pend, ids=ids_e)
        p_eval = {}
        for t, pt in (("v", cols.v_props), ("e", cols.e_props)):
            p_eval[t] = self._eval(pt.stamp.view()[p_ids[t]], pt.stamp_obj,
                                   pend, ids=p_ids[t])
        self._resolve(pend)

        # ---- apply: vertices ------------------------------------------
        old_v = self.v_visible[ids_v]
        new_v = cb & ~db
        self.v_visible[ids_v] = new_v
        self.v_unsettled = _merge_unsettled(
            self.v_unsettled, ids_v, self._unsett(vc, vd, cb, db))
        flipped = ids_v[new_v != old_v]

        # ---- apply: edges (keep = visible edge of visible source) -----
        self.e_vis[ids_e] = ecb & ~edb
        self.e_unsettled = _merge_unsettled(
            self.e_unsettled, ids_e, self._unsett(ec, ed, ecb, edb))
        if flipped.size:
            # one vectorized membership scan over the int32 src column —
            # O(E) memcpy-class, NOT stamp work (same pattern as
            # SnapshotEngine._refresh); runs only when a vertex flipped
            fg = cols.v_gid.view()[flipped]
            cand = np.nonzero(np.isin(cols.e_src.view(), fg))[0]
            aff = np.union1d(ids_e, cand.astype(np.int64))
        else:
            aff = ids_e
        if aff.size:
            src = cols.e_src.view()[aff].astype(np.int64)
            sslot = np.where(src < self._slot_of.size,
                             self._slot_of[np.minimum(src,
                                                      self._slot_of.size - 1)],
                             -1)
            new_keep = self.e_vis[aff] & (sslot >= 0)
            new_keep[new_keep] &= self.v_visible[sslot[new_keep]]
            old_keep = self.e_keep[aff]
            self.e_keep[aff] = new_keep
            rem = aff[old_keep & ~new_keep]
            add = aff[new_keep & ~old_keep]
            if rem.size:
                pos = np.nonzero(np.isin(self.eslot, rem))[0]
                self._ekey = np.delete(self._ekey, pos)
                self.esrc = np.delete(self.esrc, pos)
                self.edst = np.delete(self.edst, pos)
                self.eslot = np.delete(self.eslot, pos)
            if add.size:
                asrc = cols.e_src.view()[add].astype(np.int64)
                adst = cols.e_dst.view()[add].astype(np.int64)
                akey = _edge_key(asrc, adst)
                order = np.argsort(akey, kind="stable")
                akey, asrc = akey[order], asrc[order]
                adst, aslot = adst[order], add[order]
                ins = np.searchsorted(self._ekey, akey, side="right")
                self._ekey = np.insert(self._ekey, ins, akey)
                self.esrc = np.insert(self.esrc, ins, asrc)
                self.edst = np.insert(self.edst, ins, adst)
                self.eslot = np.insert(self.eslot, ins, aslot)

        # consume cursors advance BEFORE the property application: the
        # per-key views are sized by the consumed owner count, which now
        # includes this refresh's appends
        self.version = cols.version
        self._consumed = cols.cursor()

        # ---- apply: property views ------------------------------------
        n_prop = 0
        for t, pt in (("v", cols.v_props), ("e", cols.e_props)):
            ids = p_ids[t]
            n_prop += int(ids.size)
            if ids.size:
                pb = p_eval[t]
                self._p_before[t][ids] = pb
                pres = pt.stamp.view()[ids][:, 0] != NO_STAMP
                self.p_unsettled[t] = _merge_unsettled(
                    self.p_unsettled[t], ids, pres & ~pb)
            # always: cached per-key views must track owner-table growth
            # even when no property row changed
            self._refresh_prop_cache(t, pt, ids)

        self._recheck_settled()
        self._uadj = None                  # CSR slice may have changed
        self.last_refresh_rows = int(ids_v.size + ids_e.size) + n_prop
        return True

    def _refresh_prop_cache(self, t: str, pt, ids: np.ndarray) -> None:
        """Patch cached per-key property views for the owners touched by
        the changed version rows (O(affected owners), not O(key rows))."""
        cols = self.cols
        n_owner = self._consumed_owner(t)
        key_col = pt.key.view()
        owner_col = pt.owner.view()
        val_col = pt.val.view()
        num_col = pt.num.view()
        pb = self._p_before[t]
        for ck in list(self._prop_cache):
            tt, key = ck
            if tt != t:
                continue
            idarr, numarr = self._prop_cache[ck]
            if idarr.size < n_owner:
                idarr = np.concatenate(
                    [idarr, np.full(n_owner - idarr.size, -1, np.int64)])
                numarr = np.concatenate(
                    [numarr, np.full(n_owner - numarr.size, np.nan)])
                self._prop_cache[ck] = (idarr, numarr)
            kid = cols.keys.lookup(key)
            if kid < 0:
                continue
            aff = ids[key_col[ids] == kid]
            if aff.size == 0:
                continue
            for o in np.unique(owner_col[aff]).tolist():
                rows_o = np.asarray(pt.by_owner.get(int(o), ()), np.int64)
                sel = (rows_o[(key_col[rows_o] == kid) & pb[rows_o]]
                       if rows_o.size else rows_o)
                if sel.size:        # append order == version order
                    last = int(sel[-1])
                    idarr[o] = val_col[last]
                    numarr[o] = num_col[last]
                else:
                    idarr[o] = -1
                    numarr[o] = np.nan

    def _consumed_owner(self, table: str) -> int:
        return self._consumed[0] if table == "v" else self._consumed[1]

    # ------------------------------------------------------------- lookups
    def vertex_visible(self, gids: np.ndarray) -> np.ndarray:
        """(F,) bool — is each frontier gid a visible vertex here?"""
        g = np.asarray(gids, np.int64)
        ok = (g >= 0) & (g < self._slot_of.size)
        slot = np.where(ok, self._slot_of[np.minimum(g, self._slot_of.size - 1)],
                        -1)
        ok &= slot >= 0
        ok[ok] = self.v_visible[slot[ok]]
        return ok

    def edge_ranges(self, gids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """CSR [lo, hi) into esrc/edst per frontier gid."""
        g = np.asarray(gids, np.int64)
        return (np.searchsorted(self.esrc, g, side="left"),
                np.searchsorted(self.esrc, g, side="right"))

    def gather_edges(self, gids: np.ndarray):
        """Ragged expansion: all CSR edge positions of ``gids``, plus the
        index of the source frontier entry per position."""
        lo, hi = self.edge_ranges(gids)
        ln = hi - lo
        total = int(ln.sum())
        if total == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64), ln
        off = np.repeat(np.cumsum(ln) - ln, ln)
        pos = np.arange(total, dtype=np.int64) - off + np.repeat(lo, ln)
        src_idx = np.repeat(np.arange(g_len(gids), dtype=np.int64), ln)
        return pos, src_idx, ln

    def out_degree(self, gids: np.ndarray) -> np.ndarray:
        lo, hi = self.edge_ranges(gids)
        return hi - lo

    def edge_eids(self, pos: np.ndarray) -> np.ndarray:
        """Edge id per CSR position (``get_edges`` ragged replies)."""
        return self.cols.e_eid.view()[self.eslot[np.asarray(pos, np.int64)]]

    def unique_adj(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Sorted-UNIQUE adjacency over the CSR slice: ``(keys, src,
        dst)`` with ``keys = (src gid << 32) | dst gid`` ascending
        (parallel edges collapse to one neighbour — set semantics for
        wedge closing).  Cached per plan state; a delta refresh
        invalidates it.  Row slices come from ``searchsorted`` on the
        ``src`` half; the key array doubles as the membership-probe
        target of :func:`repro_torch.core.analytics.intersect_counts`."""
        if self._uadj is None:
            ukey = np.unique(self._ekey)
            self._uadj = (ukey, ukey >> 32,
                          ukey & np.int64(0xFFFFFFFF))
        return self._uadj

    # ------------------------------------------------------------ properties
    def _prop_arrays(self, table: str, key: str):
        """(val_id, num) of the latest visible version per OWNER SLOT.

        Derived from the eagerly-maintained per-row ``_p_before`` masks
        (no oracle traffic here); delta refreshes keep cached entries
        fresh per affected owner (:meth:`_refresh_prop_cache`)."""
        ck = (table, key)
        hit = self._prop_cache.get(ck)
        if hit is not None:
            return hit
        cols = self.cols
        pt = cols.v_props if table == "v" else cols.e_props
        n_owner = self._consumed_owner(table)
        n_rows = self._p_consumed[table][0]
        ids = np.full(n_owner, -1, np.int64)
        num = np.full(n_owner, np.nan)
        kid = cols.keys.lookup(key)
        if kid >= 0 and n_rows:
            krows = np.nonzero((pt.key.view()[:n_rows] == kid)
                               & self._p_before[table][:n_rows])[0]
            if krows.size:
                owners = pt.owner.view()[krows].astype(np.int64)
                # ascending row order == version order: last write wins
                ids[owners] = pt.val.view()[krows]
                num[owners] = pt.num.view()[krows]
        self._prop_cache[ck] = (ids, num)
        return ids, num

    def edge_prop(self, key: str):
        """(val_id, num) per CSR edge position (-1 / NaN = absent)."""
        ids, num = self._prop_arrays("e", key)
        return ids[self.eslot], num[self.eslot]

    def vertex_prop_of(self, gids: np.ndarray, key: str):
        """(val_id, num) per gid; caller guarantees visibility."""
        ids, num = self._prop_arrays("v", key)
        slot = self._slot_of[np.asarray(gids, np.int64)]
        return ids[slot], num[slot]

    def value_id(self, value) -> int:
        """This partition's intern id for a filter constant (-1 = never
        stored here, matches nothing)."""
        return self.cols.vals.lookup(value)

    def value_of(self, val_id: int):
        return self.cols.vals.vals[val_id] if val_id >= 0 else None


def maintain_plan(plan: Optional[ShardPlan], cols, at: Stamp, n_gk: int,
                  refine_batch: Optional[Callable],
                  allow_delta: bool = True,
                  device_plane=None, device: str = "cuda"
                  ) -> Tuple[ShardPlan, str]:
    """The three-way plan maintenance policy, shared by the shard event
    loop (``Shard._frontier_plan``) and the synchronous driver
    (:func:`run_local`) so benchmarks measure exactly what the
    simulated system runs.  Returns ``(plan, kind)``:

    * ``"reuse"`` — columns unchanged AND (same stamp, or the plan is
      settled and the stamp dominates it);
    * ``"delta"`` — :meth:`ShardPlan.refresh` consumed the change feed
      (``plan.last_refresh_rows`` holds the re-evaluated row count);
    * ``"cold"``  — a fresh build (first contact, stamp regression, or
      the compaction-event history no longer covers the plan's cursor —
      the stale plan, settled or not, must be discarded).
    """
    if plan is not None and plan.cols is cols:
        same = plan.at.key() == at.key()
        later = same or compare(plan.at, at) in (Order.BEFORE, Order.EQUAL)
        if plan.version == cols.version and (
                same or (plan.settled and later)):
            return plan, "reuse"
        if later and allow_delta and plan.refresh(
                at, refine_batch=refine_batch):
            return plan, "delta"
    return ShardPlan(cols, at, n_gk, refine_batch=refine_batch,
                     device_plane=device_plane, device=device), "cold"


def g_len(a: np.ndarray) -> int:
    return int(np.asarray(a).size)


class BatchContext:
    """What a ``frontier_step`` sees: the plan, vid resolution, output
    and emit sinks, and service-time accounting mirroring the scalar
    cost model (prog_vertex / prog_revisit / prog_edge)."""

    def __init__(self, plan: ShardPlan, intern, cost):
        self.plan = plan
        self.intern = intern
        self.cost = cost
        self.outputs: List[object] = []
        self.emits: List[tuple] = []       # (gids, vals, tags, ragged)
        self.next_meta: Optional[dict] = None
        self.service = 0.0

    def vid(self, gid: int) -> str:
        return self.intern.vids[gid]

    def vids_of(self, gids: np.ndarray) -> List[str]:
        vs = self.intern.vids
        return [vs[g] for g in np.asarray(gids).tolist()]

    def output(self, value) -> None:
        self.outputs.append(value)

    def emit(self, gids: np.ndarray, vals: Optional[np.ndarray] = None,
             meta: Optional[dict] = None,
             tags: Optional[np.ndarray] = None,
             ragged: Optional[Ragged] = None) -> None:
        self.emits.append((
            np.asarray(gids, np.int64),
            None if vals is None else np.asarray(vals, np.float64),
            None if tags is None else np.asarray(tags, np.int64),
            ragged))
        if meta is not None:
            self.next_meta = meta

    def charge(self, n_visit: int = 0, n_revisit: int = 0,
               n_edges: int = 0) -> None:
        self.service += (self.cost.prog_vertex * n_visit
                         + self.cost.prog_revisit * n_revisit
                         + self.cost.prog_edge * n_edges)


def execute_step(plan: ShardPlan, prog, frontier: Frontier, state: dict,
                 intern, cost) -> Tuple[List[object], Optional[Frontier],
                                        float]:
    """Run one batched hop.  Returns (outputs, next_frontier, service)."""
    ctx = BatchContext(plan, intern, cost)
    prog.frontier_step(plan, frontier, state, ctx)
    nxt = None
    meta = ctx.next_meta if ctx.next_meta is not None else frontier.meta
    parts = [Frontier(gids=g, vals=v, depth=frontier.depth + 1, meta=meta,
                      tags=t, ragged=r)
             for g, v, t, r in ctx.emits if g.size]
    if parts:
        nxt = _merge_frontiers(parts)
    return ctx.outputs, nxt, ctx.service


def ensure_state(state: dict, name: str, n: int, fill, dtype) -> np.ndarray:
    """Grow-on-demand per-program state array indexed by gid."""
    arr = state.get(name)
    if arr is None or arr.size < n:
        nu = np.full(max(n, 64, 0 if arr is None else arr.size * 2),
                     fill, dtype)
        if arr is not None:
            nu[:arr.size] = arr
        state[name] = arr = nu
    return arr


# ---------------------------------------------------------------------------
# Synchronous driver (tests / wall-clock benchmarks): executes a whole
# program hop-by-hop against the shard partitions directly, without the
# simulator.  ``use_frontier=False`` drives the scalar per-vertex path
# over the same stamps — the equivalence oracle.
# ---------------------------------------------------------------------------

def run_local(weaver, name: str, entries, at: Stamp,
              use_frontier: bool = True,
              shard_of: Optional[Callable[[str], Optional[int]]] = None,
              refine_oracle: bool = True,
              on_hop: Optional[Callable[[int], None]] = None,
              plan_delta: bool = True,
              plans: Optional[Dict[int, "ShardPlan"]] = None,
              persistent_plans: bool = True):
    """Execute program ``name`` at stamp ``at`` synchronously.

    Returns ``(result, stats)`` where stats counts hops, messages and
    delivered entries — the benchmark's message-reduction evidence —
    plus plan-maintenance accounting: ``plan_cold`` / ``plan_delta``
    builds, ``plan_rows`` re-evaluated by delta refreshes, and
    ``plan_seconds`` of wall clock spent building/refreshing plans.

    ``on_hop(hop_index)`` fires after every hop (both paths) — tests and
    benchmarks use it to commit writes *between* hops; snapshot
    isolation at ``at`` means results must not change.  ``plan_delta=
    False`` forces a cold plan rebuild whenever a shard's columns
    changed (the benchmark's write-churn baseline).  ``plans`` is an
    optional PERSISTENT per-shard plan dict — the synchronous analogue
    of the shard event loop's stamp-keyed plan LRU: a read stream passes
    the same dict across calls so settled plans are reused (or
    delta-refreshed) instead of cold-rebuilt per query, exactly like the
    simulated system (``Shard._frontier_plan``).

    When ``plans`` is not given, a per-weaver dict is used by DEFAULT
    (``persistent_plans=True``): repeated queries against the same
    weaver reuse/delta-refresh plans across calls, mirroring the shard
    plan LRU.  Pass ``persistent_plans=False`` (or an explicit fresh
    ``plans={}``) to force per-call plan builds — benchmarks measuring
    the cold path do.  The persistent dict is only used on the default
    refined path (``refine_oracle=True``) so conservative-mode calls
    never reuse a refined plan.
    """
    import time as _time
    from .nodeprog import REGISTRY, run_entries_scalar
    from .oracle import KIND_PROG, KIND_TX

    prog = REGISTRY[name]
    shards = weaver.shards
    place = shard_of or (lambda vid: weaver.store.place(vid))
    intern = weaver.intern
    cache: Dict[tuple, bool] = {}

    def refine_pair(a: Stamp, b: Stamp) -> Order:
        if b.key() == at.key():     # object stamp vs program stamp
            got = refine_many([a])
            return Order.BEFORE if got[a.key()] else Order.AFTER
        if not refine_oracle:       # conservative default: a after b
            return Order.AFTER
        # version-vs-version (prop_at ordering): pairwise refinement
        chain = weaver.oracle.oracle.order_events([a, b],
                                                  [KIND_TX, KIND_TX])
        weaver.sim.counters.oracle_calls += 1
        return Order.BEFORE if chain[0] == a.key() else Order.AFTER

    def refine_many(stamps: List[Stamp]) -> Dict[tuple, bool]:
        missing = [s for s in stamps if s.key() not in cache]
        if missing:
            if refine_oracle:
                oracle = weaver.oracle.oracle
                chain = oracle.order_events(
                    missing + [at], [KIND_TX] * len(missing) + [KIND_PROG])
                weaver.sim.counters.oracle_calls += 1
                pos = {k: i for i, k in enumerate(chain)}
                for s in missing:
                    cache[s.key()] = pos[s.key()] < pos[at.key()]
            else:
                for s in missing:
                    cache[s.key()] = False     # conservative: write after
        return {s.key(): cache[s.key()] for s in stamps}

    stats = {"hops": 0, "messages": 0, "entries": 0, "batches": 0,
             "plan_cold": 0, "plan_delta": 0, "plan_rows": 0,
             "plan_seconds": 0.0, "plan_seconds_by_hop": []}
    outputs: List[object] = []

    batched = (use_frontier and prog.frontier_step is not None
               and prog.pack_root is not None)
    if batched:
        # all root entries must share one params dict (else scalar path)
        froot = prog.pack_root(entries, intern)
        batched = froot is not None

    if batched:
        if plans is None:
            if persistent_plans and refine_oracle:
                plans = weaver.__dict__.setdefault("_run_local_plans", {})
            else:
                plans = {}
        states: Dict[int, dict] = {}
        # route roots
        pending: Dict[int, Frontier] = route_frontier(froot, intern, place)
        while pending:
            stats["hops"] += 1
            hop_plan = 0.0
            nxt: Dict[int, List[Frontier]] = {}
            # ascending-sid iteration keeps output order deterministic
            # AND aligned with the scalar branch (same shard sequence)
            for sid, fr in sorted(pending.items()):
                stats["messages"] += 1
                stats["batches"] += 1
                stats["entries"] += len(fr)
                sh = shards[sid]
                cols = sh.partition.columns
                rb = refine_many if refine_oracle else None
                t0 = _time.perf_counter()
                plan, kind = maintain_plan(plans.get(sid), cols, at,
                                           sh.n_gk, rb,
                                           allow_delta=plan_delta,
                                           device=weaver.cfg.device)
                plans[sid] = plan
                if kind == "delta":
                    stats["plan_delta"] += 1
                    stats["plan_rows"] += plan.last_refresh_rows
                elif kind == "cold":
                    stats["plan_cold"] += 1
                dt = _time.perf_counter() - t0
                stats["plan_seconds"] += dt
                hop_plan += dt
                outs, out_fr, _ = execute_step(
                    plan, prog, fr, states.setdefault(sid, {}),
                    intern, sh.cost)
                outputs.extend(outs)
                if out_fr is not None:
                    for nsid, nfr in route_frontier(out_fr, intern,
                                                    place).items():
                        nxt.setdefault(nsid, []).append(nfr)
            pending = {sid: _merge_frontiers(frs)
                       for sid, frs in nxt.items()}
            stats["plan_seconds_by_hop"].append(hop_plan)
            if on_hop is not None:
                on_hop(stats["hops"])
    else:
        states = {}
        pending_s: Dict[int, list] = {}
        for vid, params in entries:
            sid = place(vid)
            if sid is not None:
                pending_s.setdefault(sid, []).append((vid, params))
        while pending_s:
            stats["hops"] += 1
            nxt_s: Dict[int, list] = {}
            for sid, ent in sorted(pending_s.items()):
                stats["messages"] += 1
                stats["entries"] += len(ent)
                sh = shards[sid]
                emits, outs, _ = run_entries_scalar(
                    sh.partition, prog, ent, at, refine_pair,
                    states.setdefault(sid, {}), sh.cost)
                outputs.extend(outs)
                for vid, params in emits:
                    nsid = place(vid)
                    if nsid is not None:
                        nxt_s.setdefault(nsid, []).append((vid, params))
            pending_s = nxt_s
            if on_hop is not None:
                on_hop(stats["hops"])

    return prog.reduce(outputs), stats


def _shard_groups(gids: np.ndarray, intern, place) -> Dict[int, np.ndarray]:
    """Destination shard -> entry-index array (stable order)."""
    out: Dict[int, np.ndarray] = {}
    if gids.size == 0:
        return out
    vids = intern.vids
    lst = []
    for g in gids.tolist():
        s = place(vids[g]) if g < len(vids) else None
        lst.append(-1 if s is None else s)
    sids = np.asarray(lst, np.int64)
    order = np.argsort(sids, kind="stable")
    sg = sids[order]
    starts = np.flatnonzero(np.r_[True, sg[1:] != sg[:-1]])
    bounds = np.r_[starts, sg.size]
    for i, st in enumerate(starts.tolist()):
        sid = int(sg[st])
        if sid < 0:
            continue
        out[sid] = order[st:bounds[i + 1]]
    return out


def route_frontier(fr: Frontier, intern, place) -> Dict[int, Frontier]:
    """Split a next-hop frontier into ONE packed message per destination
    shard.  Per-entry columns (gids / vals / tags) are sliced; a shared
    ``ragged`` side table is SUBSET to the rows the destination's entries
    reference (``Ragged.take``) and the tags re-based to the compact row
    numbering — each shard receives every origin's packed list exactly
    once, never the whole table."""
    out: Dict[int, Frontier] = {}
    for sid, sel in _shard_groups(fr.gids, intern, place).items():
        tags = None if fr.tags is None else fr.tags[sel]
        ragged = fr.ragged
        if ragged is not None and tags is not None:
            rows = np.unique(tags)
            ragged = ragged.take(rows)
            tags = np.searchsorted(rows, tags)
        out[sid] = Frontier(fr.gids[sel],
                            None if fr.vals is None else fr.vals[sel],
                            fr.depth, fr.meta, tags=tags, ragged=ragged)
    return out


def _merge_frontiers(frs: List[Frontier]) -> Frontier:
    """Concatenate same-(prog, stamp, depth, meta) frontiers into one
    execution unit.  Mixed optional columns backfill (0.0 vals / -1
    tags); ragged side tables concatenate row-wise with the owning
    frontier's tags re-based by its row offset."""
    if len(frs) == 1:
        return frs[0]
    gids = np.concatenate([f.gids for f in frs])
    vals = None
    if any(f.vals is not None for f in frs):
        vals = np.concatenate([
            f.vals if f.vals is not None else np.zeros(f.gids.size)
            for f in frs])
    tags = None
    ragged = None
    if any(f.ragged is not None for f in frs):
        withr = [f for f in frs if f.ragged is not None]
        assert len(withr) == len(frs), "mixed ragged/plain frontiers"
        ragged = Ragged.concat([f.ragged for f in frs])
        row_off = np.cumsum([0] + [len(f.ragged) for f in frs[:-1]])
        tags = np.concatenate([f.tags + off
                               for f, off in zip(frs, row_off)])
    elif any(f.tags is not None for f in frs):
        tags = np.concatenate([
            f.tags if f.tags is not None
            else np.full(f.gids.size, -1, np.int64) for f in frs])
    return Frontier(gids, vals, frs[0].depth, frs[0].meta,
                    tags=tags, ragged=ragged)
