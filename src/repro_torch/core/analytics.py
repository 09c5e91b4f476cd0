"""PyTorch data-plane bridge: multi-version snapshots -> arrays.

The control plane (shards) owns the multi-version graph; the data plane
materializes a *snapshot at a refinable timestamp* as flat arrays.  Every
batched stamp compare goes through the port's CUDA kernels
(``repro_torch.kernels.mv_visibility``) on the deployment's device
(``WeaverConfig.device``), or their plain PyTorch versions when that
device is the CPU.

Columnar snapshot engine
------------------------
Snapshots are served by :class:`SnapshotEngine`, which reads the
struct-of-arrays columns each :class:`~repro_torch.core.mvgraph.MVGraphPartition`
maintains incrementally on its write path (packed ``(N, G+1)`` int32
create/delete stamp matrices plus interned src/dst id columns):

* **cold build** — concatenate shard columns, evaluate visibility with
  ONE batched pass (the ``before`` kernel on the engine's device),
  refine the truly-concurrent stamps
  through a SINGLE timeline-oracle request, then compact the visible
  rows with vectorized numpy into CSR-sorted edge arrays;
* **delta refresh** — a second query at stamp ``T' ≻ T`` re-evaluates
  only rows whose stamps were patched/appended in ``(T, T']`` plus the
  cached *unsettled* rows (stamps not yet strictly before ``T``), then
  patches the sorted edge arrays by sorted-merge insert/delete — O(changed)
  stamp work instead of O(V+E).

Snapshot array ordering (documented contract): vertex indices follow
(shard, creation-slot) order on a cold build; a delta refresh appends
newly visible vertices at the end, removes a newly *invisible* vertex by
backfilling its index with the (previously) last vertex, and a slot
re-created after GC keeps its original position (the legacy dict path
would move it last).  Edge
arrays come in two sorted orientations: ``edge_src``/``edge_dst`` are
CSR (sorted by ``(src, dst)``) and ``csc_src``/``csc_dst`` are CSC
(sorted by ``(dst, src)``), so segment reductions can rely on sorted
segment ids on whichever axis they reduce over.

Visibility follows :func:`repro_torch.core.clock.visibility_mask`; stamps that
are truly concurrent with the query stamp (rare: the query stamp is
normally issued after the writes committed) are refined through the
timeline oracle exactly like the shard path would, but batched into one
``order_events`` request per snapshot instead of one per object.

Traversals
----------
``bfs_levels``, ``reachable``, ``connected_components``, ``pagerank``,
``sssp_weighted`` and ``clustering_coefficients_padded`` (with the
``_ga`` forms over a snapshot) are the reference's jitted frontier
programs as torch loops on their arguments' device: segment reductions
are ``scatter_reduce`` / ``index_add_`` with ``jax.ops.segment_*``'s
identities (a BFS round on a card is one ``kernels.bfs_round`` launch
instead), and a relax-until-stable loop reads its ``changed`` flag from
the device once per round.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..kernels.bfs_round import ops as bfs_round
from ..kernels.mv_visibility import ops as mv_ops
from . import clock, obs
from .clock import NO_STAMP, Order, Stamp, compare
from .edgeversions import EdgeVersionTable
from .mvgraph import PartitionColumns, VidIntern
from .oracle import KIND_PROG, KIND_TX

INF = np.int32(2**31 - 1)

_LITTLE_ENDIAN = np.dtype(np.int64).byteorder in ("<", "=") and \
    __import__("sys").byteorder == "little"


def _key_halves(key: np.ndarray):
    """(high, low) int32 halves of packed (hi << 32 | lo) keys."""
    if not _LITTLE_ENDIAN:  # pragma: no cover - big-endian fallback
        return ((key >> 32).astype(np.int32),
                (key & np.int64(0xFFFFFFFF)).astype(np.int32))
    pairs = key.view(np.int32).reshape(-1, 2)
    return (np.ascontiguousarray(pairs[:, 1]),
            np.ascontiguousarray(pairs[:, 0]))


@dataclass
class GraphArrays:
    """A timestamp-consistent snapshot in array form."""

    vids: List[str]                  # index -> vertex id
    index: dict                      # vertex id -> index
    edge_src: np.ndarray             # (E,) int32, CSR order (src-major)
    edge_dst: np.ndarray             # (E,) int32, CSR order
    n_nodes: int

    # raw (pre-filter) stamp rows, for kernel-level visibility filtering
    edge_create: Optional[np.ndarray] = None   # (E_raw, G+1) int32
    edge_delete: Optional[np.ndarray] = None
    raw_src: Optional[np.ndarray] = None
    raw_dst: Optional[np.ndarray] = None

    # lazily-derived views: CSC orientation ((dst<<32|src) keys from the
    # engine) and CSR row starts
    _csc_key: Optional[np.ndarray] = None
    _csc: Optional[tuple] = None
    _indptr: Optional[np.ndarray] = None

    @property
    def csc_src(self) -> np.ndarray:
        """(E,) int32, CSC order (dst-major) — same edge multiset as
        edge_src/edge_dst, for dst-keyed segment reductions over sorted
        segment ids."""
        if self._csc is None:
            if self._csc_key is not None:
                dst, src = _key_halves(self._csc_key)
            else:
                order = np.argsort(
                    _sort_key(self.edge_dst, self.edge_src), kind="stable")
                src, dst = self.edge_src[order], self.edge_dst[order]
            self._csc = (src, dst)
        return self._csc[0]

    @property
    def csc_dst(self) -> np.ndarray:
        self.csc_src
        return self._csc[1]

    @property
    def indptr(self) -> np.ndarray:
        """(n_nodes+1,) CSR row starts, derived lazily from edge_src.

        Only meaningful when edge_src is CSR-sorted (engine snapshots
        are; the legacy ``snapshot_arrays_python`` path is not)."""
        if self._indptr is None:
            if self.edge_src.size and np.any(np.diff(self.edge_src) < 0):
                raise ValueError(
                    "indptr requires CSR-sorted edge_src (snapshots from "
                    "the columnar engine); this GraphArrays is unsorted")
            self._indptr = np.searchsorted(
                self.edge_src, np.arange(self.n_nodes + 1)).astype(np.int64)
        return self._indptr


# ---------------------------------------------------------------------------
# Batched visibility primitives (the CUDA kernels on a CUDA device, their
# plain PyTorch versions on the CPU).
# ---------------------------------------------------------------------------

def check_device(device: str) -> None:
    """Raise unless ``device`` names a device this process can use: a
    CUDA device needs a card; nothing falls back to the CPU silently."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} needs a CUDA device and none is available; "
            f'pass device="cpu" to run on the CPU')


def to_device(a: np.ndarray, device: str) -> torch.Tensor:
    """Contiguous int32 host stamp rows -> a tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)


def _before_batch(rows: np.ndarray, q: np.ndarray,
                  device: str) -> np.ndarray:
    """rows[i] ≺ q over an (N, C) int32 matrix -> (N,) bool, as ONE
    ``before`` kernel launch on ``device`` in one host round trip
    (``mv_ops.before_host``)."""
    return mv_ops.before_host(rows, q, device)


def _sort_key(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    return (src.astype(np.int64) << 32) | dst.astype(np.int64)


def remap_slots(smap: np.ndarray, slots: np.ndarray) -> np.ndarray:
    """Translate slot ids through a CompactionEvent old→new map.

    Out-of-range and already-dropped ids map to -1 (the row can never be
    visible again).  Shared by the global snapshot cache and the
    per-shard frontier plans — both consume the same
    :class:`~repro_torch.core.mvgraph.CompactionEvent` log.
    """
    s = np.asarray(slots, np.int64)
    out = np.full(s.shape, -1, np.int64)
    ok = (s >= 0) & (s < smap.size)
    out[ok] = smap[s[ok]]
    return out


def patch_tail(patch: list, cursor: int, n0: int) -> np.ndarray:
    """Unread pre-compaction patch-log tail, restricted to the consumer's
    already-consumed rows (``slot < n0``; later slots ride along with the
    append batch)."""
    tail = {s for s in patch[cursor:] if s < n0}
    return np.asarray(sorted(tail), np.int64)


def _merge_patch(key: np.ndarray, rem_key: np.ndarray,
                 add_key: np.ndarray) -> np.ndarray:
    """Patch a sorted key multiset by sorted-merge delete+insert.

    ``rem_key`` entries are removed by multiset semantics (any position
    holding an equal key may be dropped — a key IS the payload: the edge
    endpoints are packed into its two halves).  Small change sets splice
    contiguous runs (O(changes) Python + O(E) memcpy); large ones fall
    back to one boolean compress + re-sort.
    """
    n_ch = rem_key.size + add_key.size
    if n_ch == 0:
        return key
    if n_ch > max(64, key.size // 16):
        # bulk path: compress deletions, then sort the concatenation
        if rem_key.size:
            rk = np.sort(rem_key)
            dpos = np.searchsorted(key, rk, side="left")
            dpos = dpos + (np.arange(rk.size)
                           - np.searchsorted(rk, rk, side="left"))
            keep = np.ones(key.size, bool)
            keep[dpos] = False
            key = key[keep]
        if add_key.size:
            key = np.sort(np.concatenate([key, add_key]))
        return key
    if rem_key.size:
        rk = np.sort(rem_key)
        dpos = np.searchsorted(key, rk, side="left")
        # distinct consecutive positions for duplicate keys
        dpos = dpos + (np.arange(rk.size)
                       - np.searchsorted(rk, rk, side="left"))
    else:
        dpos = np.zeros(0, np.int64)
    ak = np.sort(add_key)
    ipos = np.searchsorted(key, ak)
    # event stream over original positions; insertions sort BEFORE
    # deletions at equal positions (a deletion advances the source
    # cursor past the tie, which would send a later same-position
    # insertion's run length negative)
    evpos = np.concatenate([ipos, dpos])
    order = np.argsort(evpos, kind="stable")
    out = np.empty(key.size - rem_key.size + add_key.size, key.dtype)
    src = 0          # cursor into key
    o = 0            # cursor into out
    ni = ipos.size
    pos_l = evpos.tolist()          # python ints: no per-event np scalars
    ak_l = ak.tolist()
    for ev in order.tolist():
        pos = pos_l[ev]
        run = pos - src
        if run:
            out[o:o + run] = key[src:pos]
            o += run
            src = pos
        if ev < ni:                 # insertion
            out[o] = ak_l[ev]
            o += 1
        else:                       # deletion: skip one source element
            src += 1
    run = key.size - src
    if run:
        out[o:o + run] = key[src:]
    return out


class _GrowArr:
    """ndarray with append slack so delta-refresh row appends are
    amortized O(appended) instead of re-copying the whole column."""

    __slots__ = ("n", "buf")

    def __init__(self, arr: np.ndarray):
        self.n = arr.size
        self.buf = np.empty(max(64, int(arr.size * 5 // 4)), arr.dtype)
        self.buf[:self.n] = arr

    def view(self) -> np.ndarray:
        return self.buf[:self.n]

    def extend(self, arr: np.ndarray) -> np.ndarray:
        need = self.n + arr.size
        if need > self.buf.size:
            nu = np.empty(max(need, self.buf.size * 2), self.buf.dtype)
            nu[:self.n] = self.buf[:self.n]
            self.buf = nu
        self.buf[self.n:need] = arr
        self.n = need
        return self.view()


class SnapshotEngine:
    """Columnar snapshot materializer with an epoch-keyed delta cache.

    One engine per :class:`~repro_torch.core.weaver.Weaver` (attached lazily by
    :func:`snapshot_arrays`).  The cache is valid for a query stamp ``T'``
    iff the shard/partition topology is unchanged and ``T ≼ T'`` (same or
    later epoch); otherwise the engine falls back to a cold build.

    A vertex whose cached visibility flips OFF (a vertex deletion — or
    GC purge — becoming visible between snapshots) is removed from the
    compacted index *in place*: its index slot is tombstoned in
    ``vid_index`` and backfilled by the last vertex, and only the CSR/CSC
    keys of edges incident to the two touched vertices are patched — so
    vertex churn stays O(changed) like edge churn instead of degrading
    to a cold rebuild.

    Column **compactions** (``PartitionColumns.compact``) are consumed
    through the per-shard ``events`` log: cached rows are remapped to the
    new slot numbering (dropped slots point nowhere and gather as
    all-``NO_STAMP``), unread patch-log tails are recovered from the
    event, and the delta path continues uninterrupted.
    """

    def __init__(self, weaver) -> None:
        self.weaver = weaver
        self.n_gk = weaver.cfg.n_gatekeepers
        self.c = self.n_gk + 1
        self.device = weaver.device
        self._valid = False
        # device-resident column plane (repro_torch.dist.columns): cold
        # builds take their create/delete masks from ONE launch over the
        # resident blocks instead of per-shard passes
        self.plane = getattr(weaver, "device_plane", None)
        self.stats = {"cold": 0, "delta": 0, "delta_noop": 0}

    # ------------------------------------------------------------- helpers
    def _shards(self):
        return [sh for sh in self.weaver.shards if sh.alive]

    def _signature(self, shards):
        return [(id(sh), id(sh.partition), id(sh.partition.columns))
                for sh in shards]

    def _resolve(self, pend: List[tuple], at: Stamp) -> None:
        """ONE oracle pass for every concurrent stamp of this snapshot."""
        if not pend:
            return
        uniq: Dict[tuple, Stamp] = {}
        for _, _, s in pend:
            uniq[s.key()] = s
        stamps = list(uniq.values())
        oracle = self.weaver.oracle.oracle
        chain = oracle.order_events(stamps + [at],
                                    [KIND_TX] * len(stamps) + [KIND_PROG])
        self.weaver.sim.counters.oracle_calls += 1
        pos = {k: i for i, k in enumerate(chain)}
        p_at = pos[at.key()]
        for arr, i, s in pend:
            arr[i] = pos[s.key()] < p_at

    def _eval(self, create_rows, delete_rows, cstamp, dstamp, q, at,
              refine, pend, pre=None):
        """Conservative cb/db for a row block; queue concurrents on pend.

        ``cstamp``/``dstamp`` map a local row id to its original
        :class:`Stamp` and are only called for the (rare) rows whose
        packed form is possibly concurrent with q.  ``pre`` is a
        precomputed ``(cb, db)`` pair (the device plane's sharded
        launch, bit-identical to the host evaluation) — only the
        concurrent-residue queueing runs here then.
        """
        if pre is not None:
            cb = np.array(pre[0], dtype=bool)
            db = np.array(pre[1], dtype=bool)
        else:                   # one round trip for both row blocks
            both = _before_batch(np.concatenate((create_rows, delete_rows)),
                                 q, self.device)
            cb, db = both[:create_rows.shape[0]], both[create_rows.shape[0]:]
        if refine and create_rows.shape[0]:
            for rows, arr, stamp_of in ((create_rows, cb, cstamp),
                                        (delete_rows, db, dstamp)):
                cand = np.nonzero(clock.concurrent_mask_np(rows, q))[0]
                for i in cand:
                    s = stamp_of(int(i))
                    if s is not None and compare(s, at) is Order.CONCURRENT:
                        pend.append((arr, i, s))
        return cb, db

    @staticmethod
    def _unsettled(create_rows, delete_rows, cb, db) -> np.ndarray:
        """Rows whose visibility can still change as T advances."""
        c_present = create_rows[:, 0] != NO_STAMP
        d_present = delete_rows[:, 0] != NO_STAMP
        return (c_present & ~cb) | (d_present & ~db)

    # ---------------------------------------------------------------- cold
    def _cold(self, at: Stamp, refine: bool) -> None:
        shards = self._shards()
        q = clock.pack(at, self.n_gk)
        pend: List[tuple] = []
        self.sig = self._signature(shards)
        self.shard_cols = [sh.partition.columns for sh in shards]
        # device-sharded path: one sync + ONE sharded kernel launch for
        # every shard's create/delete masks; the per-shard loop below
        # then only gathers views and queues the concurrent residue
        # (resolved by the same single batched oracle trip)
        mk = None
        if self.plane is not None:
            self.plane.sync(self.shard_cols)
            self.plane.before_all(q)
            mk = {id(c): self.plane.masks_for(c)
                  for c in self.shard_cols if c is not None}
        # per shard: [n_v, n_e, v_log, e_log, n_compaction_events]
        self.consumed = []
        v_blocks, e_blocks = [], []   # (cb, db, create_view, delete_view)
        v_sh, v_sl, e_sh, e_sl = [], [], [], []
        v_gid_parts, e_src_parts, e_dst_parts = [], [], []
        for si, cols in enumerate(self.shard_cols):
            if cols is None:
                self.consumed.append([0, 0, 0, 0, 0])
                continue
            nv, ne = cols.n_v, cols.n_e
            self.consumed.append([nv, ne, len(cols.v_patch),
                                  len(cols.e_patch),
                                  cols.events_dropped + len(cols.events)])
            if nv:
                cv, dv = cols.v_create.view(), cols.v_delete.view()
                cb, db = self._eval(cv, dv,
                                    cols.v_create_stamp.__getitem__,
                                    cols.v_delete_stamp.__getitem__,
                                    q, at, refine, pend,
                                    pre=None if mk is None
                                    else mk[id(cols)][0:2])
                v_blocks.append((cb, db, cv, dv))
                v_sh.append(np.full(nv, si, np.int32))
                v_sl.append(np.arange(nv, dtype=np.int32))
                v_gid_parts.append(cols.v_gid.view().copy())
            if ne:
                ce, de = cols.e_create.view(), cols.e_delete.view()
                cb, db = self._eval(ce, de,
                                    cols.e_create_stamp.__getitem__,
                                    cols.e_delete_stamp.__getitem__,
                                    q, at, refine, pend,
                                    pre=None if mk is None
                                    else mk[id(cols)][2:4])
                e_blocks.append((cb, db, ce, de))
                e_sh.append(np.full(ne, si, np.int32))
                e_sl.append(np.arange(ne, dtype=np.int32))
                e_src_parts.append(cols.e_src.view().copy())
                e_dst_parts.append(cols.e_dst.view().copy())
        self._resolve(pend, at)   # patches the per-block cb/db in place

        def cat(parts, dtype=np.int32):
            return (np.concatenate(parts) if parts
                    else np.zeros((0,), dtype))

        self._g = {
            "v_shard": _GrowArr(cat(v_sh)),
            "v_slot": _GrowArr(cat(v_sl)),
            "V_gid": _GrowArr(cat(v_gid_parts)),
            "e_shard": _GrowArr(cat(e_sh)),
            "e_slot": _GrowArr(cat(e_sl)),
            "E_srcg": _GrowArr(cat(e_src_parts)),
            "E_dstg": _GrowArr(cat(e_dst_parts)),
            "v_vis": _GrowArr(cat([b[0] & ~b[1] for b in v_blocks],
                                  bool).astype(bool)),
            "e_vis": _GrowArr(cat([b[0] & ~b[1] for b in e_blocks],
                                  bool).astype(bool)),
        }
        self._refresh_views()
        self.v_unsettled = np.nonzero(cat(
            [self._unsettled(b[2], b[3], b[0], b[1]) for b in v_blocks],
            bool).astype(bool))[0].astype(np.int64)
        self.e_unsettled = np.nonzero(cat(
            [self._unsettled(b[2], b[3], b[0], b[1]) for b in e_blocks],
            bool).astype(bool))[0].astype(np.int64)

        # vertex compaction: visible rows in row order
        intern = self.weaver.intern
        self.vid_index = np.full(max(len(intern), 1), -1, np.int32)
        vis_gids = self.V_gid[self.v_vis]
        self.vid_index[vis_gids] = np.arange(vis_gids.size, dtype=np.int32)
        iv = intern.vids
        self.vids = [iv[g] for g in vis_gids.tolist()]
        self.index = {vid: i for i, vid in enumerate(self.vids)}

        # per-shard slot -> global row maps (cold layout is contiguous)
        self.v_slot2row, self.e_slot2row = [], []
        v_off = e_off = 0
        for si, cols in enumerate(self.shard_cols):
            nv = cols.n_v if cols is not None else 0
            ne = cols.n_e if cols is not None else 0
            self.v_slot2row.append(np.arange(v_off, v_off + nv))
            self.e_slot2row.append(np.arange(e_off, e_off + ne))
            v_off += nv
            e_off += ne

        # edge compaction + CSR/CSC sort (the int64 keys ARE the edge
        # lists: src/dst indices live in the two 32-bit halves)
        f0 = (self.e_vis
              & (self.vid_index[self.E_srcg] >= 0)
              & (self.vid_index[self.E_dstg] >= 0)) \
            if self.e_vis.size else np.zeros((0,), bool)
        self._g["f_mask"] = _GrowArr(f0)
        self.f_mask = self._g["f_mask"].view()
        src_idx = self.vid_index[self.E_srcg[self.f_mask]]
        dst_idx = self.vid_index[self.E_dstg[self.f_mask]]
        self.csr_key = np.sort(_sort_key(src_idx, dst_idx))
        self.csc_key = np.sort(_sort_key(dst_idx, src_idx))

        self.at = at
        self.refine = refine
        self._valid = True
        self._vids_copy = None    # a rebuild may change vids at same len
        self._vids_ver = 0        # bumped on every vids mutation
        self.stats["cold"] += 1
        self._make_ga()

    def _refresh_views(self) -> None:
        """Re-point the plain-array attributes at their grow buffers."""
        for name, g in self._g.items():
            setattr(self, name, g.view())

    def _gather_v(self, rows: np.ndarray):
        """(create, delete, cstamp, dstamp) for a set of global v rows."""
        return self._gather(rows, self.v_shard, self.v_slot, "v")

    def _gather_e(self, rows: np.ndarray):
        return self._gather(rows, self.e_shard, self.e_slot, "e")

    def _gather(self, rows, shard_of, slot_of, kind: str):
        create = np.empty((rows.size, self.c), np.int32)
        delete = np.empty((rows.size, self.c), np.int32)
        sh = shard_of[rows]
        sl = slot_of[rows]
        # slots dropped by a compaction gather as all-NO_STAMP (the row
        # can never be visible again)
        dead = sl < 0
        if dead.any():
            create[dead] = NO_STAMP
            delete[dead] = NO_STAMP
        for si in np.unique(sh[~dead]) if dead.any() else np.unique(sh):
            cols = self.shard_cols[si]
            m = (sh == si) & ~dead
            slots = sl[m]
            if kind == "v":
                create[m] = cols.v_create.view()[slots]
                delete[m] = cols.v_delete.view()[slots]
            else:
                create[m] = cols.e_create.view()[slots]
                delete[m] = cols.e_delete.view()[slots]

        def _stamp_of(which: int):
            def f(i: int) -> Optional[Stamp]:
                if sl[i] < 0:
                    return None
                cols = self.shard_cols[sh[i]]
                lists = ((cols.v_create_stamp, cols.v_delete_stamp)
                         if kind == "v"
                         else (cols.e_create_stamp, cols.e_delete_stamp))
                return lists[which][sl[i]]
            return f

        return create, delete, _stamp_of(0), _stamp_of(1)

    def _consume_compactions(self, si: int, cols, ch_v, ch_e):
        """Catch up with column compactions of shard ``si``.

        For every unseen :class:`~repro_torch.core.mvgraph.CompactionEvent`:
        recover the unread tail of the pre-compaction patch logs (those
        rows must still be re-evaluated), then remap the engine's cached
        slot pointers and ``slot2row`` maps to the new numbering.
        Dropped slots become -1 and gather as all-``NO_STAMP``.  Returns
        the consumed-state cursor in post-compaction numbering."""
        nv0, ne0, lv0, le0, ev0 = self.consumed[si]
        for ev in cols.events[ev0 - cols.events_dropped:]:
            # (a) unread patch tail, old numbering -> engine global rows
            tail_v = patch_tail(ev.old_v_patch, lv0, nv0)
            if tail_v.size:
                ch_v.append(self.v_slot2row[si][tail_v])
            tail_e = patch_tail(ev.old_e_patch, le0, ne0)
            if tail_e.size:
                ch_e.append(self.e_slot2row[si][tail_e])
            # (b) remap cached slot pointers of this shard's rows
            for shard_of, slot_of, s2r, smap, n0 in (
                    (self.v_shard, self.v_slot, self.v_slot2row, ev.v_map,
                     nv0),
                    (self.e_shard, self.e_slot, self.e_slot2row, ev.e_map,
                     ne0)):
                mrows = np.nonzero(shard_of == si)[0]
                if mrows.size:
                    slot_of[mrows] = remap_slots(
                        smap, slot_of[mrows]).astype(np.int32)
                old_s2r = s2r[si]
                nmap = smap[:n0]
                keep = nmap >= 0
                new_s2r = np.empty(int(keep.sum()), old_s2r.dtype)
                new_s2r[nmap[keep]] = old_s2r[keep]
                s2r[si] = new_s2r
            nv0 = int((ev.v_map[:nv0] >= 0).sum())
            ne0 = int((ev.e_map[:ne0] >= 0).sum())
            lv0 = le0 = 0
        return nv0, ne0, lv0, le0

    # --------------------------------------------------------------- delta
    def _delta_ok(self, at: Stamp, refine: bool) -> bool:
        if not self._valid or refine != self.refine:
            return False
        shards = self._shards()
        if self._signature(shards) != self.sig:
            return False
        # compaction history must still cover our consume point (events
        # beyond MAX_COMPACTION_EVENTS are dropped)
        for si, cols in enumerate(self.shard_cols):
            if cols is not None and self.consumed[si][4] < cols.events_dropped:
                return False
        o = compare(self.at, at)
        return o is Order.BEFORE or o is Order.EQUAL

    def _consume_changes(self):
        """Append new rows, return (changed_v_rows, changed_e_rows).

        All appends across shards are batched into ONE concatenate per
        global array per refresh (per-shard concats would re-copy the
        full arrays S times).
        """
        ch_v, ch_e = [], []
        v_app, e_app = [], []   # (si, gid part) / (si, src part, dst part)
        for si, cols in enumerate(self.shard_cols):
            if cols is None:
                continue
            if cols.events_dropped + len(cols.events) > self.consumed[si][4]:
                nv0, ne0, lv0, le0 = self._consume_compactions(
                    si, cols, ch_v, ch_e)
            else:
                nv0, ne0, lv0, le0 = self.consumed[si][:4]
            nv, ne = cols.n_v, cols.n_e
            if nv > nv0:
                v_app.append((si, cols.v_gid.view()[nv0:nv].copy()))
            if ne > ne0:
                e_app.append((si, cols.e_src.view()[ne0:ne].copy(),
                              cols.e_dst.view()[ne0:ne].copy()))
            if len(cols.v_patch) > lv0:
                slots = np.unique(np.asarray(cols.v_patch[lv0:], np.int64))
                slots = slots[slots < nv0]   # patches to new slots ride
                if slots.size:               # along with the append batch
                    ch_v.append(self.v_slot2row[si][slots])
            if len(cols.e_patch) > le0:
                slots = np.unique(np.asarray(cols.e_patch[le0:], np.int64))
                slots = slots[slots < ne0]
                if slots.size:
                    ch_e.append(self.e_slot2row[si][slots])
            self.consumed[si] = [nv, ne, len(cols.v_patch),
                                 len(cols.e_patch),
                                 cols.events_dropped + len(cols.events)]
        app_v = sum(p[1].size for p in v_app)
        app_e = sum(p[1].size for p in e_app)
        g = self._g
        if app_v:
            base = self.v_shard.size
            off = base
            for si, gids in v_app:
                self.v_slot2row[si] = np.concatenate(
                    [self.v_slot2row[si],
                     np.arange(off, off + gids.size)])
                off += gids.size
                nv = self.consumed[si][0]
                g["v_shard"].extend(np.full(gids.size, si, np.int32))
                g["v_slot"].extend(np.arange(nv - gids.size, nv,
                                             dtype=np.int32))
                g["V_gid"].extend(gids)
            g["v_vis"].extend(np.zeros(app_v, bool))
            ch_v.append(np.arange(base, base + app_v))
        if app_e:
            base = self.e_shard.size
            off = base
            for si, srcs, dsts in e_app:
                self.e_slot2row[si] = np.concatenate(
                    [self.e_slot2row[si],
                     np.arange(off, off + srcs.size)])
                off += srcs.size
                ne = self.consumed[si][1]
                g["e_shard"].extend(np.full(srcs.size, si, np.int32))
                g["e_slot"].extend(np.arange(ne - srcs.size, ne,
                                             dtype=np.int32))
                g["E_srcg"].extend(srcs)
                g["E_dstg"].extend(dsts)
            g["e_vis"].extend(np.zeros(app_e, bool))
            g["f_mask"].extend(np.zeros(app_e, bool))
            ch_e.append(np.arange(base, base + app_e))
        if app_v or app_e:
            self._refresh_views()
        cat = lambda parts: (np.unique(np.concatenate(parts))
                             if parts else np.zeros((0,), np.int64))
        return cat(ch_v), cat(ch_e), app_v, app_e

    def _refresh(self, at: Stamp, refine: bool) -> None:
        q = clock.pack(at, self.n_gk)
        if self.plane is not None:
            # residency stays O(changed); the gathered subset below is
            # evaluated by its own _before_batch launch (delta sets are
            # tiny by contract and the masks are bit-identical either way)
            self.plane.sync(self.shard_cols)
        ch_v, ch_e, app_v, app_e = self._consume_changes()
        ids_v = np.union1d(ch_v, self.v_unsettled).astype(np.int64)
        ids_e = np.union1d(ch_e, self.e_unsettled).astype(np.int64)
        if ids_v.size == 0 and ids_e.size == 0:
            self.at = at
            self.stats["delta_noop"] += 1
            return
        # fresh vids may have been interned (e.g. endpoints of appended
        # edges) — the index arrays must cover them before any gather
        intern = self.weaver.intern
        if len(intern) > self.vid_index.size:
            self.vid_index = np.concatenate(
                [self.vid_index,
                 np.full(len(intern) - self.vid_index.size, -1, np.int32)])

        pend: List[tuple] = []
        vc, vd, vcs, vds = self._gather_v(ids_v)
        v_cb, v_db = self._eval(vc, vd, vcs, vds, q, at, refine, pend)
        ec, ed, ecs, eds = self._gather_e(ids_e)
        e_cb, e_db = self._eval(ec, ed, ecs, eds, q, at, refine, pend)
        self._resolve(pend, at)

        new_v = v_cb & ~v_db
        old_v = self.v_vis[ids_v]
        self.v_vis[ids_v] = new_v
        self.v_unsettled = ids_v[self._unsettled(vc, vd, v_cb, v_db)]
        flip_off = ids_v[old_v & ~new_v]
        if flip_off.size > max(32, len(self.vids) // 4):
            # bulk disappearance: per-vertex key patching would cost
            # O(drops x E) — a cold rebuild is cheaper
            self._cold(at, refine)
            return
        if flip_off.size:
            # vertex-delete delta path: tombstone + backfill, O(changed)
            self._drop_vertices(flip_off)
        flipped_v = ids_v[new_v & ~old_v]
        if flipped_v.size:
            flipped_v = np.sort(flipped_v)
            gids = self.V_gid[flipped_v]
            start = len(self.vids)
            self.vid_index[gids] = np.arange(
                start, start + gids.size, dtype=np.int32)
            for g in gids.tolist():
                vid = intern.vids[g]
                self.index[vid] = len(self.vids)
                self.vids.append(vid)
            self._vids_ver += 1

        old_e = self.e_vis[ids_e]
        new_e = e_cb & ~e_db
        self.e_vis[ids_e] = new_e
        self.e_unsettled = ids_e[self._unsettled(ec, ed, e_cb, e_db)]

        # final-mask recompute set: evaluated edges + edges that touch a
        # newly visible vertex (vectorized membership scan, flips are rare)
        f_rows = ids_e
        if flipped_v.size:
            gset = self.V_gid[flipped_v]
            touch = np.nonzero(np.isin(self.E_srcg, gset)
                               | np.isin(self.E_dstg, gset))[0]
            f_rows = np.union1d(f_rows, touch)
        v_changed = bool(flipped_v.size or flip_off.size)
        if f_rows.size == 0 and not v_changed:
            self.at = at
            self.stats["delta_noop"] += 1
            return
        new_f = (self.e_vis[f_rows]
                 & (self.vid_index[self.E_srcg[f_rows]] >= 0)
                 & (self.vid_index[self.E_dstg[f_rows]] >= 0))
        old_f = self.f_mask[f_rows]
        self.f_mask[f_rows] = new_f
        added = f_rows[new_f & ~old_f]
        removed = f_rows[old_f & ~new_f]
        if added.size or removed.size:
            a_src = self.vid_index[self.E_srcg[added]]
            a_dst = self.vid_index[self.E_dstg[added]]
            r_src = self.vid_index[self.E_srcg[removed]]
            r_dst = self.vid_index[self.E_dstg[removed]]
            self.csr_key = _merge_patch(self.csr_key,
                                        _sort_key(r_src, r_dst),
                                        _sort_key(a_src, a_dst))
            self.csc_key = _merge_patch(self.csc_key,
                                        _sort_key(r_dst, r_src),
                                        _sort_key(a_dst, a_src))
        self.at = at
        self.stats["delta"] += 1
        if added.size or removed.size or v_changed:
            self._make_ga()

    def _drop_vertices(self, rows: np.ndarray) -> None:
        """Remove newly-invisible vertices from the compacted index.

        Per dropped vertex: delete its incident CSR/CSC keys, tombstone
        its ``vid_index`` slot, and backfill the freed snapshot index
        with the (previously) last vertex, re-keying only the edges
        incident to that one vertex — O(deg) key patches plus a
        vectorized membership scan, instead of a cold rebuild."""
        intern = self.weaver.intern
        none = np.zeros(0, np.int64)
        # one membership pass for ALL dropped gids; the per-vertex scans
        # below then touch only these candidate rows
        dead_gids = self.V_gid[rows]
        cand = np.nonzero((np.isin(self.E_srcg, dead_gids)
                           | np.isin(self.E_dstg, dead_gids))
                          & self.f_mask)[0]
        for row in rows.tolist():
            g_dead = int(self.V_gid[row])
            iu = int(self.vid_index[g_dead])
            if iu < 0:       # several rows may share a gid (re-creates)
                continue
            inc = cand[((self.E_srcg[cand] == g_dead)
                        | (self.E_dstg[cand] == g_dead))
                       & self.f_mask[cand]]
            if inc.size:
                r_src = self.vid_index[self.E_srcg[inc]]
                r_dst = self.vid_index[self.E_dstg[inc]]
                self.csr_key = _merge_patch(self.csr_key,
                                            _sort_key(r_src, r_dst), none)
                self.csc_key = _merge_patch(self.csc_key,
                                            _sort_key(r_dst, r_src), none)
                self.f_mask[inc] = False
            il = len(self.vids) - 1
            dead_vid = self.vids[iu]
            if iu != il:
                last_vid = self.vids[il]
                g_last = intern.ids[last_vid]
                minc = np.nonzero(((self.E_srcg == g_last)
                                   | (self.E_dstg == g_last))
                                  & self.f_mask)[0]
                if minc.size:       # re-key the backfilled vertex's edges
                    rm_csr = _sort_key(self.vid_index[self.E_srcg[minc]],
                                       self.vid_index[self.E_dstg[minc]])
                    rm_csc = _sort_key(self.vid_index[self.E_dstg[minc]],
                                       self.vid_index[self.E_srcg[minc]])
                self.vid_index[g_last] = iu
                self.vids[iu] = last_vid
                self.index[last_vid] = iu
                if minc.size:
                    a_src = self.vid_index[self.E_srcg[minc]]
                    a_dst = self.vid_index[self.E_dstg[minc]]
                    self.csr_key = _merge_patch(self.csr_key, rm_csr,
                                                _sort_key(a_src, a_dst))
                    self.csc_key = _merge_patch(self.csc_key, rm_csc,
                                                _sort_key(a_dst, a_src))
            self.vids.pop()
            del self.index[dead_vid]
            self.vid_index[g_dead] = -1
            self._vids_ver += 1

    # ----------------------------------------------------- property columns
    def _visible_prop_rows(self, pt, q: np.ndarray, kid: int) -> np.ndarray:
        """Row ids of property versions with the right key, visible at the
        engine stamp (concurrent stamps refined in ONE oracle pass)."""
        if pt.n == 0 or kid < 0:
            return np.zeros(0, np.int64)
        krows = np.nonzero(pt.key.view() == kid)[0]
        if krows.size == 0:
            return krows
        rows = pt.stamp.view()[krows]
        cb = _before_batch(rows, q, self.device)
        if self.refine:
            pend: List[tuple] = []
            for i in np.nonzero(clock.concurrent_mask_np(rows, q))[0]:
                s = pt.stamp_obj[int(krows[i])]
                if s is not None and compare(s, self.at) is Order.CONCURRENT:
                    pend.append((cb, i, s))
            self._resolve(pend, self.at)
        return krows[cb]

    def vertex_prop_column(self, key: str):
        """Latest-visible value of vertex property ``key`` per snapshot
        index: returns ``(values, num)`` where ``values`` is a list of
        Python objects (None = absent) of length ``n_nodes`` and ``num``
        the float64 mirror (NaN = absent or non-numeric).

        Served straight from the columnar property tables at the
        engine's current stamp; version order within an owner follows
        append order (the transaction pipeline's last-update validation
        guarantees commit order == append order per object)."""
        assert self._valid, "snapshot() first"
        q = clock.pack(self.at, self.n_gk)
        n = len(self.vids)
        values: List[object] = [None] * n
        num = np.full(n, np.nan)
        for cols in self.shard_cols:
            if cols is None:
                continue
            pt = cols.v_props
            vis = self._visible_prop_rows(pt, q, cols.keys.lookup(key))
            if vis.size == 0:
                continue
            owners = pt.owner.view()[vis]
            idx = self.vid_index[cols.v_gid.view()[owners]]
            ok = idx >= 0
            vals_l = pt.val.view()[vis]
            num_l = pt.num.view()[vis]
            # ascending row order == version order: later rows overwrite
            for r, i in zip(np.nonzero(ok)[0].tolist(), idx[ok].tolist()):
                values[i] = cols.vals.vals[int(vals_l[r])]
                num[i] = num_l[r]
        return values, num

    def edge_prop_rows(self, key: str) -> Dict[int, object]:
        """Latest-visible value of edge property ``key`` keyed by GLOBAL
        edge row id (align with ``e_shard``/``e_slot`` or the raw rows of
        a ``keep_raw`` snapshot)."""
        assert self._valid, "snapshot() first"
        q = clock.pack(self.at, self.n_gk)
        out: Dict[int, object] = {}
        for si, cols in enumerate(self.shard_cols):
            if cols is None:
                continue
            pt = cols.e_props
            vis = self._visible_prop_rows(pt, q, cols.keys.lookup(key))
            if vis.size == 0:
                continue
            owners = pt.owner.view()[vis]
            rows = self.e_slot2row[si]
            vals_l = pt.val.view()[vis]
            for r, o in enumerate(owners.tolist()):
                if o < rows.size:
                    out[int(rows[o])] = cols.vals.vals[int(vals_l[r])]
        return out

    # ------------------------------------------------------------- results
    def _make_ga(self) -> None:
        n = len(self.vids)
        edge_src, edge_dst = _key_halves(self.csr_key)
        self.ga = GraphArrays(
            vids=self.vids, index=self.index,
            edge_src=edge_src, edge_dst=edge_dst, n_nodes=n,
            _csc_key=self.csc_key)

    def _attach_raw(self, ga: GraphArrays) -> GraphArrays:
        """Raw (pre-edge-filter) stamp rows for visible-endpoint edges."""
        m = ((self.vid_index[self.E_srcg] >= 0)
             & (self.vid_index[self.E_dstg] >= 0)) \
            if self.E_srcg.size else np.zeros((0,), bool)
        rows = np.nonzero(m)[0]
        create, delete, _, _ = self._gather_e(rows)
        ga.raw_src = self.vid_index[self.E_srcg[rows]]
        ga.raw_dst = self.vid_index[self.E_dstg[rows]]
        ga.edge_create = create
        ga.edge_delete = delete
        return ga

    def snapshot(self, at: Stamp, refine_concurrent: bool = True,
                 keep_raw: bool = False) -> GraphArrays:
        if self._delta_ok(at, refine_concurrent):
            self._refresh(at, refine_concurrent)
        else:
            self._cold(at, refine_concurrent)
        # vids/index are snapshotted by copy (later deltas mutate the
        # engine's structures, which would leak future vertices into an
        # older snapshot); the copies are cached until the vertex set
        # changes (a version counter — deletes can keep the length
        # constant), so edge-only delta chains never re-copy
        if getattr(self, "_vids_copy", None) is None \
                or self._copied_ver != self._vids_ver:
            self._vids_copy = list(self.vids)
            self._index_copy = dict(self.index)
            self._copied_ver = self._vids_ver
        ga = GraphArrays(
            vids=self._vids_copy, index=self._index_copy,
            edge_src=self.ga.edge_src, edge_dst=self.ga.edge_dst,
            n_nodes=self.ga.n_nodes, _csc_key=self.ga._csc_key,
            _csc=self.ga._csc, _indptr=self.ga._indptr)
        if keep_raw:
            self._attach_raw(ga)
        return ga


def snapshot_arrays(weaver, at: Stamp, refine_concurrent: bool = True,
                    keep_raw: bool = False) -> GraphArrays:
    """Materialize the snapshot at ``at`` from every shard partition.

    Served by the per-Weaver :class:`SnapshotEngine` (columnar, cached);
    see the module docstring for the ordering contract.  The legacy
    per-object path survives as :func:`snapshot_arrays_python` for
    equivalence testing and benchmarking.
    """
    eng = getattr(weaver, "_snapshot_engine", None)
    if eng is None:
        eng = SnapshotEngine(weaver)
        weaver._snapshot_engine = eng
    return eng.snapshot(at, refine_concurrent, keep_raw)


def snapshot_arrays_python(weaver, at: Stamp, refine_concurrent: bool = True,
                           keep_raw: bool = False) -> GraphArrays:
    """Seed reference implementation: per-vertex/per-edge Python loops with
    per-stamp ``compare`` calls.  O(V+E) interpreter work per query —
    kept as the semantic oracle for the columnar engine."""
    n_gk = weaver.cfg.n_gatekeepers
    oracle = weaver.oracle.oracle

    def _refine(a: Stamp, b: Stamp) -> Order:
        if not refine_concurrent:
            # conservative defaults (see clock.visibility_mask_np)
            return Order.AFTER
        chain = oracle.order_events([a, b], [KIND_TX, KIND_PROG])
        weaver.sim.counters.oracle_calls += 1
        return Order.BEFORE if chain[0] == a.key() else Order.AFTER

    def _vis(create_ts: Stamp, delete_ts: Optional[Stamp]) -> bool:
        o = compare(create_ts, at)
        if o is Order.CONCURRENT:
            o = _refine(create_ts, at)
        if o is not Order.BEFORE:
            return False
        if delete_ts is not None:
            o = compare(delete_ts, at)
            if o is Order.CONCURRENT:
                o = _refine(delete_ts, at)
            if o is Order.BEFORE:
                return False
        return True

    vids: List[str] = []
    index: dict = {}
    edges: List[Tuple[str, str]] = []
    raw: List[Tuple[str, str, Stamp, Optional[Stamp]]] = []
    for sh in weaver.shards:
        if not sh.alive:
            continue
        for vid, v in sh.partition.vertices.items():
            if _vis(v.create_ts, v.delete_ts):
                if vid not in index:
                    index[vid] = len(vids)
                    vids.append(vid)
    for sh in weaver.shards:
        if not sh.alive:
            continue
        for vid, v in sh.partition.vertices.items():
            if vid not in index:
                continue
            for e in v.out_edges.values():
                if keep_raw:
                    raw.append((vid, e.dst, e.create_ts, e.delete_ts))
                if e.dst in index and _vis(e.create_ts, e.delete_ts):
                    edges.append((vid, e.dst))

    src = np.asarray([index[s] for s, _ in edges], dtype=np.int32)
    dst = np.asarray([index[d] for _, d in edges], dtype=np.int32)
    ga = GraphArrays(vids=vids, index=index, edge_src=src, edge_dst=dst,
                     n_nodes=len(vids))
    if keep_raw:
        keep = [(s, d, c, x) for (s, d, c, x) in raw
                if s in index and d in index]
        ga.raw_src = np.asarray([index[s] for s, _, _, _ in keep], np.int32)
        ga.raw_dst = np.asarray([index[d] for _, d, _, _ in keep], np.int32)
        ga.edge_create = clock.pack_many([c for _, _, c, _ in keep], n_gk)
        ga.edge_delete = clock.pack_many([x for _, _, _, x in keep], n_gk)
    return ga


# ---------------------------------------------------------------------------
# Frontier traversals over snapshot arrays, as torch loops on the arguments'
# device (the reference's jitted ``while_loop`` / ``fori_loop`` bodies).
# ---------------------------------------------------------------------------

def _tensor(a, device=None, dtype=None) -> torch.Tensor:
    """``a`` as a tensor: a tensor stays on its device unless ``device``
    is given; anything else (numpy, a list) goes to ``device`` or the
    CPU."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device if device is not None else a.device,
                    dtype=dtype)
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def _segment_reduce(values: torch.Tensor, segments: torch.Tensor, n: int,
                    op: str) -> torch.Tensor:
    """``jax.ops.segment_min`` (``op="amin"``) / ``segment_sum``
    (``"sum"``) of 1-D ``values``: an empty segment gets jax's identity,
    the dtype's largest value (+inf for floats) for min and 0 for sum.
    jax's ``indices_are_sorted`` hint has no counterpart here."""
    if op == "sum":
        return values.new_zeros(n).index_add_(0, segments, values)
    fill = (float("inf") if values.dtype.is_floating_point
            else torch.iinfo(values.dtype).max)
    return values.new_full((n,), fill).scatter_reduce_(
        0, segments, values, op, include_self=False)


def bfs_levels(edge_src, edge_dst, n_nodes: int, sources,
               max_iters: Optional[int] = None,
               dst_sorted: bool = False) -> torch.Tensor:
    """BFS level per node (INF = unreachable) via frontier relaxation, on
    ``edge_src``'s device.  Relaxes until a round changes nothing, at
    most ``max_iters`` rounds (default ``n_nodes``); the ``changed`` flag
    stays on the device and is read once per round.  The rounds are
    ``kernels.bfs_round``'s: on a card one launch of its CUDA kernel a
    round over int32 indices (int64 ones are narrowed once a call), on
    the CPU the plain round over int64 indices; the levels ping-pong
    between two buffers.  ``dst_sorted`` is the reference's sortedness
    hint: accepted, not needed (the kernel is right in any edge order;
    sorted edges only make its runs long).

    Spans (``obs.device_span``): ``analytics.bfs_levels`` around the
    call and ``.prepare`` around the set-up (a round's read of the flag
    is the profiler's own ``aten::item`` range); counters
    (``obs.DATA_PLANE``): ``analytics.bfs_levels.rounds`` and ``.syncs``
    (device-to-host reads, counted at the read)."""
    with obs.device_span("analytics.bfs_levels"):
        with obs.device_span("analytics.bfs_levels.prepare"):
            src = _tensor(edge_src)
            dev = src.device
            dst = _tensor(edge_dst, dev)
            if src.is_cuda:             # Rounds refuses N >= 2**31 here
                src = src.to(torch.int32).contiguous()
                dst = dst.to(torch.int32).contiguous()
            else:
                src, dst = src.long(), dst.long()
            if max_iters is None:
                max_iters = n_nodes
            state = bfs_round.Rounds(n_nodes,
                                     _tensor(sources, dev).long().reshape(-1))
        dist, rounds = _relax_rounds(state, src, dst, n_nodes, max_iters,
                                     "bfs_levels")
    obs.DATA_PLANE.count("analytics.bfs_levels.rounds", rounds)
    obs.DATA_PLANE.count("analytics.bfs_levels.syncs", rounds)
    return dist


def _relax_rounds(state: bfs_round.Rounds, src: torch.Tensor,
                  dst: torch.Tensor, n_nodes: int, max_iters: int,
                  caller: str, bits: Optional[torch.Tensor] = None):
    """``(levels, rounds)``: ``state``'s rounds over the edges (with
    ``bits``, the visible ones) until one changes nothing, at most
    ``max_iters``; each round's flag is read once (one sync a round)."""
    dist = state.levels[0]
    rounds = 0
    for r in range(max_iters):
        rounds += 1
        dist = state.relax(src, dst, r, bits)
        flag = state.flags[r & 1].item()
        if flag & bfs_round.kernel.BAD_INDEX:
            raise ValueError(f"{caller}: an edge's end or a source lies "
                             f"outside [0, {n_nodes})")
        if not flag:
            break
    return dist, rounds


def bfs_levels_ga(ga: GraphArrays, sources, max_iters: Optional[int] = None,
                  device: str = "cuda") -> torch.Tensor:
    """BFS over a columnar snapshot on ``device`` (CSC orientation)."""
    check_device(device)
    return bfs_levels(_tensor(ga.csc_src, device), _tensor(ga.csc_dst, device),
                      ga.n_nodes, _tensor(sources, device), max_iters,
                      dst_sorted=True)


def bfs_levels_at(table: EdgeVersionTable, at: Stamp, sources, oracle,
                  max_iters: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """BFS levels from ``sources`` over the edge versions of ``table``
    visible at the refinable timestamp ``at``, on the table's device;
    returns ``(levels, bits)``: the int32 levels (INF = unreachable) and
    the visibility of each row at ``at`` after refinement, as
    (ceil(N / 32),) int32 words (bit k = row k, least significant first).

    1. One launch of the ``mv_visibility`` kernel's residue mode: a
       visible bit a row (create ≺ at and not delete ≺ at) into a device
       buffer, and the rows whose create or delete stamp is concurrent
       with ``at``.
    2. One device-to-host read of that residue.
    3. Where it is not empty, ONE ``oracle.order_events`` request over its
       unique concurrent Stamps (``table.recent``) plus ``at``, with the
       node-program rule as ``SnapshotEngine._resolve`` uses it: a
       concurrent write the oracle has not ordered goes before the query.
    4. The bits of the refined rows patched on the device.
    5. The BFS rounds over the table's rows, each one launch of the
       masked ``bfs_round`` kernel that skips invisible rows (on the CPU,
       the plain round over the visible rows); the flag is read once a
       round.

    Nothing of the table is copied: no per-query copy of the edge arrays
    and no host copy of the bits.  The query's oracle events stay until
    the deployment's GC collects them (``oracle.collect`` at a horizon
    that every gatekeeper has announced past; the query's own stamp is
    not such a horizon while other gatekeepers may still hand out stamps
    concurrent with it).

    Spans (``obs.device_span``): ``analytics.bfs_levels_at`` around the
    call, ``.visibility`` around the launch and ``.refine`` around the
    read, the oracle request and the patch.  Counters
    (``obs.DATA_PLANE``, under ``analytics.bfs_levels_at.``): ``rows``,
    ``concurrent_rows``, ``oracle_stamps`` (unique Stamps sent),
    ``oracle_requests`` and ``rounds``."""
    with obs.device_span("analytics.bfs_levels_at"):
        dev = table.device
        q = torch.from_numpy(clock.pack(at, table.n_gk)).to(dev)
        with obs.device_span("analytics.bfs_levels_at.visibility"):
            bits, res = mv_ops.visibility_residue(table.create_rows,
                                                  table.delete_rows, q)
        with obs.device_span("analytics.bfs_levels_at.refine"):
            try:
                entries = mv_ops.read_residue(res)
            except mv_ops.ResidueOverflow as full:    # a second launch
                bits, res = mv_ops.visibility_residue(
                    table.create_rows, table.delete_rows, q,
                    mv_ops.residue_buffer(dev, full.count))
                entries = mv_ops.read_residue(res)
            n_stamps = _refine_residue(table, entries, at, oracle, bits)
        if max_iters is None:
            max_iters = table.n_nodes
        state = bfs_round.Rounds(table.n_nodes,
                                 _tensor(sources, dev).long().reshape(-1))
        dist, rounds = _relax_rounds(state, table.src, table.dst,
                                     table.n_nodes, max_iters,
                                     "bfs_levels_at", bits)
    name = "analytics.bfs_levels_at."
    obs.DATA_PLANE.count(name + "rows", table.n)
    obs.DATA_PLANE.count(name + "concurrent_rows", len(entries))
    obs.DATA_PLANE.count(name + "oracle_stamps", n_stamps)
    obs.DATA_PLANE.count(name + "oracle_requests", int(n_stamps > 0))
    obs.DATA_PLANE.count(name + "rounds", rounds)
    return dist, bits


def _refine_residue(table: EdgeVersionTable, entries: np.ndarray, at: Stamp,
                    oracle, bits: torch.Tensor) -> int:
    """Settle the residue rows' visibility through the oracle and patch
    ``bits`` where it changes; returns the unique Stamps sent (0: no
    request).  A residue side whose Stamp the table no longer keeps
    breaks the table's rule (only rows written since the last announce
    can be concurrent) and raises."""
    mvk = mv_ops.kernel                 # the residue entries' flag bits
    rows = entries >> mvk.FLAG_BITS
    before = np.stack([entries & mvk.CREATE_BEFORE,
                       entries & mvk.DELETE_BEFORE], 1) > 0
    conc = np.stack([entries & mvk.CREATE_CONC,
                     entries & mvk.DELETE_CONC], 1) > 0
    pend: List[tuple] = []              # (residue index, side, Stamp)
    verdict: Dict[tuple, bool] = {}     # a Stamp's key: concurrent with at
    for i, side in zip(*np.nonzero(conc)):
        s = table.recent.get(int(rows[i]), (None, None))[side]
        if s is None:
            raise RuntimeError(
                f"row {rows[i]}'s {('create', 'delete')[side]} stamp is "
                f"concurrent with {at} but the table keeps no Stamp for it")
        c = verdict.get(s.key())
        if c is None:
            c = verdict[s.key()] = compare(s, at) is Order.CONCURRENT
        if c:
            pend.append((i, side, s))
    if not pend:
        return 0
    uniq: Dict[tuple, Stamp] = {}
    for _, _, s in pend:
        uniq[s.key()] = s
    stamps = list(uniq.values())
    chain = oracle.order_events(stamps + [at],
                                [KIND_TX] * len(stamps) + [KIND_PROG])
    pos = {k: j for j, k in enumerate(chain)}
    p_at = pos[at.key()]
    was = before[:, 0] & ~before[:, 1]
    for i, side, s in pend:
        before[i, side] = pos[s.key()] < p_at
    now = before[:, 0] & ~before[:, 1]
    moved = was != now
    rows = rows[moved]
    if rows.size:
        words, first = np.unique(rows >> 5, return_index=True)
        bit = np.left_shift(np.uint32(1), (rows & 31).astype(np.uint32))
        on = np.bitwise_or.reduceat(np.where(now[moved], bit, 0)
                                    .astype(np.uint32), first)
        hit = np.bitwise_or.reduceat(bit, first)
        patch = torch.from_numpy(np.stack([
            words, (~hit).view(np.int32), on.view(np.int32)]).astype(
                np.int64)).to(bits.device)
        w = patch[0]
        bits[w] = (bits[w] & patch[1].to(torch.int32)) \
            | patch[2].to(torch.int32)
    return len(stamps)


def reachable(edge_src, edge_dst, n_nodes: int, source: int,
              target: int) -> bool:
    lv = bfs_levels(edge_src, edge_dst, n_nodes, [source])
    return bool(lv[target] < int(INF))


def connected_components(edge_src, edge_dst, n_nodes: int,
                         max_iters: int = 64, src_sorted: bool = False,
                         dst_sorted: bool = False) -> torch.Tensor:
    """Undirected label propagation (min-label) on ``edge_src``'s device,
    until a round changes nothing, at most ``max_iters`` rounds; the
    sortedness hints are accepted, not needed."""
    src = _tensor(edge_src).long()
    dev = src.device
    dst = _tensor(edge_dst, dev).long()
    lab = torch.arange(n_nodes, dtype=torch.int32, device=dev)
    for _ in range(max_iters):
        fwd = _segment_reduce(lab[src], dst, n_nodes, "amin")
        bwd = _segment_reduce(lab[dst], src, n_nodes, "amin")
        nl = torch.minimum(lab, torch.minimum(fwd, bwd))
        changed = (nl != lab).any()
        lab = nl
        if not changed.item():
            break
    return lab


def connected_components_ga(ga: GraphArrays, max_iters: int = 64,
                            device: str = "cuda") -> torch.Tensor:
    """CC over a columnar snapshot on ``device`` (CSR orientation)."""
    check_device(device)
    return connected_components(_tensor(ga.edge_src, device),
                                _tensor(ga.edge_dst, device), ga.n_nodes,
                                max_iters, src_sorted=True)


def pagerank(edge_src, edge_dst, n_nodes: int, n_iters: int = 20,
             damping: float = 0.85, src_sorted: bool = False,
             dst_sorted: bool = False) -> torch.Tensor:
    """fp32 PageRank, ``n_iters`` rounds, out-degree clamped at 1, on
    ``edge_src``'s device.  On a card the sums go through atomics, so
    two runs may differ in the last bits.

    Spans: ``analytics.pagerank`` around the call, ``.prepare`` around
    the copies, the degree pass and the init; counter
    ``analytics.pagerank.rounds``."""
    with obs.device_span("analytics.pagerank"):
        with obs.device_span("analytics.pagerank.prepare"):
            src = _tensor(edge_src).long()
            dev = src.device
            dst = _tensor(edge_dst, dev).long()
            deg = _segment_reduce(torch.ones(src.shape, dtype=torch.float32,
                                             device=dev), src, n_nodes, "sum")
            deg = torch.clamp(deg, min=1.0)
            pr = torch.full((n_nodes,), 1.0 / n_nodes, dtype=torch.float32,
                            device=dev)
        for _ in range(n_iters):
            agg = _segment_reduce(pr[src] / deg[src], dst, n_nodes, "sum")
            pr = (1.0 - damping) / n_nodes + damping * agg
    obs.DATA_PLANE.count("analytics.pagerank.rounds", n_iters)
    return pr


def pagerank_ga(ga: GraphArrays, n_iters: int = 20, damping: float = 0.85,
                device: str = "cuda") -> torch.Tensor:
    """PageRank over a columnar snapshot on ``device`` (CSC
    orientation)."""
    check_device(device)
    return pagerank(_tensor(ga.csc_src, device), _tensor(ga.csc_dst, device),
                    ga.n_nodes, n_iters, damping, dst_sorted=True)


def sssp_weighted(edge_src, edge_dst, weights, n_nodes: int,
                  sources) -> torch.Tensor:
    """Bellman-Ford style label-correcting shortest path (fp32; 3.4e38 =
    unreachable) on ``edge_src``'s device.

    The reference runs ``n_nodes - 1`` rounds unconditionally; this stops
    at the first round that changes nothing.  A round is a function of
    the distances alone, so a fixpoint stays one and the result is the
    same array."""
    src = _tensor(edge_src).long()
    dev = src.device
    dst = _tensor(edge_dst, dev).long()
    w = _tensor(weights, dev, torch.float32)
    dist = torch.full((n_nodes,), 3.4e38, dtype=torch.float32, device=dev)
    dist[_tensor(sources, dev).long()] = 0.0
    for _ in range(n_nodes - 1 if n_nodes > 1 else 1):
        relaxed = _segment_reduce(dist[src] + w, dst, n_nodes, "amin")
        nd = torch.minimum(dist, relaxed)
        changed = (nd != dist).any()
        dist = nd
        if not changed.item():
            break
    return dist


def build_csr(edge_src: np.ndarray, edge_dst: np.ndarray, n_nodes: int,
              dedup: bool = False, drop_self_loops: bool = False):
    """Sorted-CSR build: returns (indptr, nbrs) with each row's
    neighbours ascending.  ``dedup`` collapses parallel edges."""
    src = np.asarray(edge_src, np.int64)
    dst = np.asarray(edge_dst, np.int64)
    if drop_self_loops:
        keep = src != dst
        src, dst = src[keep], dst[keep]
    key = (src << 32) | dst
    key = np.unique(key) if dedup else np.sort(key)
    src = (key >> 32).astype(np.int32)
    dst = (key & 0xFFFFFFFF).astype(np.int32)
    indptr = np.searchsorted(src, np.arange(n_nodes + 1)).astype(np.int64)
    return indptr, dst


def intersect_counts(a_lo: np.ndarray, a_hi: np.ndarray,
                     a_vals: np.ndarray, a_keys: np.ndarray,
                     a_pref: np.ndarray,
                     b_lo: np.ndarray, b_hi: np.ndarray,
                     b_vals: np.ndarray, b_keys: np.ndarray,
                     b_pref: np.ndarray) -> np.ndarray:
    """``|A_i ∩ B_i|`` per pair over two keyed ragged tables, enumerating
    the SMALLER side of each pair (min-degree-side intersection — robust
    to power-law hubs: Σ min(|A|,|B|) work).

    Each side is a set of sorted-unique rows inside a global value
    array: per pair ``i``, row A is ``a_vals[a_lo[i]:a_hi[i]]`` and its
    membership-probe target is ``a_keys``, the side's globally-ascending
    packed ``(row prefix << 32) | value`` array, with ``a_pref[i]`` the
    pair's row prefix in that key space (same for side B).  Enumerated
    values of the smaller row are probed against the larger side's key
    array with ONE global ``searchsorted`` per direction.

    Shared by :func:`clustering_coefficients_np` (both sides are rows of
    one snapshot CSR, prefix = node index) and the frontier runtime's
    wedge-closing phase (side A = the message's packed neighbour lists,
    prefix = ragged row; side B = the shard plan's dedup'd CSR slice,
    prefix = vertex gid).
    """
    la = a_hi - a_lo
    lb = b_hi - b_lo
    n = la.size
    counts = np.zeros(n, np.int64)
    for mask, (e_lo, e_len, e_vals), (p_keys, p_pref) in (
            (la <= lb, (a_lo, la, a_vals), (b_keys, b_pref)),
            (la > lb, (b_lo, lb, b_vals), (a_keys, a_pref))):
        sel = np.nonzero(mask)[0]
        if sel.size == 0:
            continue
        ln = e_len[sel]
        total = int(ln.sum())
        if total == 0 or p_keys.size == 0:
            continue
        off = np.repeat(np.cumsum(ln) - ln, ln)
        w = e_vals[np.arange(total, dtype=np.int64) - off
                   + np.repeat(e_lo[sel], ln)]
        pair = np.repeat(sel, ln)
        probe = (p_pref[pair].astype(np.int64) << 32) | w
        loc = np.minimum(np.searchsorted(p_keys, probe), p_keys.size - 1)
        hit = p_keys[loc] == probe
        counts += np.bincount(pair[hit], minlength=n)
    return counts


def clustering_coefficients_np(edge_src: np.ndarray, edge_dst: np.ndarray,
                               n_nodes: int) -> np.ndarray:
    """Exact local clustering coefficient over out-neighbourhoods (matches
    the ``clustering`` node program).

    Sorted-CSR numpy, fully edge-parallel: ``links[u] = Σ_{v∈N(u)}
    |N(v) ∩ N(u)|`` via :func:`intersect_counts` over the (already
    key-sorted) CSR — one pair per CSR edge ``(u, v)``, both rows living
    in the same CSR, no per-vertex Python loop, no O(deg²) set
    intersections.
    """
    indptr, nbrs = build_csr(edge_src, edge_dst, n_nodes, dedup=True,
                             drop_self_loops=True)
    lens = np.diff(indptr)
    if nbrs.size == 0:
        return np.zeros(n_nodes, dtype=np.float64)
    u_of_pos = np.repeat(np.arange(n_nodes, dtype=np.int64), lens)
    keys = (u_of_pos << 32) | nbrs                  # sorted (CSR order)
    v_of_pos = nbrs.astype(np.int64)
    hits = intersect_counts(
        indptr[v_of_pos], indptr[v_of_pos + 1], nbrs, keys, v_of_pos,
        indptr[u_of_pos], indptr[u_of_pos + 1], nbrs, keys, u_of_pos)
    links = np.bincount(u_of_pos, weights=hits,
                        minlength=n_nodes).astype(np.int64)
    k = lens.astype(np.float64)
    denom = np.maximum(k * (k - 1.0), 1.0)
    return np.where(lens >= 2, links / denom, 0.0)


#: elements of clustering_coefficients_padded's per-chunk (vertices,
#: max_deg, max_deg) intermediates (int64 positions: 512 MiB)
_CC_CHUNK_ELEMS = 1 << 26


def clustering_coefficients_padded(edge_src, edge_dst, n_nodes: int,
                                   max_deg: int) -> torch.Tensor:
    """Padded-CSR local clustering coefficient (vectorized intersections)
    on ``edge_src``'s device: the reference's
    ``clustering_coefficients_jax``.

    Row ``u`` of the table holds ``u``'s out-neighbours in stable
    ``argsort(src)`` order, self-loops skipped, at most ``max_deg`` of
    them, then sorted and padded with ``n_nodes``; membership tests are
    ``searchsorted`` over the padded rows, a chunk of vertices at a
    time."""
    dev = (edge_src.device if isinstance(edge_src, torch.Tensor)
           else torch.device("cpu"))
    src = np.asarray(edge_src.cpu() if isinstance(edge_src, torch.Tensor)
                     else edge_src, np.int64)
    dst = np.asarray(edge_dst.cpu() if isinstance(edge_dst, torch.Tensor)
                     else edge_dst, np.int64)
    order = np.argsort(src, kind="stable")
    s, d = src[order], dst[order]
    keep = s != d
    s, d = s[keep], d[keep]
    # rank of each edge within its source's run (s is sorted)
    starts = np.searchsorted(s, s, side="left")
    rank = np.arange(s.size, dtype=np.int64) - starts
    take = rank < max_deg
    table = np.full((n_nodes, max_deg), n_nodes, dtype=np.int32)
    table[s[take], rank[take]] = d[take]
    table.sort(axis=1)
    counts = np.minimum(np.bincount(s, minlength=n_nodes), max_deg)
    tbl = torch.from_numpy(table).to(dev)
    k = torch.from_numpy(counts.astype(np.int32)).to(dev)
    links = torch.zeros(n_nodes, dtype=torch.int64, device=dev)
    if max_deg > 0:
        chunk = max(1, _CC_CHUNK_ELEMS // (max_deg * max_deg))
        for lo in range(0, n_nodes, chunk):
            rows = tbl[lo:lo + chunk]                       # (c, m)
            vrows = tbl[rows.clamp(max=n_nodes - 1).long()]  # (c, m, m)
            probe = rows[:, None, :].expand_as(vrows).contiguous()
            pos = torch.searchsorted(vrows, probe).clamp_(max=max_deg - 1)
            hit = ((vrows.gather(2, pos) == probe) & (probe < n_nodes)
                   & (rows[:, :, None] < n_nodes))
            links[lo:lo + chunk] = hit.sum(dim=(1, 2))
    denom = torch.clamp(k * (k - 1), min=1)
    return torch.where(k >= 2, links.to(torch.float32) / denom,
                       torch.zeros((), dtype=torch.float32, device=dev))


def visible_edges_at(ga: GraphArrays, at: Stamp, n_gk: int,
                     device: str = "cuda"):
    """Batched snapshot filter over the raw edge set: ONE ``visibility``
    kernel launch on ``device`` over the raw create/delete rows, in one
    round trip (``mv_ops.visibility_host``)."""
    assert ga.edge_create is not None, "snapshot_arrays(keep_raw=True) needed"
    q = clock.pack(at, n_gk)
    mask = mv_ops.visibility_host(ga.edge_create, ga.edge_delete, q, device)
    return ga.raw_src[mask], ga.raw_dst[mask], mask


def columns_from_numpy(n_gk: int, v_gid: np.ndarray, v_create: np.ndarray,
                       v_delete: np.ndarray, e_src: np.ndarray,
                       e_dst: np.ndarray, e_create: np.ndarray,
                       e_delete: np.ndarray,
                       intern: Optional[VidIntern] = None
                       ) -> PartitionColumns:
    """A :class:`~repro_torch.core.mvgraph.PartitionColumns` holding the
    given packed vertex and edge tables (e.g. another implementation's
    partition arrays), so visibility can be evaluated over identical
    stamp matrices.  No original :class:`Stamp` objects come along: the
    rows carry no oracle refinement."""
    cols = PartitionColumns(n_gk, intern)
    nv, ne = len(v_gid), len(e_src)
    cols.v_gid.extend(np.asarray(v_gid, np.int32))
    cols.v_create.extend(np.asarray(v_create, np.int32).reshape(nv, -1))
    cols.v_delete.extend(np.asarray(v_delete, np.int32).reshape(nv, -1))
    cols.v_create_stamp = [None] * nv
    cols.v_delete_stamp = [None] * nv
    cols.v_slot = {int(g): i for i, g in enumerate(np.asarray(v_gid).tolist())}
    cols.e_src.extend(np.asarray(e_src, np.int32))
    cols.e_dst.extend(np.asarray(e_dst, np.int32))
    cols.e_eid.extend(np.arange(ne, dtype=np.int64))
    cols.e_create.extend(np.asarray(e_create, np.int32).reshape(ne, -1))
    cols.e_delete.extend(np.asarray(e_delete, np.int32).reshape(ne, -1))
    cols.e_create_stamp = [None] * ne
    cols.e_delete_stamp = [None] * ne
    cols.e_slot = {(int(s), i): i
                   for i, s in enumerate(np.asarray(e_src).tolist())}
    return cols
