"""Backing store — HyperDex/Warp stand-in (paper §3.2, §4.1).

A strictly serializable, transactional key-value store that (a) holds the
durable copy of the multi-version graph, (b) maps vertices to shard
servers, and (c) records each vertex's last-update stamp, which the
gatekeepers use to keep timestamps consistent with the store's execution
order (``T_upd ≺ T_tx`` check; retry/refine otherwise).

In the simulator it is a single actor executing multi-key transactions
atomically at message-delivery time (that *is* strict serializability for
a single-copy store), with a write-ahead log for recovery and an optional
on-disk checkpoint used by the fault-tolerance tests.

Recovery (§4.3): the WAL is a replayable redo log.  Every commit appends
a :class:`~repro_torch.core.writepath.WalRecord` carrying the transaction's
full forwarded ops (stamps included), so :meth:`BackingStore.
recover_shard` rebuilds a failed shard's partition by replaying the log
up to the stable point — truncating any torn tail a crash left behind a
group record's ``valid`` watermark.  Store-side GC rewrites the log as
one checkpoint record (the per-shard walk at the horizon) so replay
stays bounded and agrees with the GC'd store.  The old ``vertices``-walk
recovery is kept verbatim as :meth:`recover_shard_walk`, the equivalence
oracle the recovery tests compare replay against.

Exactly-once retry: committed (and aborted) transaction outcomes are
recorded in :attr:`BackingStore.tx_results` keyed by the client-assigned
transaction id, *at the same commit point as the WAL append*, so a
resubmitted transaction whose ack was lost is answered from the table
instead of re-executing — it commits once, never twice.

Group commit (``repro_torch.core.writepath``): last-update stamps are mirrored
into a packed :class:`~repro_torch.core.writepath.LastUpdateTable` at every
commit point, so the gatekeeper's batched admission path validates a
whole window's write-sets with one vectorized compare instead of one
dict probe per vertex; :meth:`BackingStore.apply_batch` then commits the
validated batch in ONE store round trip — one group WAL record is the
batch's single durability point, and each transaction's reply is sent
only after it.  A logical error (``ValueError``) aborts only its own
transaction; the rest of the batch commits.  The per-tx :meth:`apply`
is unchanged and remains the semantic oracle.
"""

from __future__ import annotations

import json
import os
import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from .clock import Order, Stamp, compare
from .mvgraph import VidIntern
from .simulation import Simulator
from .writepath import LastUpdateTable, WalRecord, wal_replay_shard


@dataclass
class StoredVertex:
    vid: str
    shard: int
    create_ts: Stamp
    delete_ts: Optional[Stamp] = None
    # durable mirror of edges/properties: eid -> (dst, create_ts, delete_ts)
    edges: Dict[int, Tuple[str, Stamp, Optional[Stamp]]] = field(default_factory=dict)
    props: Dict[str, List[Tuple[object, Stamp]]] = field(default_factory=dict)
    # eid -> key -> [(value, ts), ...]; mirrored so walk recovery (and the
    # checkpoint rewrite) can re-emit set_edge_prop with original stamps
    edge_props: Dict[int, Dict[str, List[Tuple[object, Stamp]]]] = \
        field(default_factory=dict)
    last_update: Optional[Stamp] = None


class BackingStore:
    """Strictly serializable KV + vertex->shard directory + redo WAL."""

    #: a txid marked in-flight this long ago with no recorded outcome is
    #: presumed lost (its gatekeeper died pre-WAL) — a resubmission may
    #: re-attempt it
    INFLIGHT_STALE = 4e-3
    #: recorded tx outcomes older than this are pruned at GC (longer than
    #: any client session: budget * backoff_cap plus slack)
    RESULT_RETENTION = 2.0

    def __init__(self, sim: Simulator, n_shards: int,
                 intern: Optional[VidIntern] = None,
                 wal_checkpoint_every: int = 256,
                 device: str = "cuda"):
        self.sim = sim
        sim.register(self)
        self.n_shards = n_shards
        self.vertices: Dict[str, StoredVertex] = {}
        self.wal: List[WalRecord] = []
        self.wal_checkpoint_every = wal_checkpoint_every
        self._next_eid = 0
        # exactly-once: txid -> (ok, error, stamp, fwd, recorded_at);
        # written at the WAL durability point, read by the gatekeeper's
        # dedup check before re-executing a resubmitted transaction
        self.tx_results: Dict[object, Tuple] = {}
        self._inflight: Dict[object, float] = {}
        # packed mirror of per-vertex last-update stamps (group-commit
        # validation path; kept exactly in sync with StoredVertex.
        # last_update at every commit point); its write-set validation
        # compares run on ``device``
        self.last_updates = LastUpdateTable(intern, device=device)

    # ---- directory -------------------------------------------------------
    def place(self, vid: str) -> int:
        """Static placement hash; dynamic migration (§4.6) is out of scope
        for the evaluation (the paper disables it too).  crc32, not
        ``hash()``: placement must be identical across processes (Python
        randomizes str hashing per process) or traces and counters from
        the same seeded workload would not be comparable run-to-run."""
        return zlib.crc32(vid.encode()) % self.n_shards

    def shard_of(self, vid: str) -> Optional[int]:
        v = self.vertices.get(vid)
        return None if v is None else v.shard

    def fresh_eid(self) -> int:
        self._next_eid += 1
        return self._next_eid

    # ---- transactional execution ------------------------------------------
    # Executed atomically by the gatekeeper's commit path; returns the list
    # of (shard, op) to forward, or raises on logical error (-> abort).
    def last_update_of(self, vid: str) -> Optional[Stamp]:
        v = self.vertices.get(vid)
        return None if v is None else v.last_update

    def apply(self, ops: List[dict], ts: Stamp,
              txid: object = None) -> List[Tuple[int, dict]]:
        """Validate + execute a whole transaction atomically.

        Validation runs against an *overlay* of the staged writes so a
        transaction sees its own earlier operations (e.g. Fig. 2 creates a
        vertex and immediately hangs edges off it).  A logical error aborts
        with no side effects (§4.1).
        """
        return self._apply_one(ops, ts, log=True, txid=txid)

    def apply_batch(self, items: List[Tuple[List[dict], Stamp, object]],
                    torn_limit: Optional[int] = None
                    ) -> List[Tuple[bool, Optional[str],
                                    Optional[List[Tuple[int, dict]]]]]:
        """Commit a validated group — ``[(ops, stamp, txid), ...]`` in
        stamp order — in one store round trip.

        Per-transaction result: ``(ok, error, fwd)``.  Each transaction
        keeps its own atomicity (a logical error rolls back that tx
        only); the batch shares ONE group WAL record appended after the
        last transaction — the group's single durability point (the
        gatekeeper replies to every client after this call returns), and
        tx outcomes are recorded for dedup at the same point.

        ``torn_limit`` is the fault-injection hook for a crash DURING
        the group append: only the first ``torn_limit`` transactions
        commit; the next entry is written to the log but left beyond the
        record's ``valid`` watermark (a torn tail recovery must
        truncate) and the rest of the window is lost entirely."""
        out = []
        entries: List[Tuple[Stamp, object, List[Tuple[int, dict]]]] = []
        cut = len(items) if torn_limit is None else min(torn_limit, len(items))
        for ops, ts, txid in items[:cut]:
            try:
                fwd = self._apply_one(ops, ts, log=False)
            except ValueError as e:
                out.append((False, str(e), None))
                self.record_result(txid, False, str(e), ts, None)
                continue
            out.append((True, None, fwd))
            entries.append((ts, txid, fwd))
        valid = len(entries)
        if cut < len(items):                     # torn tail: garbled entry
            ops, ts, txid = items[cut]
            entries.append((ts, txid, self._torn_fwd(ops, ts)))
            out.extend((False, "torn", None) for _ in items[cut:])
        if entries:
            self.wal.append(WalRecord("group", entries, valid=valid))
            self.sim.counters.wal_records += 1
            for ts, _txid, _fwd in entries[:valid]:
                self._wal_span(ts, group=True)
        # durability point: the group record is on the log, so the
        # outcomes become answerable to resubmissions exactly now
        for ts, txid, fwd in entries[:valid]:
            self.record_result(txid, True, None, ts, fwd)
        return out

    def _wal_span(self, ts: Stamp, group: bool) -> None:
        """Zero-width durability marker on a sampled trace: the instant
        this stamp's redo record hit the log (stage ``wal_append``)."""
        tr = self.sim.tracer
        if tr is None:
            return
        ctx = tr.ctx_for_stamp(ts)
        if ctx is not None:
            from .obs import stamp_attr
            tr.span("wal_append", self.sim.now, self.sim.now,
                    actor="store", ctx=ctx, group=group,
                    stamp=stamp_attr(ts))

    def _torn_fwd(self, ops: List[dict], ts: Stamp) -> List[Tuple[int, dict]]:
        """Best-effort forward list for a half-written (never applied)
        entry — what a torn tail would physically contain on the log."""
        fwd = []
        for op in ops:
            vid = op.get("vid") or op.get("src")
            sid = self.shard_of(vid)
            fwd.append((self.place(vid) if sid is None else sid,
                        dict(op, ts=ts)))
        return fwd

    # ---- exactly-once bookkeeping -------------------------------------------
    def record_result(self, txid: object, ok: bool, err: Optional[str],
                      stamp: Stamp, fwd=None) -> None:
        """Record a transaction's final outcome for dedup (no-op without
        a client-assigned txid)."""
        if txid is None:
            return
        self._inflight.pop(txid, None)
        self.tx_results[txid] = (ok, err, stamp, fwd, self.sim.now)

    def begin_tx_attempt(self, txid: object) -> str:
        """Dedup gate for a fresh client submission of ``txid``.

        ``"done"``: an outcome is recorded — answer from the table.
        ``"inflight"``: another attempt is being validated right now —
        drop this one (the client's next timeout covers the race).
        ``"new"``: proceed (and mark in-flight)."""
        if txid is None:
            return "new"
        if txid in self.tx_results:
            return "done"
        t = self._inflight.get(txid)
        if t is not None and self.sim.now - t < self.INFLIGHT_STALE:
            return "inflight"
        self._inflight[txid] = self.sim.now
        return "new"

    def touch_inflight(self, txid: object) -> None:
        """Keep a txid's in-flight marker fresh across internal
        validation retries so a concurrent client resubmission cannot
        slip past the gate mid-retry-loop."""
        if txid is not None:
            self._inflight[txid] = self.sim.now

    def _apply_one(self, ops: List[dict], ts: Stamp, log: bool,
                   txid: object = None) -> List[Tuple[int, dict]]:
        fwd: List[Tuple[int, dict]] = []
        staged: List[Callable[[], None]] = []
        new_v: Dict[str, StoredVertex] = {}       # created in this tx
        del_v: set = set()                        # deleted in this tx
        new_e: Dict[str, Dict[int, str]] = {}     # src -> eid -> dst
        del_e: set = set()                        # (src, eid)

        def live(vid: str) -> bool:
            if vid in del_v:
                return False
            if vid in new_v:
                return True
            v = self.vertices.get(vid)
            return v is not None and v.delete_ts is None

        def edge_live(src: str, eid: int) -> bool:
            if (src, eid) in del_e:
                return False
            if eid in new_e.get(src, {}):
                return True
            v = self.vertices.get(src)
            return (v is not None and eid in v.edges
                    and v.edges[eid][2] is None)

        def shard_for(vid: str) -> int:
            if vid in new_v:
                return new_v[vid].shard
            return self.vertices[vid].shard

        for op in ops:
            kind = op["op"]
            if kind == "create_vertex":
                vid = op["vid"]
                if live(vid):
                    raise ValueError(f"vertex {vid} exists")
                shard = op.get("shard", self.place(vid))
                new_v[vid] = StoredVertex(vid, shard, ts, last_update=ts)
                del_v.discard(vid)
                fwd.append((shard, dict(op, ts=ts)))
            elif kind == "delete_vertex":
                vid = op["vid"]
                if not live(vid):
                    raise ValueError(f"vertex {vid} not live")
                del_v.add(vid)
                if vid not in new_v:
                    v = self.vertices[vid]
                    def _d(v=v):
                        v.delete_ts = ts
                        v.last_update = ts
                    staged.append(_d)
                fwd.append((shard_for(vid), dict(op, ts=ts)))
            elif kind == "create_edge":
                src, dst = op["src"], op["dst"]
                if not live(src):
                    raise ValueError(f"src {src} not live")
                if not live(dst):
                    raise ValueError(f"dst {dst} not live")
                eid = op.get("eid") or self.fresh_eid()
                new_e.setdefault(src, {})[eid] = dst
                if src not in new_v:
                    vs = self.vertices[src]
                    def _e(vs=vs, eid=eid, dst=dst):
                        vs.edges[eid] = (dst, ts, None)
                        vs.last_update = ts
                    staged.append(_e)
                fwd.append((shard_for(src), dict(op, eid=eid, ts=ts)))
            elif kind == "delete_edge":
                src, eid = op["src"], op["eid"]
                if not edge_live(src, eid):
                    raise ValueError(f"edge {src}/{eid} not live")
                del_e.add((src, eid))
                if eid in new_e.get(src, {}):
                    dst = new_e[src].pop(eid)
                    def _de0(src=src, eid=eid, dst=dst):
                        self.vertices[src].edges[eid] = (dst, ts, ts)
                    staged.append(_de0)
                else:
                    vs = self.vertices[src]
                    def _de(vs=vs, eid=eid):
                        dst, cts, _ = vs.edges[eid]
                        vs.edges[eid] = (dst, cts, ts)
                        vs.last_update = ts
                    staged.append(_de)
                fwd.append((shard_for(src), dict(op, ts=ts)))
            elif kind == "set_vertex_prop":
                vid = op["vid"]
                if not live(vid):
                    raise ValueError(f"vertex {vid} not live")
                if vid in new_v:
                    new_v[vid].props.setdefault(op["key"], []).append(
                        (op["value"], ts))
                else:
                    v = self.vertices[vid]
                    def _p(v=v, op=op):
                        v.props.setdefault(op["key"], []).append(
                            (op["value"], ts))
                        v.last_update = ts
                    staged.append(_p)
                fwd.append((shard_for(vid), dict(op, ts=ts)))
            elif kind == "set_edge_prop":
                src, eid = op["src"], op["eid"]
                if not edge_live(src, eid):
                    raise ValueError(f"edge {src}/{eid} missing")
                if src in new_v:
                    new_v[src].edge_props.setdefault(eid, {}).setdefault(
                        op["key"], []).append((op["value"], ts))
                else:
                    vs = self.vertices[src]
                    def _pe(vs=vs, op=op):
                        vs.edge_props.setdefault(op["eid"], {}).setdefault(
                            op["key"], []).append((op["value"], ts))
                        vs.last_update = ts
                    staged.append(_pe)
                fwd.append((shard_for(src), dict(op, ts=ts)))
            elif kind == "get_vertex":       # reads execute here (paper §4.1)
                vid = op["vid"]
                if not live(vid):
                    raise ValueError(f"vertex {vid} not live")
                # read-only: nothing forwarded, nothing staged
            else:
                raise ValueError(f"unknown op {kind}")

        # ---- commit point: merge new vertices, run staged writes, WAL ----
        for vid, v in new_v.items():
            for eid, dst in new_e.get(vid, {}).items():
                v.edges[eid] = (dst, ts, None)
            if vid in del_v:
                v.delete_ts = ts
            self.vertices[vid] = v
        for s in staged:
            s()
        # packed mirror follows the dict exactly: every vid whose
        # last_update the staged writes (or new-vertex creation) set
        self.last_updates.record(self.write_set(ops), ts)
        if log:
            if fwd:
                self.wal.append(WalRecord("tx", [(ts, txid, fwd)], valid=1))
                self.sim.counters.wal_records += 1
                self._wal_span(ts, group=False)
            self.record_result(txid, True, None, ts, fwd)
        return fwd

    # ---- touched vertices (for last-update validation) ---------------------
    @staticmethod
    def write_set(ops: List[dict]) -> List[str]:
        out = []
        for op in ops:
            k = op["op"]
            if k in ("create_vertex", "delete_vertex", "set_vertex_prop"):
                out.append(op["vid"])
            elif k in ("create_edge", "delete_edge", "set_edge_prop"):
                out.append(op["src"])
        return out

    # ---- GC (paper §4.5, at the store) --------------------------------------
    def collect(self, horizon: Stamp) -> Tuple[int, int]:
        """Store-side GC at the global horizon (every future stamp
        dominates it):

        * :class:`~repro_torch.core.writepath.LastUpdateTable` rows strictly
          before the horizon are dropped — absence means "no last
          update", which validates identically (``upd ≺ tx`` holds by
          transitivity), so the packed table stays bounded;
        * ``StoredVertex.last_update`` stamps strictly before the
          horizon are cleared to keep the dict mirror == packed table
          (the per-tx path's ``compare`` walk reaches the same verdict
          either way);
        * :class:`StoredVertex` records DELETED strictly before the
          horizon are dropped entirely — the shards purged those
          versions at the same horizon, so recovery replay and the
          vid -> shard directory agree (a dangling directory lookup now
          returns None, same as a vertex that never existed);
        * the WAL is rewritten as ONE checkpoint record (the per-shard
          walk) whenever vertices were dropped — full-history replay
          would otherwise resurrect them — or when the log outgrew
          ``wal_checkpoint_every`` records, keeping replay bounded;
        * recorded tx outcomes older than ``RESULT_RETENTION`` (longer
          than any client retry session) are pruned.

        Returns ``(lastupdate_rows_dropped, vertices_dropped)``."""
        n_rows = self.last_updates.collect(horizon)
        dead = [vid for vid, v in self.vertices.items()
                if v.delete_ts is not None
                and compare(v.delete_ts, horizon) is Order.BEFORE]
        for vid in dead:
            del self.vertices[vid]
        for v in self.vertices.values():
            if v.last_update is not None and compare(
                    v.last_update, horizon) is Order.BEFORE:
                v.last_update = None
        if dead or len(self.wal) > self.wal_checkpoint_every:
            self._checkpoint_wal()
        stale = [txid for txid, r in self.tx_results.items()
                 if self.sim.now - r[4] > self.RESULT_RETENTION]
        for txid in stale:
            del self.tx_results[txid]
        self.sim.counters.store_txresults_gcd += len(stale)
        self.sim.counters.store_lastupdate_gcd += n_rows
        self.sim.counters.store_vertices_gcd += len(dead)
        return n_rows, len(dead)

    # ---- recovery support ---------------------------------------------------
    def _walk_vertex(self, vid: str, v: StoredVertex, out: List[dict]) -> None:
        """Append one vertex's redo stream (original stamps) to ``out``."""
        out.append({"op": "create_vertex", "vid": vid, "ts": v.create_ts})
        for eid, (dst, cts, dts) in v.edges.items():
            out.append({"op": "create_edge", "src": vid, "dst": dst,
                        "eid": eid, "ts": cts})
            for key, versions in v.edge_props.get(eid, {}).items():
                for value, pts in versions:
                    out.append({"op": "set_edge_prop", "src": vid,
                                "eid": eid, "key": key, "value": value,
                                "ts": pts})
            if dts is not None:
                out.append({"op": "delete_edge", "src": vid, "eid": eid,
                            "ts": dts})
        for key, versions in v.props.items():
            for value, ts in versions:
                out.append({"op": "set_vertex_prop", "vid": vid, "key": key,
                            "value": value, "ts": ts})
        if v.delete_ts is not None:
            out.append({"op": "delete_vertex", "vid": vid, "ts": v.delete_ts})

    def recover_shard_walk(self, shard: int) -> List[dict]:
        """Rebuild one shard's redo stream by walking ``vertices`` —
        the original recovery path, kept as the equivalence oracle for
        WAL replay (``tests/test_recovery.py``)."""
        out: List[dict] = []
        for vid, v in self.vertices.items():
            if v.shard == shard:
                self._walk_vertex(vid, v, out)
        return out

    def recover_shard(self, shard: int, use_wal: bool = True) -> List[dict]:
        """Redo stream for one shard's partition (backup promotion,
        §4.3): replay the WAL up to the stable point, truncating any
        torn tail; ``use_wal=False`` falls back to the store walk."""
        if not use_wal:
            return self.recover_shard_walk(shard)
        ops, torn = wal_replay_shard(self.wal, shard)
        self.sim.counters.wal_torn_truncated += torn
        self.sim.counters.wal_replay_ops += len(ops)
        return ops

    def _checkpoint_wal(self) -> None:
        """Rewrite the log as one checkpoint record: the full per-shard
        walk at this instant subsumes every earlier record (and agrees
        with what GC just dropped)."""
        shards: Dict[int, List[dict]] = {s: [] for s in range(self.n_shards)}
        for vid, v in self.vertices.items():
            self._walk_vertex(vid, v, shards[v.shard])
        self.wal = [WalRecord("ckpt", ckpt=shards)]
        self.sim.counters.wal_ckpts += 1

    # ---- durability to disk (used by checkpoint tests) ----------------------
    def checkpoint_to(self, path: str) -> None:
        data = {
            "wal_len": len(self.wal),
            "vertices": {
                vid: {
                    "shard": v.shard,
                    "create": v.create_ts.key(),
                    "deleted": None if v.delete_ts is None else v.delete_ts.key(),
                    "n_edges": len(v.edges),
                }
                for vid, v in self.vertices.items()
            },
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f)
        os.replace(tmp, path)
