"""Shard servers (paper §3.2, §4.1, §4.2, Fig. 6).

Each shard owns an in-memory multi-version partition of the graph and
obeys the refinable-timestamp order:

* one FIFO queue of incoming items per gatekeeper (sequence-numbered);
* the event loop executes the item with the *lowest* stamp once every
  queue is non-empty (NOPs guarantee this under light load);
* mutually concurrent queue heads are submitted to the timeline oracle in
  a single request; the returned (now committed) order is cached locally —
  oracle decisions are irreversible and monotonic;
* node programs wait until their stamp precedes every queue head, then
  execute against the multi-version snapshot at ``T_prog``; concurrent
  object stamps encountered during the snapshot read are refined through
  the oracle (default: program ordered *after* committed writes);
* programs scatter to other shards by emitting (vertex, params) pairs,
  grouped per destination shard, with coordinator-side termination
  counting.

Frontier-batched execution (plan / fallback contract)
-----------------------------------------------------
Programs with a registered ``frontier_step`` (see ``repro_torch.core.
nodeprog``) run **batched**: the shard materializes a
:class:`~repro_torch.core.frontier.ShardPlan` — a sorted-CSR snapshot slice of
its own ``PartitionColumns`` at ``T_prog`` — and executes the whole
delivered frontier in one vectorized step.  The next hop is exchanged as
ONE packed :class:`~repro_torch.core.frontier.Frontier` message per
destination shard (O(shards) messages per hop) instead of one
``(dst, params)`` entry per emitted vertex.  Every built-in program has
a vectorized step — including the ragged-output ``get_edges`` (one
packed :class:`~repro_torch.core.frontier.RaggedReply` per step) and the
3-phase ``clustering`` wedge-closing protocol (packed neighbour lists
in a :class:`~repro_torch.core.frontier.Ragged` side table).  The path is
chosen per query from ``(name, root entries)`` — deterministic, so all
shards agree — and everything else (heterogeneous root params,
unhashable filter constants, non-phase-0 clustering roots, or
``use_frontier=False``) falls back to the scalar per-vertex interpreter
``nodeprog.run_entries_scalar``, which remains the semantic oracle.

Three mechanisms keep the batched path fast under live traffic:

* **plan delta refresh** — writes committing between program hops bump
  ``columns.version``; instead of rebuilding its plan cold, the shard
  delta-refreshes it from the partition's patch logs / compaction
  events at O(changed) stamp work (see :meth:`Shard._frontier_plan`);
* **plan LRU** — plans are cached per build stamp in a small LRU
  (``plan_cache_entries``), so interleaved programs at mutually
  concurrent stamps each keep a live plan instead of thrashing one
  slot cold;
* **delivery coalescing** — concurrent same-(prog, stamp) deliveries
  waiting in ``pending_progs`` are merged into ONE execution per hop
  per shard, charging the merged service cost once — packed frontiers
  concatenate into one ``frontier_step``, scalar entry lists into one
  ``run_entries_scalar`` (see :meth:`Shard._coalesce_pending`).

Group-committed writes (``repro_torch.core.writepath``) arrive as ONE packed
``WriteBatch`` queue item per (gatekeeper window, shard) — kind
``"txbatch"``, queue-ordered by the batch's lowest remaining stamp —
and apply into the partition as bulk column appends (one stamp-matrix
append + one patch-log extend per table), in safe prefixes that never
overtake another queue's head (:meth:`Shard._exec_batch_prefix`).
Every op still carries its own commit stamp, so multi-version
visibility, program gating on queue heads, and plan/snapshot delta
refresh see exactly the per-tx contract, just with fewer, larger
patch tails.

Time model: the shard is a single-threaded server; each item charges a
service time from :class:`~repro_torch.core.gatekeeper.CostModel`, and each
*uncached* oracle interaction stalls the loop by ``oracle_rtt``.
"""

from __future__ import annotations

from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .clock import Order, Stamp, compare
from .frontier import (Frontier, RaggedReply, ShardPlan, _merge_frontiers,
                       blank_ragged_rows, execute_step, fill_ragged_rows,
                       maintain_plan, reply_nbytes, route_frontier)
from .gatekeeper import CostModel
from .mvgraph import MVGraphPartition, VidIntern
from .nodeprog import REGISTRY, run_entries_scalar
from .obs import stamp_attr
from .oracle import KIND_PROG, KIND_TX, OracleServer
from .simulation import Simulator
from .writepath import WriteBatch


@dataclass
class _QueueItem:
    stamp: Stamp
    kind: str          # "tx" | "nop"
    payload: Optional[List[dict]]
    t: float = 0.0     # arrival time (queue-wait span attribution)


class Shard:
    def __init__(self, sim: Simulator, sid: int, n_gk: int,
                 oracle: OracleServer, cost: CostModel,
                 directory: Callable[[str], Optional[int]],
                 intern: Optional[VidIntern] = None,
                 use_frontier: bool = True,
                 plan_delta: bool = True,
                 coalesce: bool = True,
                 plan_cache_entries: int = 4,
                 ack_applies: bool = False,
                 device_plane=None,
                 incarnation: int = 0,
                 prop_vals=None,
                 device: str = "cuda"):
        self.sim = sim
        sim.register(self)
        self.sid = sid
        self.name = f"shard{sid}"        # fault-injection crash-point id
        # bumped per backup promotion: the exactly-once trace invariant
        # allows one apply span per (shard, incarnation), and the wire-
        # dedup sender keys shipped rows by receiver incarnation so a
        # promoted (empty-cache) receiver never gets a blanked marker
        # for a row it lacks
        self.incarnation = incarnation
        self.n_gk = n_gk
        self.oracle = oracle
        self.cost = cost
        self.directory = directory       # vid -> shard id (cached map; §3.2)
        # vid intern table is deployment-wide so edge endpoints resolve
        # across partitions in the columnar snapshot path
        self.intern = intern if intern is not None else VidIntern()
        # optional deployment-wide property-VALUE intern (PropIntern):
        # when Weaver shares one, ragged replies ship packed value ids
        self.prop_vals = prop_vals
        self.partition = MVGraphPartition(n_gk, self.intern,
                                          prop_vals=prop_vals)
        self.use_frontier = use_frontier
        self.plan_delta = plan_delta     # ShardPlan delta refresh on/off
        self.coalesce = coalesce         # same-(prog, stamp) merge on/off
        # stamp-keyed plan LRU (budget = plan_cache_entries): interleaved
        # programs at mutually concurrent stamps each keep their own
        # delta-refreshed plan instead of thrashing one slot
        self.plan_cache_entries = max(1, plan_cache_entries)
        self._plans: "OrderedDict[tuple, ShardPlan]" = OrderedDict()
        self._plan_built_rows = 0                  # pending service charge
        self.queues: Dict[int, deque] = {g: deque() for g in range(n_gk)}
        self._expected_seq: Dict[int, int] = {g: 0 for g in range(n_gk)}
        self._stash: Dict[int, Dict[int, tuple]] = {g: {} for g in range(n_gk)}
        self.pending_progs: List[tuple] = []
        self._prog_cleared: Dict[Tuple, set] = {}
        self.prog_states: Dict[int, Dict[str, dict]] = {}
        self._finished_progs: set = set()
        self._order_cache: Dict[Tuple, Order] = {}
        # stamps this partition already holds (filled by recovery replay,
        # extended at every apply): re-forwarded slices of transactions
        # that were durable before a crash are skipped, never re-applied.
        # _applied_at records the apply time: GC must NOT prune an entry
        # a client retry session could still re-forward (dedup-gate
        # resubmission of a committed-but-unacked tx), or the re-forward
        # would double-apply — same retention contract as the store's
        # tx_results
        self._applied: Dict[Tuple, Stamp] = {}
        self._applied_at: Dict[Tuple, float] = {}
        self.busy = False
        self.alive = True
        self.peers: List["Shard"] = []   # indexable by sid
        self._stall = 0.0
        # read-your-writes support: ack applied tx stamps back to the
        # forwarding gatekeeper (list wired by Weaver; indexable by gid)
        self.ack_applies = ack_applies
        self.gatekeepers: List[object] = []
        # device-resident column plane (repro_torch.dist.columns): plan
        # builds evaluate visibility from its resident blocks when set
        self.device_plane = device_plane
        # where plan builds run their stamp compares (WeaverConfig.device)
        self.device = device
        # clustering phase-1 wire dedup (ISSUE 9 satellite): sender-side
        # shipped-row sets keyed (dst sid, dst incarnation, prog name,
        # stamp key) and receiver-side full-row cache keyed (prog name,
        # stamp key) -> {row key: (values, extra)}.  FIFO channels
        # guarantee a full row always precedes its blanked marker.
        self._shipped_rows: Dict[Tuple, set] = {}
        self._nbr_cache: Dict[Tuple, Dict] = {}
        self._last_plan_kind = "scalar"  # span attr: plan path per exec
        # deployment pod (None = unplaced; Simulator.send charges a
        # cross-pod surcharge only between two PLACED actors)
        self.pod: Optional[int] = None
        # ---- change-feed replication (see repro_torch.core.replica) --------
        # When replicas exist (Weaver sets ``replicated``), every fresh
        # apply appends (stamp, ops) to a bounded feed log replicas pull
        # (absolute position = feed_base + len(feed_log)), and the drain
        # loop SETTLES each read stamp the first time a program at it
        # becomes runnable: at that instant every gatekeeper queue head
        # is (refined) after the stamp, so — per-gk stamp monotonicity +
        # oracle commitment — no future write can ever be ordered before
        # it here, and the current feed position permanently covers the
        # stamp's visible prefix.  The (stamp -> position) token is
        # broadcast to gatekeepers (routing) and rides feed responses
        # (replica read gating).
        self.replicated = False
        self.feed_log: List[Tuple[Stamp, List[dict]]] = []
        self.feed_base = 0
        self.settled: Dict[Tuple, int] = {}

    def start(self, peers: List["Shard"]) -> None:
        self.peers = peers

    def stop(self) -> None:
        self.alive = False

    def _crash_point(self, point: str) -> bool:
        """Fault-injection hook: die here if the plan says so."""
        f = self.sim.fault
        if f is not None and f.crash(point, self.name):
            self.alive = False
            return True
        return False

    # ------------------------------------------------------------------ enqueue
    def enqueue(self, gid: int, seq: int, stamp: Stamp, kind: str,
                payload) -> None:
        """FIFO channel receive with sequence-number reordering (§4.1)."""
        if not self.alive:
            return
        exp = self._expected_seq[gid]
        if seq == exp + 1:
            self.queues[gid].append(_QueueItem(stamp, kind, payload,
                                               self.sim.now))
            self._expected_seq[gid] = seq
            # drain stash
            stash = self._stash[gid]
            nxt = seq + 1
            while nxt in stash:
                s, k, p, t = stash.pop(nxt)
                self.queues[gid].append(_QueueItem(s, k, p, t))
                self._expected_seq[gid] = nxt
                nxt += 1
        elif seq > exp + 1:
            self._stash[gid][seq] = (stamp, kind, payload, self.sim.now)
        # duplicate/old -> drop
        self._kick()

    def deliver_prog(self, prog_id: int, delivery_id, name: str, stamp: Stamp,
                     entries: List[Tuple[str, object]], coordinator) -> None:
        if not self.alive:
            return
        if prog_id in self._finished_progs:
            self.sim.send(self, coordinator, coordinator.report, prog_id,
                          delivery_id, [], [], nbytes=32)
            return
        entries = self._reconstitute(name, stamp, entries)
        self.pending_progs.append({
            "prog_id": prog_id, "delivery_id": delivery_id, "name": name,
            "stamp": stamp, "entries": entries, "coordinator": coordinator,
            "t": self.sim.now,
            # queue-clearing state is PER PROGRAM per shard (monotone:
            # once every queue head dominated T_prog, all later arrivals
            # do too) — so follow-up deliveries of the same program run
            # immediately instead of re-waiting.
            "cleared": self._prog_cleared.setdefault(stamp.key(), set()),
        })
        self._kick()

    def deliver_prog_batch(self, deliveries: List[Tuple]) -> None:
        """One windowed read-admission flush's deliveries for this shard
        (``repro_torch.core.gatekeeper._flush_rgroup``): a list of
        ``(prog_id, delivery_id, name, stamp, entries, coordinator)``
        sharing the window's stamp, shipped as ONE message instead of
        one per program.  Queue-clearing state is keyed by stamp, so the
        whole window clears (and refines) once."""
        if not self.alive:
            return
        for prog_id, delivery_id, name, stamp, entries, coordinator \
                in deliveries:
            if prog_id in self._finished_progs:
                self.sim.send(self, coordinator, coordinator.report, prog_id,
                              delivery_id, [], [], nbytes=32)
                continue
            self.pending_progs.append({
                "prog_id": prog_id, "delivery_id": delivery_id, "name": name,
                "stamp": stamp,
                "entries": self._reconstitute(name, stamp, entries),
                "coordinator": coordinator,
                "t": self.sim.now,
                "cleared": self._prog_cleared.setdefault(stamp.key(), set()),
            })
        self._kick()

    def finish_prog(self, prog_id: int) -> None:
        """Coordinator broadcast: GC per-query state (§4.5)."""
        self._finished_progs.add(prog_id)
        self.prog_states.pop(prog_id, None)
        if len(self._prog_cleared) > 10_000:
            self._prog_cleared.clear()
        if len(self._finished_progs) > 100_000:
            self._finished_progs.clear()

    # ---------------------------------------------- ragged wire dedup
    def _reconstitute(self, name: str, stamp: Stamp, entries):
        """Receiver half of the neighbour-list wire dedup: fill blanked
        marker rows from this shard's (prog, stamp)-keyed cache, then
        remember every full row for future markers.  A row's payload is
        a pure function of (prog, stamp, row key), so cross-sender cache
        hits are sound."""
        if not isinstance(entries, Frontier) or entries.ragged is None \
                or entries.ragged.keys is None:
            return entries
        cache = self._nbr_cache.setdefault((name, stamp.key()), {})
        rg, n = fill_ragged_rows(entries.ragged, cache)
        if n:
            self.sim.counters.nbr_rows_cached += n
            entries.ragged = rg
        ln = rg.lens()
        for i in np.nonzero(ln > 0)[0].tolist():
            k = int(rg.keys[i])
            if k not in cache:
                sl = slice(int(rg.offsets[i]), int(rg.offsets[i + 1]))
                cache[k] = (rg.values[sl].copy(),
                            {c: v[sl].copy()
                             for c, v in rg.extra.items()})
        return entries

    def _dedup_ship(self, fr: Frontier, sid: int, target,
                    name: str, stamp: Stamp) -> Frontier:
        """Sender half: rows already shipped to this (shard,
        incarnation) under this (prog, stamp) go out as zero-length
        markers (keys kept); the FIFO channel guarantees the earlier
        full row arrives first, and a promoted receiver's fresh
        incarnation never matches old shipped sets."""
        rg = fr.ragged
        if rg is None or rg.keys is None or len(rg) == 0:
            return fr
        shipped = self._shipped_rows.setdefault(
            (sid, getattr(target, "incarnation", 0), name, stamp.key()),
            set())
        ln = rg.lens()
        mask = np.zeros(len(rg), bool)
        for i, k in enumerate(rg.keys.tolist()):
            if ln[i] == 0:
                continue
            if k in shipped:
                mask[i] = True
            else:
                shipped.add(k)
        if mask.any():
            fr.ragged = blank_ragged_rows(rg, mask)
        return fr

    # ------------------------------------------------------------------ ordering
    def _order(self, a: Stamp, b: Stamp, kind_a: int, kind_b: int) -> Order:
        """Order two stamps, refining through the oracle when concurrent.

        Charges ``oracle_rtt`` stall on cache miss.  Returns BEFORE if a ≺ b.
        """
        o = compare(a, b)
        if o is not Order.CONCURRENT:
            return o
        ck = (a.key(), b.key())
        hit = self._order_cache.get(ck)
        if hit is not None:
            self.sim.counters.oracle_cache_hits += 1
            return hit
        self.sim.counters.oracle_calls += 1
        self._stall += self.cost.oracle_rtt
        chain = self.oracle.oracle.order_events([a, b], [kind_a, kind_b])
        o = Order.BEFORE if chain[0] == a.key() else Order.AFTER
        self._order_cache[ck] = o
        self._order_cache[(b.key(), a.key())] = (
            Order.AFTER if o is Order.BEFORE else Order.BEFORE)
        return o

    def _order_heads(self, heads: List[Tuple[int, _QueueItem]]) -> int:
        """Pick the gatekeeper id whose head executes next."""
        gid, best = heads[0]
        conc: List[Tuple[int, _QueueItem]] = []
        for g, item in heads[1:]:
            o = compare(item.stamp, best.stamp)
            if o is Order.BEFORE:
                gid, best = g, item
                conc = [c for c in conc
                        if compare(c[1].stamp, best.stamp) is Order.CONCURRENT]
            elif o is Order.CONCURRENT:
                conc.append((g, item))
        if not conc:
            return gid
        # Fast path: NOPs are effect-free and never conflict, so a NOP in
        # the concurrent-minimal set can execute first without the oracle
        # (the paper's oracle is only for transactions that may conflict).
        for g, item in [(gid, best)] + conc:
            if item.kind == "nop":
                return g
        # one oracle request for the whole concurrent set (paper §4.1)
        group = [(gid, best)] + conc
        stamps = [it.stamp for _, it in group]
        keys = [s.key() for s in stamps]
        # local cache: all pairs known?
        known = all(
            self._order_cache.get((keys[i], keys[j])) is not None
            for i in range(len(keys)) for j in range(i + 1, len(keys)))
        if known:
            self.sim.counters.oracle_cache_hits += 1
        else:
            self.sim.counters.oracle_calls += 1
            self._stall += self.cost.oracle_rtt
            chain = self.oracle.oracle.order_events(stamps,
                                                    [KIND_TX] * len(stamps))
            pos = {k: i for i, k in enumerate(chain)}
            for i in range(len(keys)):
                for j in range(len(keys)):
                    if i != j:
                        self._order_cache[(keys[i], keys[j])] = (
                            Order.BEFORE if pos[keys[i]] < pos[keys[j]]
                            else Order.AFTER)
        # winner = minimal under cached order
        win_g, win = group[0]
        for g, item in group[1:]:
            if self._order_cache.get((item.stamp.key(), win.stamp.key())) is Order.BEFORE:
                win_g, win = g, item
        return win_g

    # ------------------------------------------------------------------ drain
    def _kick(self) -> None:
        if not self.busy and self.alive:
            self._drain()

    def _drain(self) -> None:
        if self.busy or not self.alive:
            return
        self._stall = 0.0
        # 1) runnable node program? (stamp ≺ every queue head; §4.2)
        idx = self._runnable_prog_index()
        if idx is not None:
            prog = self.pending_progs.pop(idx)
            if self.replicated:
                self._settle_stamp(prog["stamp"])
            extra = self._coalesce_pending(prog) if self.coalesce else []
            service = self._exec_prog(
                prog["prog_id"], prog["delivery_id"], prog["name"],
                prog["stamp"], prog["entries"], prog["coordinator"],
                extra_ids=extra)
            tr = self.sim.tracer
            if tr is not None:
                ctx = tr.ctx_for_prog(prog["prog_id"])
                if ctx is not None:
                    now = self.sim.now
                    st = stamp_attr(prog["stamp"])
                    tr.span("shard_queue", prog.get("t", now), now,
                            actor=self.name, ctx=ctx, shard=self.sid,
                            stamp=st)
                    t = now
                    if self._stall > 0:
                        tr.span("oracle_refine", t, t + self._stall,
                                actor=self.name, ctx=ctx, stamp=st)
                        t += self._stall
                    e = prog["entries"]
                    tr.span("frontier_hop", t, t + service,
                            actor=self.name, ctx=ctx, shard=self.sid,
                            stamp=st, plan=self._last_plan_kind,
                            depth=getattr(e, "depth", 0), entries=len(e))
            self._finish_after(service + self._stall)
            return
        # 2) transactions: need every queue non-empty (Fig. 6)
        if all(self.queues[g] for g in range(self.n_gk)):
            heads = [(g, self.queues[g][0]) for g in range(self.n_gk)]
            g = self._order_heads(heads)
            if self.queues[g][0].kind == "txbatch":
                service = self._exec_batch_prefix(g)
            else:
                item = self.queues[g].popleft()
                service = self._exec_item(item, g)
            self._finish_after(service + self._stall)
            return
        # idle: wait for the next enqueue/NOP

    def _finish_after(self, service: float) -> None:
        self.busy = True
        self.sim.schedule(max(service, 1e-7), self._finished)

    def _finished(self) -> None:
        self.busy = False
        self._drain()

    def _runnable_prog_index(self) -> Optional[int]:
        """A program runs once every gatekeeper queue is *cleared*:
        its head stamp is (or is refined to be) after T_prog.  Per-GK
        stamps are monotone and oracle decisions transitive, so a queue
        cleared once stays cleared for this program — each program pays
        at most one refinement per gatekeeper (§4.2 + transitivity).
        Concurrent NOP heads are ordered AFTER the program (they are
        effect-free; the commitment at the oracle is what pins all later
        transactions from that gatekeeper behind the program).  Concurrent
        *transaction* heads take the paper's default — write before
        program — so the program waits for them.
        """
        if not self.pending_progs:
            return None
        for g in range(self.n_gk):
            if not self.queues[g]:
                return None
        from .oracle import CycleError
        for i, prog in enumerate(self.pending_progs):
            stamp = prog["stamp"]
            cleared = prog["cleared"]
            ok = True
            for g in range(self.n_gk):
                if g in cleared:
                    continue
                head = self.queues[g][0]
                o = compare(stamp, head.stamp)
                if o is Order.BEFORE:
                    cleared.add(g)
                    continue
                if o is not Order.CONCURRENT:
                    ok = False
                    continue
                if head.kind == "nop":
                    # A concurrent NOP head needs NO oracle: it is
                    # effect-free and will pop quickly; once the announce
                    # gossip makes a later head dominate T_prog, per-GK
                    # clock monotonicity pins every later item after the
                    # program with no commitment needed.  Just wait.
                    ok = False
                else:
                    # real transaction: paper default, write ≺ program
                    o = self._order(stamp, head.stamp, KIND_PROG, KIND_TX)
                    if o is Order.BEFORE:
                        cleared.add(g)
                    else:
                        ok = False
            if ok and len(cleared) == self.n_gk:
                return i
        return None

    # ------------------------------------------------------------------ execute
    def _ack_applied(self, gid: int, stamps: List[Stamp]) -> None:
        """Read-your-writes: tell the forwarding gatekeeper these tx
        stamps are applied here (it releases deferred client acks).
        Dedup-skipped stamps ack too — the write IS in the partition."""
        if not self.ack_applies or not stamps:
            return
        gk = (self.gatekeepers[gid]
              if gid < len(self.gatekeepers) else None)
        if gk is None or not getattr(gk, "alive", False):
            return
        keys = [s.key() for s in stamps]
        self.sim.send(self, gk, gk.on_shard_ack, keys, self.sid,
                      nbytes=32 + 16 * len(keys))

    def _exec_item(self, item: _QueueItem, gid: int) -> float:
        if item.kind == "nop":
            return 0.2e-6
        if self._crash_point("mid_shard_apply"):
            return 0.0                   # died mid-drain; recovery replays
        ops = item.payload or []
        ts = item.stamp
        tr = self.sim.tracer
        ctx = tr.ctx_for_stamp(ts) if tr is not None else None
        if ts.key() in self._applied:    # re-forwarded after a recovery
            self.sim.counters.shard_dedup_skips += 1
            if ctx is not None:
                tr.span("shard_dedup", self.sim.now, self.sim.now,
                        actor=self.name, ctx=ctx, shard=self.sid,
                        stamp=stamp_attr(ts))
            self._ack_applied(gid, [ts])
            return 0.2e-6
        for op in ops:
            # KeyError here would be replica divergence (store validated)
            self.partition.apply_op(op, ts)
        self._applied[ts.key()] = ts
        self._applied_at[ts.key()] = self.sim.now
        if self.replicated:
            self.feed_log.append((ts, list(ops)))
        self._ack_applied(gid, [ts])
        service = self.cost.shard_op * max(1, len(ops))
        if ctx is not None:
            now = self.sim.now
            st = stamp_attr(ts)
            tr.span("shard_queue", item.t, now, actor=self.name, ctx=ctx,
                    shard=self.sid, stamp=st)
            # oracle stall from head ordering precedes the apply work
            tr.span("shard_apply", now + self._stall,
                    now + self._stall + service, actor=self.name, ctx=ctx,
                    shard=self.sid, incarnation=self.incarnation, stamp=st)
        return service

    def _exec_batch_prefix(self, g: int) -> float:
        """Apply the safe prefix of the ``txbatch`` at queue ``g``'s head
        as ONE bulk column append.

        A ``WriteBatch`` delivers a whole gatekeeper window as one queue
        item, but executing it atomically would let a LATER item of an
        earlier-ordered batch jump ahead of a cross-gatekeeper
        dependency still waiting at another queue head (the store
        committed ``T_a ≺ T_b`` — e.g. delete-then-recreate — but only
        per-item head ordering enforces it here).  So: the head item
        always runs (it just won ``_order_heads``, and no program was
        runnable this turn), and the prefix extends while the next
        item's stamp is strictly vector-before EVERY other queue head
        AND every pending program stamp — unambiguous with no oracle
        traffic.  The program bound matters because the per-tx loop
        re-checks runnable programs between every applied item: an
        item merely CONCURRENT with a gated program may be
        oracle-ordered after it (and e.g. a re-create would destroy
        property history the program must still read), so it has to
        wait for the normal loop; items strictly before the program
        are visible at its stamp either way, so applying them early is
        indistinguishable.  The remainder is requeued as the new head
        (its first stamp becomes the head stamp for program gating /
        head ordering), and the normal loop — oracle refinement
        included — interleaves it against the other queues, which is
        exactly per-tx semantics.  The uncontended case (all other
        heads dominate the window, no gated programs) applies the
        whole batch in one ``MVGraphPartition.apply_batch`` — one
        stamp-matrix append + one patch-log extend per table.

        Reorder buffer (cross-gatekeeper contention): under heavy
        concurrency every other queue head is ALSO a txbatch whose
        stamps interleave with ours, so the strict-before prefix above
        collapses to one item per turn — per-item interleaving with a
        full service round each.  Instead, treat this batch plus every
        other queue's head txbatch as candidate streams and k-way-merge
        their runnable prefixes into ONE bulk apply: an item is
        consumed when its stamp is strictly vector-before every other
        stream's next unconsumed item, every non-batch queue head, and
        every pending program stamp.  Per-gatekeeper stamps are
        elementwise monotone (a gk's vector only grows), so a stream's
        next item bounds everything later in that stream, and strict
        vector-before is transitive — the consumed sequence is exactly
        the order the per-item loop would have applied, with no oracle
        traffic.  A stream that runs dry is bounded by the next item
        behind it in its queue; with nothing behind it the merge stops
        (a future item from that gatekeeper could order anywhere).
        Acks are routed per ORIGIN gatekeeper, and partially consumed
        foreign batches are requeued as their queue's new head —
        identical to the single-stream remainder contract."""
        item = self.queues[g].popleft()
        wb: WriteBatch = item.payload
        items = wb.items
        if self._crash_point("mid_shard_apply"):
            # die partway through the window: a prefix of the batch is
            # applied, the rest is lost with the server (recovery
            # replays the whole window from the store's log)
            self._apply_deduped(items[:max(1, len(items) // 2)])
            return 0.0
        fixed_bounds = [p["stamp"] for p in self.pending_progs]
        streams: Dict[int, List[Tuple[Stamp, List[dict]]]] = {g: items}
        arr: Dict[int, float] = {g: item.t}   # queue arrival per stream
        for h in range(self.n_gk):
            if h == g or not self.queues[h]:
                continue
            head = self.queues[h][0]
            if head.kind == "txbatch":
                streams[h] = head.payload.items
                arr[h] = head.t
            else:
                fixed_bounds.append(head.stamp)
        ci = {h: 0 for h in streams}     # consumed-prefix cursor per stream
        consumed: List[Tuple[Stamp, List[dict]]] = [items[0]]
        origin: List[int] = [g]
        ci[g] = 1

        def bound_of(h: int) -> Optional[Stamp]:
            s = streams[h]
            if ci[h] < len(s):
                return s[ci[h]][0]
            if h == g:                   # this batch was popped already
                return self.queues[g][0].stamp if self.queues[g] else None
            if len(self.queues[h]) > 1:  # next item behind the head batch
                return self.queues[h][1].stamp
            return None                  # unknown future: blocks the merge

        progress = True
        while progress:
            progress = False
            for h in streams:
                i = ci[h]
                s = streams[h]
                if i >= len(s):
                    continue
                cand = s[i][0]
                ok = all(compare(cand, b) is Order.BEFORE
                         for b in fixed_bounds)
                if ok:
                    for k in streams:
                        if k == h:
                            continue
                        b = bound_of(k)
                        if b is None or compare(cand, b) is not Order.BEFORE:
                            ok = False
                            break
                if ok:
                    consumed.append(s[i])
                    origin.append(h)
                    ci[h] = i + 1
                    progress = True
        n_merged = sum(1 for h in origin if h != g)
        if n_merged:
            self.sim.counters.crossgk_batch_merges += 1
            self.sim.counters.crossgk_merged_txs += n_merged
        pre_applied = {s.key() for s, _ in consumed
                       if s.key() in self._applied}
        n_ops = self._apply_deduped(consumed)
        tr = self.sim.tracer
        if tr is not None:
            now = self.sim.now
            t = now + self._stall        # head-ordering stall, then apply
            for (s, ops), h in zip(consumed, origin):
                ctx = tr.ctx_for_stamp(s)
                if s.key() in pre_applied:
                    if ctx is not None:
                        tr.span("shard_dedup", now, now, actor=self.name,
                                ctx=ctx, shard=self.sid,
                                stamp=stamp_attr(s))
                    continue
                dt = self.cost.shard_op * max(1, len(ops))
                if ctx is not None:
                    st = stamp_attr(s)
                    tr.span("shard_queue", arr.get(h, now), now,
                            actor=self.name, ctx=ctx, shard=self.sid,
                            stamp=st)
                    tr.span("shard_apply", t, t + dt, actor=self.name,
                            ctx=ctx, shard=self.sid,
                            incarnation=self.incarnation, stamp=st,
                            batched=True)
                t += dt
        by_origin: Dict[int, List[Stamp]] = {}
        for (s, _), h in zip(consumed, origin):
            by_origin.setdefault(h, []).append(s)
        for h, stamps in by_origin.items():
            self._ack_applied(h, stamps)
        if ci[g] < len(items):
            self.queues[g].appendleft(_QueueItem(
                items[ci[g]][0], "txbatch", WriteBatch(items[ci[g]:])))
        for h in streams:
            if h == g or ci[h] == 0:
                continue
            self.queues[h].popleft()
            rest = streams[h][ci[h]:]
            if rest:
                self.queues[h].appendleft(_QueueItem(
                    rest[0][0], "txbatch", WriteBatch(rest)))
        return self.cost.shard_op * max(1, n_ops)

    def _apply_deduped(self, items: List[Tuple[Stamp, List[dict]]]) -> int:
        """Bulk-apply skipping stamps the partition already holds."""
        fresh = [(s, ops) for s, ops in items
                 if s.key() not in self._applied]
        if len(fresh) < len(items):
            self.sim.counters.shard_dedup_skips += len(items) - len(fresh)
        n = self.partition.apply_batch(fresh)
        for s, ops in fresh:
            self._applied[s.key()] = s
            self._applied_at[s.key()] = self.sim.now
            if self.replicated:
                self.feed_log.append((s, list(ops)))
        return n

    def _refine_batch(self, stamps: List[Stamp], at: Stamp) -> Dict:
        """ONE oracle round trip for a batch of stamps truly concurrent
        with ``at``; returns {stamp.key(): True iff stamp ≺ at}.  Uses
        (and fills) the pairwise order cache, charging ``oracle_rtt``
        only when at least one pair is unknown."""
        out: Dict = {}
        missing: List[Stamp] = []
        for s in stamps:
            hit = self._order_cache.get((s.key(), at.key()))
            if hit is None:
                missing.append(s)
            else:
                self.sim.counters.oracle_cache_hits += 1
                out[s.key()] = hit is Order.BEFORE
        if missing:
            self.sim.counters.oracle_calls += 1
            self._stall += self.cost.oracle_rtt
            chain = self.oracle.oracle.order_events(
                missing + [at], [KIND_TX] * len(missing) + [KIND_PROG])
            pos = {k: i for i, k in enumerate(chain)}
            p_at = pos[at.key()]
            for s in missing:
                before = pos[s.key()] < p_at
                o = Order.BEFORE if before else Order.AFTER
                self._order_cache[(s.key(), at.key())] = o
                self._order_cache[(at.key(), s.key())] = (
                    Order.AFTER if before else Order.BEFORE)
                out[s.key()] = before
        return out

    def _frontier_plan(self, stamp: Stamp) -> ShardPlan:
        """Cached sorted-CSR snapshot slice at ``stamp``, served from a
        small stamp-keyed LRU (budget ``plan_cache_entries``).

        A plan is reused as-is when the partition columns are unchanged
        AND (same stamp, or the cached plan is *settled* — every stamp
        in the columns strictly precedes its build stamp, so visibility
        is identical at every later stamp).  The settled case is the
        point-read hot path: a quiescent shard serves
        get_node/count_edges streams from ONE plan.

        When writes committed since the last build (``version`` moved),
        the plan is **delta-refreshed** (:meth:`ShardPlan.refresh`):
        patch-log tails and compaction remaps are consumed at O(changed)
        stamp work, so write traffic between program hops no longer
        degrades the batched path to cold rebuilds.  A cold rebuild
        happens only when (a) no cached plan's stamp is dominated by the
        query stamp (plans only move forward), or (b) the columns'
        bounded compaction-event history no longer covers the candidate
        plan's cursor — in which case the stale plan (settled or not) is
        DISCARDED, never reused for later stamps.

        The LRU replaces PR 3's single cached plan: two interleaved
        programs at mutually CONCURRENT stamps keep separate entries
        (neither stamp dominates the other, so neither plan can serve
        the other's query) instead of thrashing cold rebuilds per
        alternation; evictions beyond the budget count
        ``plan_cache_evictions``.  Service cost: a cold build charges
        ``prog_plan_row`` per column row, a delta refresh the same rate
        per re-evaluated row (``_plan_built_rows`` is drained by
        ``_exec_prog``)."""
        cols = self.partition.columns
        ctr = self.sim.counters
        key = stamp.key()
        cand: Optional[ShardPlan] = None
        cand_key = None
        hit = self._plans.get(key)
        if hit is not None and hit.cols is cols:
            cand, cand_key = hit, key
        else:
            # most-recently-used plan this stamp dominates (delta/reuse
            # candidate); concurrent-stamp plans stay untouched
            for k in reversed(self._plans):
                p = self._plans[k]
                if p.cols is cols and compare(p.at, stamp) in (
                        Order.BEFORE, Order.EQUAL):
                    cand, cand_key = p, k
                    break
        plan, kind = maintain_plan(
            cand, cols, stamp, self.n_gk,
            lambda ss, at=stamp: self._refine_batch(ss, at),
            allow_delta=self.plan_delta,
            device_plane=self.device_plane, device=self.device)
        self._last_plan_kind = kind or "reuse"
        if kind == "delta":
            ctr.plan_delta_refreshes += 1
            ctr.plan_rows_refreshed += plan.last_refresh_rows
            self._plan_built_rows += plan.last_refresh_rows
        elif kind == "cold":
            ctr.plan_cold_builds += 1
            self._plan_built_rows += plan.built_rows
            if cand is not None:
                # the candidate's cursor fell off the compaction
                # history: stale, must not serve any later stamp
                self._plans.pop(cand_key, None)
        if cand_key is not None and cand_key != plan.at.key():
            self._plans.pop(cand_key, None)   # re-key advanced plan
        self._plans[plan.at.key()] = plan
        self._plans.move_to_end(plan.at.key())
        while len(self._plans) > self.plan_cache_entries:
            self._plans.popitem(last=False)
            ctr.plan_cache_evictions += 1
        return plan

    def _coalesce_pending(self, prog: dict) -> List:
        """Merge every waiting same-(prog, stamp) Frontier delivery into
        ``prog``'s execution; returns the absorbed delivery ids.

        Without this, N source shards emitting to this shard in one hop
        queue N separate executions of the SAME program step — the event
        loop pays O(source shards) per hop per shard.  Merging
        concatenates the packed frontiers into ONE ``frontier_step``
        (O(1) executions per hop per shard) and charges the merged
        service cost once; the absorbed deliveries still report to the
        coordinator (empty, zero-entry reports) so termination counting
        is unaffected.

        Merging is legal only within one hop of one query: same prog_id,
        same stamp, same depth and identical meta (programs may rewrite
        meta between hops, e.g. ``block_render``), same payload
        presence, and only for programs whose ``coalesce_ok`` asserts
        step-concatenation invariance (see ``nodeprog.NodeProgram``).
        The runnable check already passed for ``prog``; queue-clearing
        state is shared per (shard, stamp), so every absorbed delivery
        was runnable too.

        Scalar deliveries coalesce symmetrically: waiting
        same-(prog_id, stamp) entry LISTS concatenate into one
        ``run_entries_scalar`` execution (the interpreter processes
        entries independently against shared per-program state, so
        concatenation invariance is the same ``coalesce_ok`` contract);
        scalar and packed deliveries never merge with each other."""
        base = prog["entries"]
        if not REGISTRY[prog["name"]].coalesce_ok:
            return []
        if not isinstance(base, Frontier):
            # ---- scalar path: concatenate same-(prog, stamp) lists
            merged_e: List = list(base)
            extra_s: List = []
            keep_s: List[dict] = []
            for p in self.pending_progs:
                if (p["prog_id"] == prog["prog_id"]
                        and p["name"] == prog["name"]
                        and p["stamp"].key() == prog["stamp"].key()
                        # a message-dup of an already-merged delivery must
                        # NOT concatenate its entries again; left queued,
                        # it re-executes and the coordinator dedups its
                        # same-id report
                        and p["delivery_id"] != prog["delivery_id"]
                        and p["delivery_id"] not in extra_s
                        and not isinstance(p["entries"], Frontier)):
                    merged_e.extend(p["entries"])
                    extra_s.append(p["delivery_id"])
                else:
                    keep_s.append(p)
            if extra_s:
                self.pending_progs = keep_s
                prog["entries"] = merged_e
                self.sim.counters.scalar_coalesced += len(extra_s)
            return extra_s
        merged = [base]
        extra: List = []
        keep: List[dict] = []
        for p in self.pending_progs:
            e = p["entries"]
            mergeable = (p["prog_id"] == prog["prog_id"]
                         and p["name"] == prog["name"]
                         and p["stamp"].key() == prog["stamp"].key()
                         # message-dup guard: same contract as the scalar
                         # branch above
                         and p["delivery_id"] != prog["delivery_id"]
                         and p["delivery_id"] not in extra
                         and isinstance(e, Frontier)
                         and e.depth == base.depth
                         and (e.vals is None) == (base.vals is None)
                         # ragged payload kinds merge only with their
                         # own kind: tags/ragged concatenate row-wise
                         # with tag re-base (_merge_frontiers)
                         and (e.tags is None) == (base.tags is None)
                         and (e.ragged is None) == (base.ragged is None))
            if mergeable:
                try:
                    mergeable = bool(e.meta == base.meta)
                except (TypeError, ValueError):   # exotic meta: keep apart
                    mergeable = False
            if mergeable:
                merged.append(e)
                extra.append(p["delivery_id"])
            else:
                keep.append(p)
        if extra:
            self.pending_progs = keep
            prog["entries"] = _merge_frontiers(merged)
            self.sim.counters.frontier_coalesced += len(extra)
        return extra

    def _frontier_of(self, name: str, entries) -> Optional[Frontier]:
        """Batched-path decision per delivery: already-packed frontiers
        stay batched; root entry lists pack iff the program has a
        vectorized step and accepts the (uniform) root params."""
        if isinstance(entries, Frontier):
            return entries
        if not self.use_frontier:
            return None
        prog = REGISTRY[name]
        if prog.frontier_step is None or prog.pack_root is None:
            return None
        if entries and not prog.frontier_ok(entries[0][1]):
            return None
        return prog.pack_root(entries, self.intern)

    def _exec_prog(self, prog_id: int, delivery_id, name: str, stamp: Stamp,
                   entries, coordinator, extra_ids: Optional[List] = None
                   ) -> float:
        prog = REGISTRY[name]
        states = self.prog_states.setdefault(prog_id, {})
        frontier = self._frontier_of(name, entries)
        children = []
        self._last_plan_kind = "scalar"  # _frontier_plan overwrites
        if frontier is not None:
            # ---- batched path: one vectorized step over the shard plan
            plan = self._frontier_plan(stamp)
            outputs, nxt, service = execute_step(
                plan, prog, frontier,
                states.setdefault("__frontier__", {}), self.intern,
                self.cost)
            if self._plan_built_rows:     # charge the (vectorized) build
                service += self.cost.prog_plan_row * self._plan_built_rows
                self._plan_built_rows = 0
            n_entries = len(frontier)
            self.sim.counters.prog_entries_delivered += n_entries
            for o in outputs:
                if isinstance(o, RaggedReply):
                    self.sim.counters.ragged_replies += 1
                    self.sim.counters.ragged_values += o.total()
            if nxt is not None:
                for sid, out_fr in self._route(nxt).items():
                    self.sim.counters.shard_hops += 1
                    child_id = (self.sid, self._next_delivery())
                    children.append(child_id)
                    target = self.peers[sid]
                    out_fr = self._dedup_ship(out_fr, sid, target, name,
                                              stamp)
                    self.sim.send(self, target, target.deliver_prog,
                                  prog_id, child_id, name, stamp, out_fr,
                                  coordinator, nbytes=out_fr.nbytes())
        else:
            # ---- scalar fallback: per-vertex interpreter
            refine = lambda a, b: self._order(a, b, KIND_TX, KIND_PROG)
            emits, outputs, service = run_entries_scalar(
                self.partition, prog, entries, stamp, refine, states,
                self.cost)
            n_entries = len(entries)
            self.sim.counters.prog_entries_delivered += n_entries
            # group scatter by destination shard (one message per shard;
            # §2.3) — but one ENTRY per emitted vertex
            by_shard: Dict[int, List[Tuple[str, object]]] = {}
            for dst_vid, params in emits:
                sid = self.directory(dst_vid)
                if sid is None:
                    continue
                by_shard.setdefault(sid, []).append((dst_vid, params))
            for sid, ent in by_shard.items():
                self.sim.counters.shard_hops += 1
                child_id = (self.sid, self._next_delivery())
                children.append(child_id)
                target = self.peers[sid]
                self.sim.send(self, target, target.deliver_prog, prog_id,
                              child_id, name, stamp, ent, coordinator,
                              nbytes=64 + 48 * len(ent))
        # termination detection: announced/reported delivery-id sets at the
        # coordinator (premature-zero-safe, unlike naive credit counting)
        self.sim.send(self, coordinator, coordinator.report, prog_id,
                      delivery_id, children, outputs,
                      frontier is not None, n_entries,
                      nbytes=64 + reply_nbytes(outputs))
        # deliveries absorbed by coalescing: their entries/outputs/children
        # were charged to the merged execution above; they still must
        # report so the coordinator's delivery-id sets close (zero-entry,
        # non-batched reports: counters see ONE execution)
        for did in (extra_ids or ()):
            self.sim.send(self, coordinator, coordinator.report, prog_id,
                          did, [], [], False, 0, nbytes=32)
        return service

    def _route(self, fr: Frontier) -> Dict[int, Frontier]:
        """Split a next-hop frontier into one packed message per
        destination shard (shared groupby with the synchronous driver;
        ragged side tables are subset per destination)."""
        return route_frontier(fr, self.intern, self.directory)

    def _next_delivery(self) -> int:
        self._delivery_ctr = getattr(self, "_delivery_ctr", 0) + 1
        return self._delivery_ctr

    # ------------------------------------------------------ change feed
    FEED_RETAIN = 1024       # feed entries kept past GC; a replica whose
    #                          cursor falls off the tail cold-resyncs

    @property
    def feed_pos(self) -> int:
        """Absolute change-feed position (monotone per incarnation)."""
        return self.feed_base + len(self.feed_log)

    def _settle_stamp(self, stamp: Stamp) -> None:
        """First runnable program at ``stamp``: bind it to the current
        feed position and tell the gatekeepers — any replica whose
        applied position reaches the token can serve reads at this stamp
        bit-identically (no write ordered before the stamp can appear
        after this instant; see the class-level feed comment)."""
        k = stamp.key()
        if k in self.settled:
            return
        if len(self.settled) > 10_000:    # size cap, like _prog_cleared;
            self.settled.clear()          # lost tokens just re-settle
        pos = self.feed_pos
        self.settled[k] = pos
        self.sim.counters.stamps_settled += 1
        for gk in self.gatekeepers:
            if getattr(gk, "alive", False):
                self.sim.send(self, gk, gk.on_settled, self.sid, k, pos,
                              self.incarnation, nbytes=48)

    def feed_pull(self, replica, cursor: int, sub_inc: int,
                  seq: int) -> None:
        """Serve a replica's change-feed pull: entries from ``cursor``
        plus the current settlement-token map.  A subscriber behind the
        truncated log tail — or subscribed to a previous incarnation —
        gets a full-state reset (redo-op walk of the live partition)."""
        if not self.alive:
            return
        self.sim.counters.replica_feed_pulls += 1
        tokens = dict(self.settled)
        if sub_inc != self.incarnation or cursor < self.feed_base:
            ops = self._walk_redo()
            self.sim.send(self, replica, replica.feed_reset,
                          self.incarnation, self.feed_pos, ops, tokens,
                          seq, nbytes=64 + 48 * len(ops))
            return
        entries = self.feed_log[cursor - self.feed_base:]
        self.sim.counters.replica_feed_entries += len(entries)
        nbytes = (64 + sum(32 + 48 * len(ops) for _, ops in entries)
                  + 24 * len(tokens))
        self.sim.send(self, replica, replica.feed_apply, cursor,
                      entries, tokens, self.incarnation, seq,
                      nbytes=nbytes)

    def _walk_redo(self) -> List[dict]:
        """Redo-op stream equivalent to replaying this partition's full
        history (the same multi-version rebuild contract as the store's
        ``recover_shard_walk``): applying these ops in order onto a fresh
        partition reproduces the current state bit-identically."""
        ops: List[dict] = []
        for vid in sorted(self.partition.vertices):
            v = self.partition.vertices[vid]
            ops.append({"op": "create_vertex", "vid": vid,
                        "ts": v.create_ts})
            for key, vers in sorted(v.props.items()):
                for ver in vers:
                    ops.append({"op": "set_vertex_prop", "vid": vid,
                                "key": key, "value": ver.value,
                                "ts": ver.ts})
            for eid in sorted(v.out_edges):
                e = v.out_edges[eid]
                ops.append({"op": "create_edge", "src": vid, "dst": e.dst,
                            "eid": eid, "ts": e.create_ts})
                for key, vers in sorted(e.props.items()):
                    for ver in vers:
                        ops.append({"op": "set_edge_prop", "src": vid,
                                    "eid": eid, "key": key,
                                    "value": ver.value, "ts": ver.ts})
                if e.delete_ts is not None:
                    ops.append({"op": "delete_edge", "src": vid,
                                "eid": eid, "ts": e.delete_ts})
            if v.delete_ts is not None:
                ops.append({"op": "delete_vertex", "vid": vid,
                            "ts": v.delete_ts})
        return ops

    def adopt_replica(self, rep, ops: List[dict]) -> int:
        """Failover fast path: promote a caught-up read replica by
        adopting its partition + applied map, then top up from the
        store's redo stream with only the ops the replica had not yet
        pulled — MTTR proportional to replica lag, not partition size.
        Returns the number of topped-up ops."""
        self.partition = rep.partition
        self._plans.clear()
        self._applied = dict(rep._applied)
        self._applied_at = dict(rep._applied_at)
        missing = [op for op in ops
                   if op["ts"].key() not in self._applied]
        tr = self.sim.tracer
        for op in missing:
            ts = op["ts"]
            self.partition.apply_op(op, ts)
            self._applied[ts.key()] = ts
            self._applied_at[ts.key()] = self.sim.now
            if tr is not None:
                ctx = tr.ctx_for_stamp(ts)
                if ctx is not None:
                    # same recovered-apply exemption as recover_from
                    tr.span("shard_apply", self.sim.now, self.sim.now,
                            actor=self.name, ctx=ctx, shard=self.sid,
                            incarnation=self.incarnation, recovered=True,
                            stamp=stamp_attr(ts))
        return len(missing)

    # ------------------------------------------------------------------ GC / recovery
    def collect(self, horizon: Stamp) -> int:
        # past-horizon dedup entries stay until no client retry session
        # can re-forward them anymore (BackingStore.RESULT_RETENTION is
        # the same bound for recorded tx outcomes)
        from .store import BackingStore
        keep_after = self.sim.now - BackingStore.RESULT_RETENTION
        drop = [k for k, s in self._applied.items()
                if compare(s, horizon) is Order.BEFORE
                and self._applied_at.get(k, self.sim.now) < keep_after]
        for k in drop:
            del self._applied[k]
            self._applied_at.pop(k, None)
        # wire-dedup caches: a stamp strictly before the horizon has no
        # outstanding program (the horizon is bounded by active stamps),
        # so its shipped sets / cached rows can never be referenced again
        for k in [k for k in self._shipped_rows
                  if compare(Stamp(k[3][0], k[3][1], k[3][2], 0),
                             horizon) is Order.BEFORE]:
            del self._shipped_rows[k]
        for k in [k for k in self._nbr_cache
                  if compare(Stamp(k[1][0], k[1][1], k[1][2], 0),
                             horizon) is Order.BEFORE]:
            del self._nbr_cache[k]
        # change-feed truncation: keep a bounded tail; a replica whose
        # cursor falls behind feed_base rebuilds via the redo walk
        if len(self.feed_log) > self.FEED_RETAIN:
            cut = len(self.feed_log) - self.FEED_RETAIN
            del self.feed_log[:cut]
            self.feed_base += cut
        return self.partition.collect(horizon)

    def recover_from(self, ops: List[dict]) -> None:
        """Backup promotion: rebuild the partition from the store's redo
        stream (WAL replay, or the ``vertices``-walk oracle when replay
        is off).  Every op dispatches through ``apply_op`` — including
        ``set_edge_prop`` — and its stamp is remembered, so slices of
        already-durable transactions re-forwarded by the exactly-once
        retry path are skipped, never double-applied."""
        self.partition = MVGraphPartition(self.n_gk, self.intern,
                                          prop_vals=self.prop_vals)
        self._plans.clear()              # plans referenced the old columns
        self._applied = {}
        self._applied_at = {}
        # fresh incarnation, fresh feed: subscribers detect the
        # incarnation change on their next pull and cold-resync
        self.feed_log = []
        self.feed_base = 0
        self.settled = {}
        for op in ops:
            ts = op["ts"]
            self.partition.apply_op(op, ts)
            self._applied[ts.key()] = ts
            self._applied_at[ts.key()] = self.sim.now
        tr = self.sim.tracer
        if tr is not None:
            # zero-width recovered-apply spans: the exactly-once checker
            # counts them toward shard coverage but exempts them from
            # the one-per-incarnation rule (replay is re-application by
            # design, not a double-apply bug)
            now = self.sim.now
            for ts in self._applied.values():
                ctx = tr.ctx_for_stamp(ts)
                if ctx is not None:
                    tr.span("shard_apply", now, now, actor=self.name,
                            ctx=ctx, shard=self.sid,
                            incarnation=self.incarnation, recovered=True,
                            stamp=stamp_attr(ts))

    def enter_epoch(self, epoch: int) -> None:
        """Cluster-manager barrier: fresh FIFO channels in the new epoch."""
        self._expected_seq = {g: 0 for g in range(self.n_gk)}
        self._stash = {g: {} for g in range(self.n_gk)}
