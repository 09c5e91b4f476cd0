"""Gatekeeper servers (paper §3.3, §4.1).

Responsibilities:
* assign a refinable timestamp (vector clock + epoch) to every incoming
  transaction and node program;
* exchange clock *announce* messages with the other gatekeepers every
  ``tau`` seconds (the proactive ordering stage);
* commit read-write transactions to the backing store *before* forwarding
  them to shard servers, enforcing ``T_upd ≺ T_tx`` with per-vertex
  last-update stamps — retrying with a fresh stamp on ``T_tx ≺ T_upd`` and
  refining through the timeline oracle on concurrency;
* send NOP transactions to every shard every ``tau_nop`` seconds so shard
  queues are never empty (progress under light load);
* forward node programs (stamped, unexecuted) to the shards owning their
  start vertices.

Group commit (``WeaverConfig.write_group_commit > 0``)
------------------------------------------------------
Transactions arriving within one admission window (``group_window``
seconds, capped at ``group_max``) are stamped in ONE ``_serve`` round
(each tx still gets its own fresh, unique ``(gk, ctr)`` stamp) and ship
to the backing store as ONE batch: :meth:`Gatekeeper._at_store_batch`
validates every write-set with one vectorized
:class:`~repro_torch.core.writepath.LastUpdateTable` compare, resolves the
truly-concurrent residue with ONE batched oracle round trip, commits
through :meth:`BackingStore.apply_batch` (one durability point), and
forwards ONE packed :class:`~repro_torch.core.writepath.WriteBatch` per
destination shard per window.  The batch applies in stamp order, so
same-vertex writers inside a window serialize by stamp while
independent writers commit together; a transaction that must retry
(stamped behind an executed write, or a refinement cycle) rejoins the
NEXT window with a fresh stamp — semantics identical to the per-tx
path, which remains the oracle (``write_group_commit = 0``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from .clock import Order, Stamp, compare, merge
from .obs import stamp_attr
from .oracle import KIND_TX, CycleError, OracleServer
from .simulation import PeriodicTimer, Simulator
from .store import BackingStore
from .writepath import (OK, RETRY, WriteBatch, classify_write_sets,
                        refine_commit)


@dataclass
class CostModel:
    """Per-operation CPU service times (seconds) for the simulated servers.

    Calibrated to the paper's hardware era (2.5 GHz Xeon, in-memory ops).
    """

    gk_stamp: float = 20.0e-6          # per-request gatekeeper CPU (parse,
                                       # stamp, validate route, forward) —
                                       # Fig. 12 implies ~40-50k req/s/GK
    store_op: float = 4.0e-6           # one KV op inside a store tx
    shard_op: float = 2.0e-6           # apply one write at a shard
    prog_vertex: float = 1.5e-6        # node-program visit, per vertex
    prog_revisit: float = 0.3e-6       # re-delivery to a visited vertex
    prog_edge: float = 0.15e-6         # node-program visit, per edge scanned
    prog_plan_row: float = 0.01e-6     # frontier-plan (re)build, per column
                                       # row — one vectorized visibility +
                                       # sort pass, ~10ns/row amortized
    gk_batch_tx: float = 2.0e-6        # per-tx CPU inside a group-commit
                                       # flush: stamping is one vector-
                                       # clock tick and validation/route
                                       # run vectorized over the whole
                                       # window, so the per-request parse/
                                       # dispatch overhead (gk_stamp) is
                                       # paid once per window instead of
                                       # once per tx
    gk_batch_prog: float = 2.0e-6      # per-program CPU inside a windowed
                                       # read-admission flush (the read-
                                       # side mirror of gk_batch_tx: one
                                       # shared stamp, vectorized routing)
    bsp_update: float = 3.0e-6         # GraphLab engine overhead per vertex
                                       # update (scheduler + state commit;
                                       # OSDI'12 reports ~0.1-0.3M
                                       # updates/s/machine on such graphs)
    oracle_rtt: float = 350e-6         # shard->oracle->shard incl. Paxos
    lock_op: float = 1.0e-6            # 2PL baseline: acquire/release


MAX_RETRIES = 16


class AdaptiveWindow:
    """AIMD admission-window controller (the classic group-commit
    refinement, applied to both the write and the read window).

    ``current`` starts at zero so an idle server stamps each request
    immediately — no latency tax on light traffic.  Every flush reports
    its batch size and the server's serve backlog (seconds of queued CPU
    at the flush instant).  A full window (``n >= cap``) or any serve
    backlog grows the window multiplicatively toward ``max_window``
    (entering at a floor of ``max_window * floor_frac``); a singleton
    flush on an idle server halves it back toward zero.  The backlog
    signal is what makes growth possible from ``current == 0``: with a
    zero window every flush has batch size 1, so batch size alone could
    never trigger growth."""

    __slots__ = ("max_window", "floor", "grow", "shrink", "current")

    def __init__(self, max_window: float, floor_frac: float = 1.0 / 16.0,
                 grow: float = 2.0, shrink: float = 0.5):
        self.max_window = max_window
        self.floor = max_window * floor_frac
        self.grow = grow
        self.shrink = shrink
        self.current = 0.0

    def on_flush(self, n: int, cap: int, backlog: float,
                 peer_load: float = 0.0) -> Optional[str]:
        """Observe one closed window: ``n`` requests flushed against a
        cap of ``cap``, with ``backlog`` seconds of serve queue.

        ``peer_load`` is the deployment-level load signal (max of the
        OTHER gatekeepers' recent backlog/shed gauges, read from the
        metrics registry when ``shared_load_signal`` is on): a window
        grows on peer saturation even when the local server is idle, so
        NACK-rerouted traffic landing here finds an already-open window
        instead of slowly ramping the local AIMD from zero — one
        saturated gatekeeper stops shedding while its peers idle below
        their windows.  Returns "local"/"peer" naming the growth
        trigger, or None."""
        if n >= cap or backlog > 0.0:
            self.current = min(self.max_window,
                               max(self.current * self.grow, self.floor))
            return "local"
        if peer_load > 0.0:
            self.current = min(self.max_window,
                               max(self.current * self.grow, self.floor))
            return "peer"
        if n <= 1:
            nxt = self.current * self.shrink
            self.current = nxt if nxt >= self.floor else 0.0
        return None


# sentinel error string a shed NACK carries in the tx reply path; the
# client session intercepts it (re-route within the attempt) instead of
# surfacing it as a commit failure
SHED_NACK = "__shed_nack__"


class Gatekeeper:
    def __init__(self, sim: Simulator, gid: int, n_gk: int,
                 store: BackingStore, oracle: OracleServer,
                 cost: CostModel, tau: float, tau_nop: float,
                 group_window: float = 0.0, group_max: int = 64,
                 read_window: float = 0.0, read_group_max: int = 128,
                 adaptive: bool = False, admission_limit: int = 0,
                 ack_on_apply: bool = False, nack_shed: bool = True,
                 shared_load_signal: bool = False,
                 read_window_alias: bool = True):
        self.sim = sim
        sim.register(self)
        self.gid = gid
        self.name = f"gk{gid}"          # fault-injection crash-point id
        self.n_gk = n_gk
        self.store = store
        self.oracle = oracle
        self.cost = cost
        self.clock: List[int] = [0] * n_gk
        self.epoch = 0
        self.peers: List["Gatekeeper"] = []
        self.shards: List[object] = []
        self._seq: Dict[int, int] = {}
        self.paused = False
        self._pause_buffer: List[Tuple] = []
        self.alive = True
        self.tau = tau
        self.tau_nop = tau_nop
        self._timers: List[PeriodicTimer] = []
        self._busy_until = 0.0
        # group-commit admission (0 = per-tx path)
        self.group_window = group_window
        self.group_max = max(1, group_max)
        self._group: List[Tuple] = []       # (client, ops, reply, retries, t)
        self._group_flush_pending = False
        self._group_gen = 0                 # invalidates stale window timers
        # windowed read admission (0 = per-program path, the oracle)
        self.read_window = read_window
        self.read_group_max = max(1, read_group_max)
        self._rgroup: List[Tuple] = []      # (coordinator, name, entries, pid)
        self._rgroup_flush_pending = False
        self._rgroup_gen = 0                # invalidates stale window timers
        # adaptive AIMD controllers (None = fixed configured window)
        self._wwin = AdaptiveWindow(group_window) \
            if adaptive and group_window > 0 else None
        self._awin = AdaptiveWindow(read_window) \
            if adaptive and read_window > 0 else None
        # load leveling: admitted-but-unstamped requests (open windows +
        # the serve queue); past admission_limit new arrivals are shed
        # and the client session's ack timeout recovers them (0 = off)
        self.admission_limit = admission_limit
        self._admitted = 0
        # shed NACKs: answer a shed with an explicit reject so sessions
        # re-route within the same attempt instead of waiting out the
        # ack timer (False = silent shed, the PR 7 behavior)
        self.nack_shed = nack_shed
        # read-your-writes: defer tx acks until every destination shard
        # applied; stamp-key -> {"waiting": shard ids, "replies": [...]}
        self.ack_on_apply = ack_on_apply
        self._pending_acks: Dict[Tuple, dict] = {}
        # deployment-level load signal: publish this server's backlog /
        # shed pressure as a metrics gauge and let the AIMD windows grow
        # on PEER saturation (NACK-rerouted traffic finds open windows)
        self.shared_load_signal = shared_load_signal
        # cross-window read sharing: when the LastUpdateTable mutation
        # seqno did not move since the previous read window, reuse that
        # window's stamp — every shard plan / oracle cache / queue-
        # clearing entry keyed by it fires warm (ROADMAP item)
        self.read_window_alias = read_window_alias
        self._last_read_stamp: Optional[Stamp] = None
        self._last_read_mut = -1
        # deployment pod (None = unplaced; Weaver assigns when pods > 1)
        self.pod: Optional[int] = None
        # replica read routing (repro_torch.core.replica): Weaver wires the
        # {sid: [ReplicaShard, ...]} map; primaries broadcast settlement
        # tokens (stamp -> feed position, incarnation-tagged) and
        # replicas advertise applied frontiers.  A settled-stamp read
        # window ships to a caught-up replica (in-pod preferred,
        # round-robin), falling back to the primary otherwise.
        self.replicas: Dict[int, List[object]] = {}
        self._settled: Dict[Tuple, Tuple[int, int]] = {}
        self._replica_front: Dict[Tuple[int, int], Tuple[int, int]] = {}
        self._rr_replica = 0

    # -- wiring ---------------------------------------------------------------
    def start(self, peers: List["Gatekeeper"], shards: List[object]) -> None:
        self.peers = [p for p in peers if p is not self]
        self.shards = shards
        self._seq = {i: 0 for i in range(len(shards))}
        stagger = 1e-6 * (self.gid + 1)
        if self.tau > 0:
            self._timers.append(PeriodicTimer(
                self.sim, self.tau, self._announce, start_delay=self.tau + stagger))
        if self.tau_nop > 0:
            self._timers.append(PeriodicTimer(
                self.sim, self.tau_nop, self._send_nops,
                start_delay=self.tau_nop + stagger))

    def stop(self) -> None:
        self.alive = False
        for t in self._timers:
            t.cancel()
        # transactions admitted to a still-open group window die with
        # the server, exactly like per-tx messages in flight to a dead
        # gatekeeper: unreplied client sessions time out and resubmit
        # to the promoted backup (§4.3).  Counted, so tests can assert
        # the retry layer recovered every one of them.
        self.sim.counters.group_txs_lost += len(self._group)
        self._group.clear()
        # reads admitted to a still-open window die the same way; their
        # sessions (read_retry_timeout > 0) resubmit to the promoted
        # backup, exactly like tx sessions
        self.sim.counters.read_progs_lost += len(self._rgroup)
        self._rgroup.clear()
        self._pending_acks.clear()

    def _crash_point(self, point: str) -> bool:
        """Fault-injection hook: die here if the plan says so."""
        f = self.sim.fault
        if f is not None and f.crash(point, self.name):
            self.alive = False
            return True
        return False

    def _serve(self, service: float, fn, *args) -> None:
        """Serialize request handling: the gatekeeper is a single-threaded
        server with ``gk_stamp`` CPU per request (this is what makes
        Fig. 12's gatekeeper-count scaling measurable)."""
        start = max(self.sim.now, self._busy_until)
        self._busy_until = start + service
        self.sim.schedule(self._busy_until - self.sim.now, fn, *args)

    def _observe_admission(self, kind: str, window: float, depth: int,
                           backlog: float) -> None:
        """One closed admission window (``kind`` = "r"/"w") into the
        metrics registry: window-length and batch-depth histograms
        (power-of-two buckets; these replace the ad-hoc
        ``Counters.admission_*_hist`` dict fields) plus this server's
        load gauge (backlog seconds) and effective-window gauge for the
        sampled timeline and the shared AIMD load signal."""
        m = self.sim.metrics
        m.observe(f"admission_window_us_{kind}", window * 1e6)
        m.observe(f"admission_depth_{kind}", depth)
        m.gauge(f"gk_load:{self.gid}", backlog, self.sim.now)
        m.gauge(f"gk_window_{kind}:{self.gid}", window, self.sim.now)

    def _peer_load(self) -> float:
        """Max of the OTHER gatekeepers' recent load gauges (backlog
        seconds / shed pressure).  Samples older than ~10 admission
        windows are stale — a long-dead spike must not hold every
        window open."""
        horizon = max(1e-3, 10.0 * max(self.group_window, self.read_window))
        mine = f"gk_load:{self.gid}"
        vals = self.sim.metrics.gauge_values("gk_load:", horizon,
                                             self.sim.now)
        return max((v for k, v in vals.items() if k != mine), default=0.0)

    # -- clocks ----------------------------------------------------------------
    def _tick(self) -> Stamp:
        self.clock[self.gid] += 1
        return Stamp(self.epoch, tuple(self.clock), self.gid, self.clock[self.gid])

    def _announce(self) -> None:
        if not self.alive:
            return
        for p in self.peers:
            self.sim.counters.announce_messages += 1
            self.sim.send(self, p, p.on_announce, self.epoch, tuple(self.clock),
                          nbytes=8 * self.n_gk)

    def on_announce(self, epoch: int, clock: Tuple[int, ...]) -> None:
        if not self.alive or epoch != self.epoch:
            return
        self.clock = list(merge(self.clock, clock))

    def _send_nops(self) -> None:
        if not self.alive or self.paused:
            return
        stamp = self._tick()
        for sid, shard in enumerate(self.shards):
            self._seq[sid] += 1
            self.sim.counters.nop_messages += 1
            self.sim.send(self, shard, shard.enqueue, self.gid, self._seq[sid],
                          stamp, "nop", None, nbytes=8 * self.n_gk + 16)

    # -- epoch barrier (cluster manager, §4.3) ----------------------------------
    def pause_for_epoch(self) -> None:
        self.paused = True

    def enter_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self.clock = [0] * self.n_gk     # restart vector clock in new epoch
        self._seq = {i: 0 for i in range(len(self.shards))}  # fresh channels
        self._last_read_stamp = None     # old-epoch stamps must not alias
        self.paused = False
        buf, self._pause_buffer = self._pause_buffer, []
        for fn, args in buf:
            fn(*args)

    # -- transactions (§4.1) -----------------------------------------------------
    def submit_tx(self, client, ops: List[dict], reply: Callable,
                  retries: int = 0, t_submit: Optional[float] = None,
                  txid: object = None, ctx=None,
                  t_join: Optional[float] = None) -> None:
        if not self.alive:
            return  # the client session times out and resubmits (§4.3)
        if self.paused:
            self._pause_buffer.append((self.submit_tx,
                                       (client, ops, reply, retries,
                                        t_submit, txid, ctx, t_join)))
            return
        if t_submit is None:
            t_submit = self.sim.now
        tracer = self.sim.tracer
        if ctx is None and tracer is not None:
            ctx = tracer.current
        if t_join is None:
            t_join = self.sim.now
        if self.admission_limit and self._admitted >= self.admission_limit:
            # load leveling: shed past the depth bound — no serve round
            # is charged, and the client session's ack timeout resubmits
            # with backoff (PR 6 retry machinery), so overload turns
            # into delay instead of a collapsing serve queue
            self.sim.counters.txs_shed += 1
            m = self.sim.metrics
            m.count(f"gk_shed:{self.gid}")
            # shed = saturated: publish positive load for the shared
            # AIMD signal even when the serve queue itself is empty
            m.gauge(f"gk_load:{self.gid}",
                    max(self._busy_until - self.sim.now,
                        float(self._admitted)), self.sim.now)
            if self.nack_shed:
                # explicit reject: the session re-routes to the next
                # gatekeeper immediately instead of burning the timeout
                self.sim.counters.shed_nacks += 1
                self.sim.send(self, client, reply, False, SHED_NACK, None,
                              nbytes=32)
            return
        self._admitted += 1

        if self.group_window > 0:
            # ---- group-commit admission: join the open window --------
            self._group.append((client, ops, reply, retries, t_submit, txid,
                                ctx, t_join))
            if self._crash_point("mid_window"):
                # the admitted-but-unflushed window dies with the server
                self.sim.counters.group_txs_lost += len(self._group)
                self._admitted -= len(self._group)
                self._group.clear()
                return
            if len(self._group) >= self.group_max:
                self._flush_group()
            elif not self._group_flush_pending:
                delay = (self._wwin.current if self._wwin is not None
                         else self.group_window)
                if delay <= 0.0:         # adaptive window shrunk to zero:
                    self._flush_group()  # stamp immediately, stay latency-
                else:                    # neutral while the system is idle
                    self._group_flush_pending = True
                    self.sim.schedule(delay, self._flush_timer,
                                      self._group_gen)
            return

        def _go() -> None:
            self._admitted -= 1
            if not self.alive:
                return
            stamp = self._tick()
            tr = self.sim.tracer
            if tr is not None and tr.current is not None:
                t1 = self.sim.now
                t0 = t1 - self.cost.gk_stamp
                tr.span("gk_wait", t_join, t0, actor=self.name)
                tr.span("gk_stamp", t0, t1, actor=self.name,
                        stamp=stamp_attr(stamp))
                tr.bind_stamp(stamp, tr.current)
            # one RPC to the backing store carrying the whole transaction
            nbytes = 64 + 48 * len(ops)
            self.sim.send(self, self.store,
                          self._at_store, client, ops, stamp, reply,
                          retries, t_submit, txid, nbytes=nbytes)

        self._serve(self.cost.gk_stamp, _go)

    def _flush_timer(self, gen: int) -> None:
        """Window deadline.  A timer armed for a window that a
        max-count trigger already flushed must NOT fire into the next
        window (it would systematically shorten windows under load);
        the generation check makes it a no-op."""
        if gen == self._group_gen:
            self._flush_group()

    def _flush_group(self) -> None:
        """Close the admission window: stamp every pending tx in ONE
        serve round and ship the batch to the store as one message.

        Serve cost is ``gk_stamp`` once (parse/dispatch, amortized) plus
        ``gk_batch_tx`` per additional transaction; each tx still gets
        its own fresh ``_tick()`` stamp inside the serve callback, so
        stamp order == admission order == batch apply order."""
        self._group_flush_pending = False
        self._group_gen += 1
        if not self.alive or not self._group:
            return
        batch, self._group = self._group, []
        if self.paused:                 # re-buffer through the epoch barrier
            self._admitted -= len(batch)   # re-counted on barrier replay
            for tx in batch:
                self._pause_buffer.append((self.submit_tx, tx))
            return
        backlog = max(0.0, self._busy_until - self.sim.now)
        window = (self._wwin.current if self._wwin is not None
                  else self.group_window)
        if self._wwin is not None:
            peer = self._peer_load() if self.shared_load_signal else 0.0
            grew = self._wwin.on_flush(len(batch), self.group_max, backlog,
                                       peer)
            if grew == "peer":
                self.sim.counters.window_grows_shared += 1
        self._observe_admission("w", window, len(batch), backlog)
        service = (self.cost.gk_stamp
                   + self.cost.gk_batch_tx * (len(batch) - 1))
        wid = f"{self.name}:w{self._group_gen}"

        def _go() -> None:
            self._admitted -= len(batch)
            if not self.alive:
                return
            tr = self.sim.tracer
            t1 = self.sim.now
            stamped = []
            for client, ops, reply, retries, t_submit, txid, mctx, t_join \
                    in batch:
                stamp = self._tick()
                if tr is not None and mctx is not None:
                    # the window span is the parent of this member's
                    # stamping span: residency [join, flush+serve] with
                    # the shared window id, stamping nested inside
                    wctx = tr.span("window_wait", t_join, t1,
                                   actor=self.name, ctx=mctx, window=wid,
                                   kind="w")
                    tr.span("gk_stamp", t1 - service, t1, actor=self.name,
                            ctx=wctx, window=wid, stamp=stamp_attr(stamp))
                    tr.bind_stamp(stamp, mctx)
                stamped.append((client, ops, stamp, reply, retries,
                                t_submit, txid))
            if tr is not None:
                # the batch message has no single owning request; store-
                # side spans recover per-member contexts via stamp_ctx
                tr.current = None
            nbytes = 64 + sum(64 + 48 * len(t[1]) for t in stamped)
            self.sim.send(self, self.store, self._at_store_batch, stamped,
                          nbytes=nbytes)

        self._serve(service, _go)

    def _dedup_gate(self, client, reply, retries, txid) -> bool:
        """Exactly-once gate, evaluated at the store: a fresh client
        submission (``retries == 0``) of an already-decided txid is
        answered from ``store.tx_results`` (re-forwarding the committed
        slices in case the crash ate them); one already being validated
        is dropped (the session's next timeout covers the race).
        Internal retries keep their in-flight claim fresh instead.
        Returns True when the submission was consumed here."""
        if txid is None:
            return False
        if retries > 0:
            self.store.touch_inflight(txid)
            return False
        verdict = self.store.begin_tx_attempt(txid)
        if verdict == "inflight":
            return True
        if verdict != "done":
            return False
        self.sim.counters.tx_dedup_hits += 1
        ok, err, stamp, fwd, _ = self.store.tx_results[txid]
        if ok and fwd:
            # the original forwards may have died with the old server;
            # re-send them — shards skip stamps they already applied
            # (and still ack the skip in read-your-writes mode)
            self._forward(stamp, fwd)
        self._reply_after_apply(client, reply, ok, err, stamp,
                                fwd if ok else None)
        return True

    def _forward(self, stamp, fwd) -> None:
        """Send one committed tx's per-shard slices."""
        by_shard: Dict[int, List[dict]] = {}
        for sid, op in fwd:
            by_shard.setdefault(sid, []).append(op)
        for sid, slice_ops in by_shard.items():
            self._seq[sid] += 1
            shard = self.shards[sid]
            self.sim.send(self, shard, shard.enqueue, self.gid,
                          self._seq[sid], stamp, "tx", slice_ops,
                          nbytes=64 + 48 * len(slice_ops))

    # -- read-your-writes ack mode (WeaverConfig.read_your_writes) -----------
    def _reply_after_apply(self, client, reply, ok: bool, err, stamp,
                           fwd) -> None:
        """Send the client ack — or, in read-your-writes mode, defer it
        until every destination shard acked applying this tx's slices,
        so an acked write is visible to any subsequent read.  Aborts and
        shard-less commits ack immediately either way.  The registry is
        list-valued per stamp key because the dedup gate can re-forward
        (and so re-defer) an already-recorded commit whose original ack
        was lost."""
        if not (self.ack_on_apply and ok and fwd):
            self.sim.send(self.store, client, reply, ok, err, stamp, nbytes=64)
            return
        self.sim.counters.acks_deferred += 1
        rec = self._pending_acks.setdefault(
            stamp.key(), {"waiting": set(), "replies": []})
        rec["waiting"].update(sid for sid, _ in fwd)
        rec["replies"].append((client, reply, ok, err, stamp))

    def on_shard_ack(self, keys: List[Tuple], sid: int) -> None:
        """A shard applied the listed stamp keys; release any client
        acks waiting on them once all their shards reported."""
        if not self.alive:
            return
        for key in keys:
            rec = self._pending_acks.get(key)
            if rec is None:
                continue
            rec["waiting"].discard(sid)
            if not rec["waiting"]:
                del self._pending_acks[key]
                for client, reply, ok, err, stamp in rec["replies"]:
                    self.sim.send(self, client, reply, ok, err, stamp,
                                  nbytes=64)

    def _at_store(self, client, ops, stamp, reply, retries, t_submit,
                  txid) -> None:
        """Runs at the backing store: validate last-update stamps, then
        apply atomically.  Returns control to the gatekeeper.

        Validation repeats at the commit instant: another gatekeeper's
        window can apply between admission and this tx's durability
        point, and its writes must be ordered (refined) against this
        stamp before we commit, or a downstream shard could execute the
        two concurrent stamps in the opposite order.  ``seen`` keeps the
        revalidation loop finite — each round only refines last-update
        stamps recorded since the previous round."""
        cnt = self.sim.counters
        if not self.alive:
            return                         # in-flight work dies with the server
        tracer = self.sim.tracer
        if self._dedup_gate(client, reply, retries, txid):
            if tracer is not None:
                tracer.span("tx_dedup", self.sim.now, self.sim.now,
                            actor="store", stamp=stamp_attr(stamp))
            return
        tx = (client, ops, stamp, reply, retries, t_submit, txid)
        write_set = BackingStore.write_set(ops)
        seen: set = set()                  # last-update keys already refined
        table_seen = [-1]                  # LastUpdateTable.mutations at the
        #                                    last validation pass
        leg = [self.sim.now]               # [obs] start of the current
        #                                    store-leg stage (validate /
        #                                    refine round / commit)

        def _validate() -> Optional[List[Stamp]]:
            """Fresh concurrent residue, or None if a retry was issued."""
            table_seen[0] = self.store.last_updates.mutations
            fresh: List[Stamp] = []
            for vid in write_set:
                upd = self.store.last_update_of(vid)
                if upd is None:
                    continue
                o = compare(upd, stamp)
                if o is Order.AFTER:       # T_tx ≺ T_upd -> retry, fresh stamp
                    self._retry_or_abort(tx)
                    return None
                if o is Order.CONCURRENT and upd.key() not in seen:
                    fresh.append(upd)      # T_upd ≈ T_tx -> refine via oracle
            return fresh

        def _refine_then(fresh: List[Stamp], delay: float) -> None:
            # gatekeeper orders T_upd ≺ T_tx at the timeline oracle
            cnt.oracle_calls += 1
            seen.update(u.key() for u in fresh)

            def _refined() -> None:
                if tracer is not None:
                    tracer.span("oracle_refine", leg[0], self.sim.now,
                                actor="oracle", n_stamps=len(fresh),
                                stamp=stamp_attr(stamp))
                    leg[0] = self.sim.now
                try:
                    for upd in fresh:
                        self.oracle.oracle.create_event(upd)
                        self.oracle.oracle.create_event(stamp)
                        self.oracle.oracle.assert_order(upd.key(), stamp.key())
                except CycleError:
                    # same retry bound as the T_tx ≺ T_upd branch (and
                    # as the group path)
                    self._retry_or_abort(tx)
                    return
                _commit()
            self.sim.schedule(delay, _refined)

        def _commit() -> None:
            if not self.alive or self._crash_point("pre_wal"):
                return                     # nothing durable, nothing forwarded
            # revalidate at the commit instant — unless no last-update
            # stamp was recorded since the previous pass (unchanged
            # table ⇒ identical verdicts and an empty un-refined residue)
            if self.store.last_updates.mutations == table_seen[0]:
                cnt.revalidations_skipped += 1
            else:
                fresh = _validate()
                if fresh is None:
                    return
                if fresh:
                    _refine_then(fresh, self.cost.oracle_rtt)
                    return
            try:
                fwd = self.store.apply(ops, stamp, txid=txid)
            except ValueError as e:        # logical error -> abort, not forwarded
                cnt.tx_aborted += 1
                if tracer is not None:
                    tracer.span("store_commit", leg[0], self.sim.now,
                                actor="store", committed=False,
                                stamp=stamp_attr(stamp))
                self.store.record_result(txid, False, str(e), stamp)
                self.sim.send(self.store, client, reply, False, str(e), stamp,
                              nbytes=64)
                return
            cnt.tx_committed += 1
            if tracer is not None:
                tracer.span("store_commit", leg[0], self.sim.now,
                            actor="store", committed=True,
                            stamp=stamp_attr(stamp),
                            n_shards=len({sid for sid, _ in fwd}))
            if self._crash_point("post_wal"):
                return                     # durable but unforwarded/unacked:
            #                                the session's retry dedups + re-
            #                                forwards (exactly-once contract)
            # forward per-shard slices BEFORE acking, so an acked tx is
            # always either at its shards or recoverable from the log
            self._forward(stamp, fwd)
            # response to client: commit point is the backing store (§4.4
            # part 2); read-your-writes mode additionally holds the ack
            # until every destination shard applied
            self._reply_after_apply(client, reply, True, None, stamp, fwd)

        service = self.cost.store_op * max(1, len(ops))
        fresh = _validate()
        if fresh is None:
            return
        if fresh:
            _refine_then(fresh, self.cost.oracle_rtt + service)
        else:
            self.sim.schedule(service, _commit)

    def _resubmit(self, client, ops, reply, retries, t_submit, txid) -> None:
        self.submit_tx(client, ops, reply, retries, t_submit, txid)

    # -- group commit (§4.1/§4.4 batched; see module docstring) ---------------
    def _at_store_batch(self, batch: List[Tuple]) -> None:
        """Runs at the backing store: validate the whole window's
        write-sets with one vectorized ``LastUpdateTable`` compare,
        refine the truly-concurrent residue in ONE oracle round trip,
        group-commit the survivors (one durability point), and forward
        ONE packed ``WriteBatch`` per destination shard."""
        cnt = self.sim.counters
        if not self.alive:
            return                         # in-flight window dies with the server
        tracer = self.sim.tracer
        live_batch = []
        for t in batch:
            if self._dedup_gate(t[0], t[3], t[4], t[6]):
                if tracer is not None:
                    tracer.span("tx_dedup", self.sim.now, self.sim.now,
                                actor="store", ctx=tracer.ctx_for_stamp(t[2]),
                                stamp=stamp_attr(t[2]))
            else:
                live_batch.append(t)
        batch = live_batch
        if not batch:
            return
        cnt.tx_batches += 1
        cnt.tx_batch_size_sum += len(batch)
        stamps = [t[2] for t in batch]
        write_sets = [BackingStore.write_set(t[1]) for t in batch]
        seen: set = set()              # (upd key, tx key) pairs already refined
        table_seen = [-1]              # LastUpdateTable.mutations at the
        #                                last classification pass
        leg = [self.sim.now]           # [obs] start of the current store-leg
        #                                stage, shared by the window's members

        def _member_span(i: int, stage: str, t0: float, t1: float,
                         **attrs) -> None:
            """Record a store-leg span in member ``i``'s trace (contexts
            recovered through the tracer's stamp registry — the batch
            message itself has no single owning request)."""
            if tracer is None:
                return
            ctx = tracer.ctx_for_stamp(stamps[i])
            if ctx is not None:
                tracer.span(stage, t0, t1, actor="store", ctx=ctx,
                            stamp=stamp_attr(stamps[i]), **attrs)

        def _classify(idx: List[int]
                      ) -> Tuple[List[int],
                                 List[Tuple[int, Stamp, List[Stamp]]]]:
            """Validate ``idx`` against the CURRENT table; issue retries,
            return survivors plus the not-yet-refined concurrent residue."""
            table_seen[0] = self.store.last_updates.mutations
            verdicts, rows = classify_write_sets(
                self.store.last_updates,
                [write_sets[i] for i in idx], [stamps[i] for i in idx])
            cnt.conflict_rows_checked += rows
            ok_idx: List[int] = []
            residue: List[Tuple[int, Stamp, List[Stamp]]] = []
            for j, v in enumerate(verdicts):
                i = idx[j]
                if v.status == RETRY:  # T_tx ≺ T_upd: fresh stamp, next window
                    self._retry_or_abort(batch[i])
                    continue
                ok_idx.append(i)
                ups = [u for u in v.concurrent
                       if (u.key(), stamps[i].key()) not in seen]
                if ups:
                    residue.append((i, stamps[i], ups))
                    seen.update((u.key(), stamps[i].key()) for u in ups)
            return ok_idx, residue

        def _refine_then(residue, delay: float, cont: List[int]) -> None:
            # ONE batched oracle round trip for the whole residue
            cnt.oracle_calls += 1

            def _refined() -> None:
                for i, _, ups in residue:   # shared round, per-member span
                    _member_span(i, "oracle_refine", leg[0], self.sim.now,
                                 n_stamps=len(ups), batched=True)
                leg[0] = self.sim.now
                failed = set(refine_commit(self.oracle.oracle, residue))
                for i in failed:       # cycle: retry with a fresh stamp
                    self._retry_or_abort(batch[i])
                _commit([i for i in cont if i not in failed])
            self.sim.schedule(delay, _refined)

        def _commit(live_idx: List[int]) -> None:
            if not self.alive or self._crash_point("pre_wal"):
                return                 # window dies undurable, unacked
            # revalidate at the durability instant: other gatekeepers'
            # windows may have applied since admission, and their writes
            # must be refined against ours before shards see both —
            # skipped when the LastUpdateTable did not move since the
            # previous pass (unchanged table ⇒ identical verdicts and an
            # empty un-refined residue)
            if self.store.last_updates.mutations == table_seen[0]:
                cnt.revalidations_skipped += 1
            else:
                live_idx, residue = _classify(live_idx)
                if residue:
                    _refine_then(residue, self.cost.oracle_rtt, live_idx)
                    return
            if not live_idx:
                return
            torn = None
            if self.sim.fault is not None:
                torn = self.sim.fault.torn_limit(self.name)
            results = self.store.apply_batch(
                [(batch[i][1], stamps[i], batch[i][6]) for i in live_idx],
                torn_limit=torn)
            if torn is not None:
                self.alive = False     # died inside the group WAL append:
                return                 # a torn tail is on the log, no replies
            if self._crash_point("post_wal"):
                return                 # durable but unforwarded/unacked
            by_shard: Dict[int, List[Tuple[Stamp, List[dict]]]] = {}
            replies: List[Tuple] = []
            for i, (ok, err, fwd) in zip(live_idx, results):
                client, ops, stamp, reply = batch[i][:4]
                if not ok:             # logical error: this tx only
                    cnt.tx_aborted += 1
                    _member_span(i, "store_commit", leg[0], self.sim.now,
                                 committed=False, batched=True)
                    replies.append((client, reply, False, err, stamp, None))
                    continue
                cnt.tx_committed += 1
                _member_span(i, "store_commit", leg[0], self.sim.now,
                             committed=True, batched=True,
                             n_shards=len({sid for sid, _ in fwd}))
                replies.append((client, reply, True, None, stamp, fwd))
                per: Dict[int, List[dict]] = {}
                for sid, op in fwd:
                    per.setdefault(sid, []).append(op)
                for sid, slice_ops in per.items():
                    by_shard.setdefault(sid, []).append((stamp, slice_ops))
            # ONE packed WriteBatch per destination shard per window,
            # items in stamp order (= admission order); forwards go out
            # BEFORE the replies so an acked tx is always either at its
            # shards or recoverable from the log
            for sid, items in by_shard.items():
                self._seq[sid] += 1
                shard = self.shards[sid]
                wb = WriteBatch(items)
                self.sim.send(self, shard, shard.enqueue, self.gid,
                              self._seq[sid], wb.stamp, "txbatch", wb,
                              nbytes=wb.nbytes())
            # reply after the group's durability point (§4.4 part 2);
            # read-your-writes mode holds each commit's ack until its
            # destination shards applied
            for client, reply, ok, err, stamp, fwd in replies:
                self._reply_after_apply(client, reply, ok, err, stamp, fwd)

        live, pending_refine = _classify(list(range(len(batch))))
        total_ops = sum(len(batch[i][1]) for i in live)
        service = self.cost.store_op * max(1, total_ops)
        if pending_refine:
            _refine_then(pending_refine, self.cost.oracle_rtt + service, live)
        else:
            self.sim.schedule(service, _commit, live)

    def _retry_or_abort(self, tx: Tuple) -> None:
        """Shared retry bookkeeping (per-tx AND group paths): count the
        retry, then resubmit with a fresh stamp or abort past the
        bound."""
        client, ops, stamp, reply, retries, t_submit, txid = tx
        self.sim.counters.tx_retried += 1
        if retries + 1 > MAX_RETRIES:
            self.sim.counters.tx_aborted += 1
            self.store.record_result(txid, False, "too many retries", stamp)
            self.sim.send(self.store, client, reply, False,
                          "too many retries", stamp, nbytes=64)
            return
        self.sim.send(self.store, self, self._resubmit, client, ops,
                      reply, retries + 1, t_submit, txid, nbytes=64)

    # -- node programs (§4.2) ------------------------------------------------------
    def submit_program(self, coordinator, prog_name: str,
                       entries: List[Tuple[str, object]], prog_id: int,
                       ctx=None, t_join: Optional[float] = None) -> None:
        """Admit a node program: per-program (``read_window == 0``, the
        semantic oracle — one ``_serve`` round and a fresh stamp per
        program) or windowed (accumulate for ``read_window`` seconds /
        ``read_group_max`` programs and stamp the whole window in ONE
        serve round; see :meth:`_flush_rgroup`)."""
        if not self.alive:
            return
        if self.paused:
            self._pause_buffer.append((self.submit_program,
                                       (coordinator, prog_name, entries,
                                        prog_id, ctx, t_join)))
            return
        tracer = self.sim.tracer
        if ctx is None and tracer is not None:
            ctx = tracer.current
        if t_join is None:
            t_join = self.sim.now
        if self.admission_limit and self._admitted >= self.admission_limit:
            # load leveling: shed without charging a serve round — the
            # read session's ack timeout resubmits with backoff
            self.sim.counters.progs_shed += 1
            m = self.sim.metrics
            m.count(f"gk_shed:{self.gid}")
            # shed = saturated: positive load for the shared AIMD signal
            m.gauge(f"gk_load:{self.gid}",
                    max(self._busy_until - self.sim.now,
                        float(self._admitted)), self.sim.now)
            if self.nack_shed:
                # explicit reject through the coordinator's reject hook:
                # the read session re-routes immediately
                self.sim.counters.shed_nacks += 1
                self.sim.send(self, coordinator, coordinator.on_reject,
                              prog_id, nbytes=32)
            return
        self._admitted += 1

        if self.read_window > 0:
            # ---- windowed read admission: join the open window -------
            self._rgroup.append((coordinator, prog_name, entries, prog_id,
                                 ctx, t_join))
            if len(self._rgroup) >= self.read_group_max:
                self._flush_rgroup()
            elif not self._rgroup_flush_pending:
                delay = (self._awin.current if self._awin is not None
                         else self.read_window)
                if delay <= 0.0:          # adaptive window at zero: stamp
                    self._flush_rgroup()  # immediately (idle traffic pays
                else:                     # no window latency)
                    self._rgroup_flush_pending = True
                    self.sim.schedule(delay, self._rflush_timer,
                                      self._rgroup_gen)
            return

        def _go() -> None:
            self._admitted -= 1
            if not self.alive:
                return
            stamp = self._tick()
            tr = self.sim.tracer
            if tr is not None and ctx is not None:
                t1 = self.sim.now
                tr.span("gk_wait", t_join, t1 - self.cost.gk_stamp,
                        actor=self.name, ctx=ctx)
                tr.span("gk_stamp", t1 - self.cost.gk_stamp, t1,
                        actor=self.name, ctx=ctx, stamp=stamp_attr(stamp))
                tr.bind_prog(prog_id, ctx)
                tr.bind_stamp(stamp, ctx)
            by_shard: Dict[int, List[Tuple[str, object]]] = {}
            for vid, params in entries:
                sid = self.store.shard_of(vid)
                if sid is None:
                    continue
                by_shard.setdefault(sid, []).append((vid, params))
            root_ids = [(f"g{self.gid}", i) for i in range(len(by_shard))]
            coordinator.begin(prog_id, prog_name, stamp, root_ids)
            for (sid, ent), rid in zip(by_shard.items(), root_ids):
                shard = self.shards[sid]
                self.sim.send(self, shard, shard.deliver_prog, prog_id, rid,
                              prog_name, stamp, ent, coordinator,
                              nbytes=64 + 48 * len(ent))

        self._serve(self.cost.gk_stamp, _go)

    def _rflush_timer(self, gen: int) -> None:
        """Read-window deadline; stale-generation timers are no-ops (the
        write path's ``_flush_timer`` contract — a timer armed for a
        window that a max-count trigger already flushed must not shorten
        the NEXT window)."""
        if gen == self._rgroup_gen:
            self._flush_rgroup()

    def _flush_rgroup(self) -> None:
        """Close the read-admission window: stamp every pending program
        with ONE shared ``_tick()`` stamp in ONE serve round (cost
        ``gk_stamp + gk_batch_prog * (n-1)``) and ship ONE batched
        delivery per destination shard for the whole window.

        Reads are side-effect-free, so unlike the write window the
        programs can SHARE a stamp (each keeps its own prog_id for
        termination detection): every program in the window sees the
        identical snapshot, which makes the shard-side plan LRU, the
        settled-plan reuse, per-stamp queue-clearing state and oracle
        refinement caches fire once per window instead of once per
        program — that, plus the amortized serve round, is the whole
        read-side win."""
        self._rgroup_flush_pending = False
        self._rgroup_gen += 1
        if not self.alive or not self._rgroup:
            return
        batch, self._rgroup = self._rgroup, []
        if self.paused:                 # re-buffer through the epoch barrier
            self._admitted -= len(batch)   # re-counted on barrier replay
            for r in batch:
                self._pause_buffer.append((self.submit_program, r))
            return
        backlog = max(0.0, self._busy_until - self.sim.now)
        window = (self._awin.current if self._awin is not None
                  else self.read_window)
        if self._awin is not None:
            peer = self._peer_load() if self.shared_load_signal else 0.0
            grew = self._awin.on_flush(len(batch), self.read_group_max,
                                       backlog, peer)
            if grew == "peer":
                self.sim.counters.window_grows_shared += 1
        self._observe_admission("r", window, len(batch), backlog)
        cnt = self.sim.counters
        cnt.prog_batches += 1
        cnt.prog_batch_size_sum += len(batch)
        service = (self.cost.gk_stamp
                   + self.cost.gk_batch_prog * (len(batch) - 1))
        wid = f"{self.name}:r{self._rgroup_gen}"

        def _go() -> None:
            self._admitted -= len(batch)
            if not self.alive:
                return
            cnt = self.sim.counters
            # ---- cross-window read sharing (stamp aliasing) ----------
            # If the store interval is untouched since the previous read
            # window closed (LastUpdateTable.mutations seqno unchanged,
            # same epoch), re-issue the SAME stamp: with no committed
            # writes in between, both windows see identical data, and
            # every per-stamp shard-side structure — frontier plan LRU,
            # settled-plan reuse, refinement cache, queue-clearing state
            # — hits warm instead of being rebuilt.
            mut = self.store.last_updates.mutations
            aliased = (self.read_window_alias
                       and self._last_read_stamp is not None
                       and self._last_read_stamp.epoch == self.epoch
                       and mut == self._last_read_mut)
            if aliased:
                stamp = self._last_read_stamp
                cnt.read_windows_aliased += 1
            else:
                stamp = self._tick()    # ONE shared stamp for the window
                self._last_read_stamp = stamp
                self._last_read_mut = mut
            tr = self.sim.tracer
            if tr is not None:
                t1 = self.sim.now
                bound = False
                for _, _, _, prog_id, mctx, tj in batch:
                    if mctx is None:
                        continue
                    wctx = tr.span("window_wait", tj, t1, actor=self.name,
                                   ctx=mctx, window=wid, kind="r",
                                   aliased=aliased)
                    tr.span("gk_stamp", t1 - service, t1, actor=self.name,
                            ctx=wctx, stamp=stamp_attr(stamp))
                    tr.bind_prog(prog_id, mctx)
                    if not bound:
                        tr.bind_stamp(stamp, mctx)
                        bound = True
                tr.current = None       # batch send: no single owner
            per_shard: Dict[int, List[Tuple]] = {}
            for coordinator, prog_name, entries, prog_id, _mctx, _tj in batch:
                by_shard: Dict[int, List[Tuple[str, object]]] = {}
                for vid, params in entries:
                    sid = self.store.shard_of(vid)
                    if sid is None:
                        continue
                    by_shard.setdefault(sid, []).append((vid, params))
                root_ids = [(f"g{self.gid}", i)
                            for i in range(len(by_shard))]
                coordinator.begin(prog_id, prog_name, stamp, root_ids)
                for (sid, ent), rid in zip(by_shard.items(), root_ids):
                    per_shard.setdefault(sid, []).append(
                        (prog_id, rid, prog_name, stamp, ent, coordinator))
            for sid, dels in per_shard.items():
                shard = self._read_target(sid, stamp)
                nbytes = 64 + sum(32 + 48 * len(d[4]) for d in dels)
                self.sim.send(self, shard, shard.deliver_prog_batch, dels,
                              nbytes=nbytes)

        self._serve(service, _go)

    # -- replica read routing -------------------------------------------------
    def on_settled(self, sid: int, stamp_key: Tuple, pos: int,
                   inc: int) -> None:
        """Primary broadcast: reads at ``stamp_key`` are covered by feed
        prefix ``[0, pos)`` of shard ``sid``'s incarnation ``inc``."""
        if not self.alive:
            return
        if len(self._settled) > 20_000:   # bounded; a lost token only
            self._settled.clear()         # costs a primary-served window
        self._settled[(sid, stamp_key)] = (pos, inc)

    def on_replica_frontier(self, sid: int, rid: int, inc: int,
                            pos: int) -> None:
        """Replica advert: it has applied feed prefix ``[0, pos)`` of
        its primary's incarnation ``inc``."""
        if not self.alive:
            return
        self._replica_front[(sid, rid)] = (inc, pos)

    def _read_target(self, sid: int, stamp: Stamp):
        """Pick the server for one window's deliveries to shard ``sid``:
        a replica iff the window stamp is settled there AND the
        replica's advertised frontier (same incarnation) covers the
        settlement position — the stamp-frontier gate that makes
        replica reads bit-identical, not lucky.  Fresh-stamp windows
        (no token yet) always go to the primary, which settles them."""
        reps = self.replicas.get(sid)
        if not reps:
            return self.shards[sid]
        tok = self._settled.get((sid, stamp.key()))
        if tok is None:
            return self.shards[sid]
        pos, inc = tok
        elig = []
        for r in reps:
            front = self._replica_front.get((sid, r.rid))
            if (r.alive and front is not None
                    and front[0] == inc and front[1] >= pos):
                elig.append(r)
        if not elig:
            return self.shards[sid]
        # the primary stays in the rotation: replicas ADD read capacity
        # rather than move the bottleneck.  In a multi-pod deployment
        # in-pod servers are preferred when any is eligible (a replica
        # exists precisely so reads can dodge the cross-pod hop).
        pool = [self.shards[sid]] + elig
        if self.pod is not None:
            inpod = [s for s in pool if s.pod == self.pod]
            if inpod:
                pool = inpod
        self._rr_replica += 1
        return pool[self._rr_replica % len(pool)]
