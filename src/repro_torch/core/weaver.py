"""Weaver facade: wires gatekeepers, shards, timeline oracle, backing
store and cluster manager together, and exposes the client API
(transactions §2.2, node programs §2.3, GC §4.5, failures §4.3).

Synchronous convenience wrappers (``run_tx``, ``run_program``) drive the
simulator until the request's callback fires — used by tests, examples
and benchmarks.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .analytics import check_device
from .clock import Stamp, compare, Order, zero
from .cluster import ClusterManager, HeartbeatSender
from .faultinject import FaultInjector
from .gatekeeper import CostModel, Gatekeeper, SHED_NACK
from .mvgraph import PropIntern, VidIntern
from .nodeprog import REGISTRY
from .oracle import OracleServer
from .replica import ReplicaShard
from .shard import Shard
from .simulation import NetworkModel, PeriodicTimer, Simulator
from .store import BackingStore
from .txn import Transaction, TxResult


class ProgCoordinator:
    """Client-side termination detection for node programs.

    Uses announced/reported delivery-id sets: a program completes when the
    two sets are equal (safe against reports arriving before their
    parent's announcement).

    Each report also says whether the delivery executed **batched** (one
    packed frontier per destination shard, ``repro_torch.core.frontier``) and
    how many entries it carried; the coordinator aggregates these into
    the global counters (``frontier_batches`` / ``scalar_deliveries``)
    and keeps the per-program totals in ``last_prog_stats`` so
    benchmarks can show the per-hop message collapse: O(shards) packed
    messages instead of O(emitted vertices) entries.

    Report payloads may be *ragged* (``repro_torch.core.frontier.RaggedReply``
    — ``get_edges`` ships one columnar edge-list block per shard step
    instead of one Python list per entry): the wire model charges their
    packed ``nbytes`` on the report message, and the program's
    ``reduce`` decodes rows lazily at completion.
    """

    def __init__(self, sim: Simulator):
        self.sim = sim
        sim.register(self)
        self.active: Dict[int, dict] = {}
        self.done: set = set()
        self.on_complete: Dict[int, Callable] = {}
        self.on_nack: Dict[int, Callable] = {}
        self.shards: List[Shard] = []
        # {sid: [ReplicaShard, ...]} — finish/abandon broadcasts reach
        # replicas too so their per-program state is GC'd (Weaver wires
        # the live dict)
        self.replicas: Dict[int, list] = {}
        self.weaver = None
        self.last_prog_stats: dict = {}

    def begin(self, prog_id: int, name: str, stamp: Stamp,
              root_ids: List[tuple]) -> None:
        st = self.active.setdefault(prog_id, {
            "announced": set(), "reported": set(), "outputs": [],
            "name": name, "stamp": stamp, "t0": self.sim.now,
            "batches": 0, "scalar": 0, "entries": 0,
        })
        st["announced"].update(root_ids)
        self._maybe_finish(prog_id)

    def report(self, prog_id: int, delivery_id, children: List[tuple],
               outputs: List[object], batched: bool = False,
               n_entries: int = 0) -> None:
        if prog_id in self.done:
            return
        st = self.active.get(prog_id)
        if st is None:
            return
        if delivery_id in st["reported"]:
            return   # duplicated report (message-dup fault): outputs and
        #              counters must not double-count
        st["reported"].add(delivery_id)
        st["announced"].update(children)
        st["announced"].add(delivery_id)
        st["outputs"].extend(outputs)
        if batched:
            st["batches"] += 1
            self.sim.counters.frontier_batches += 1
        elif n_entries:
            st["scalar"] += 1
            self.sim.counters.scalar_deliveries += 1
        st["entries"] += n_entries
        self._maybe_finish(prog_id)

    def _maybe_finish(self, prog_id: int) -> None:
        st = self.active[prog_id]
        if st["announced"] and st["announced"] == st["reported"]:
            self.done.add(prog_id)
            del self.active[prog_id]
            self.sim.counters.nodeprog_completed += 1
            prog = REGISTRY[st["name"]]
            result = prog.reduce(st["outputs"])
            latency = self.sim.now - st["t0"]
            self.last_prog_stats = {
                "name": st["name"], "batches": st["batches"],
                "scalar_deliveries": st["scalar"],
                "entries": st["entries"],
            }
            for sh in self.shards:
                sh.finish_prog(prog_id)
            for reps in self.replicas.values():
                for rep in reps:
                    rep.finish_prog(prog_id)
            if self.weaver is not None:
                self.weaver._prog_finished(prog_id)
            cb = self.on_complete.pop(prog_id, None)
            self.on_nack.pop(prog_id, None)
            if cb is not None:
                cb(result, st["stamp"], latency)

    def reject(self, prog_id: int) -> None:
        """A gatekeeper shed this submission before stamping (admission
        backpressure): nothing was announced, so just surface the miss —
        the read session's ack timeout resubmits."""
        self.active.pop(prog_id, None)

    def on_reject(self, prog_id: int) -> None:
        """Wire entry for an explicit shed NACK: clear any state, then
        tell the submitting session so it can re-route to another
        gatekeeper within the same attempt instead of waiting out its
        ack timer."""
        self.reject(prog_id)
        cb = self.on_nack.pop(prog_id, None)
        if cb is not None:
            cb()

    def abandon(self, prog_id: int) -> None:
        """A read session gave up on (or superseded) this attempt: drop
        its termination state and ignore any late reports."""
        self.active.pop(prog_id, None)
        self.done.add(prog_id)
        self.on_complete.pop(prog_id, None)
        self.on_nack.pop(prog_id, None)
        for sh in self.shards:
            sh.finish_prog(prog_id)
        for reps in self.replicas.values():
            for rep in reps:
                rep.finish_prog(prog_id)


@dataclass
class WeaverConfig:
    n_gatekeepers: int = 2
    n_shards: int = 4
    tau: float = 1e-3            # vector-clock announce period (§3.3)
    tau_nop: float = 0.5e-3      # NOP period (§4.1)
    gc_period: float = 50e-3     # distributed GC cadence (§4.5)
    frontier_progs: bool = True  # batched node-program execution path
    frontier_plan_delta: bool = True  # delta-refresh ShardPlans on writes
    frontier_coalesce: bool = True    # merge same-(prog, stamp) deliveries
    plan_cache_entries: int = 4  # per-shard ShardPlan LRU budget
    write_group_commit: float = 0.0   # group-commit admission window in
    #                                   simulated seconds (0 = per-tx
    #                                   path, the semantic oracle); see
    #                                   repro_torch.core.writepath
    write_group_max: int = 64    # flush a window early at this many txs
    read_group_commit: float = 0.0    # windowed read admission: accumulate
    #                                   submit_program calls for this many
    #                                   simulated seconds and stamp the
    #                                   whole window (ONE shared stamp) in
    #                                   one serve round (0 = per-program
    #                                   path, the semantic oracle)
    read_group_max: int = 128    # flush a read window early at this many
    #                              programs
    adaptive_admission: bool = False  # AIMD controller on both admission
    #                                   windows: shrink toward zero when
    #                                   idle, grow toward the configured
    #                                   max under load (see
    #                                   gatekeeper.AdaptiveWindow)
    admission_queue_limit: int = 0    # gatekeeper load leveling: shed new
    #                                   admissions past this many admitted-
    #                                   but-unstamped requests (0 = off);
    #                                   client sessions recover sheds via
    #                                   their ack timeouts
    read_retry_timeout: float = 0.0   # read-session ack-timeout base in
    #                                   simulated seconds: resubmit with
    #                                   backoff + jitter on shed/loss,
    #                                   fresh prog_id per attempt, bounded
    #                                   by client_retry_budget (0 = the
    #                                   legacy fire-and-wait path)
    read_your_writes: bool = False    # hold tx acks until every destination
    #                                   shard applied the write (client-
    #                                   visible failover cost; shards ack
    #                                   applied stamps to the forwarding
    #                                   gatekeeper)
    wal_replay: bool = True      # promote shard backups by replaying the
    #                              redo WAL (False: the vertices-walk
    #                              oracle path, kept for equivalence tests)
    wal_checkpoint_every: int = 256   # WAL records between checkpoint
    #                                   rewrites at store GC
    client_retry_budget: int = 8      # client session resubmissions before
    #                                   surfacing an error (exactly-once
    #                                   retry, §4.3)
    client_backoff_base: float = 8e-3  # first ack-timeout; doubles per
    #                                    attempt (plus jitter)
    client_backoff_cap: float = 80e-3  # ack-timeout ceiling
    shed_nack: bool = True       # admission sheds send an explicit reject
    #                              (NACK) so sessions re-route to another
    #                              gatekeeper within the SAME attempt
    #                              instead of waiting out the ack timer
    #                              (False = the silent-shed legacy path)
    device_shard_columns: bool = False  # keep packed stamp columns
    #                                     resident on the device and
    #                                     evaluate visibility with one
    #                                     repro_torch.dist.columns kernel
    #                                     launch (the host-global path
    #                                     stays the equivalence oracle)
    trace_sample_rate: float = 0.0  # head-based causal-trace sampling:
    #                                 every round(1/rate)-th client request
    #                                 records a span tree (0 = tracing off,
    #                                 zero overhead; see repro_torch.core.obs)
    metrics_period: float = 0.0  # metrics-timeline sampling cadence in
    #                              simulated seconds (0 = no timeline; the
    #                              sampler adds heap events, so equivalence
    #                              comparisons must hold it constant)
    shared_load_signal: bool = False  # AIMD admission windows read the
    #                                   deployment-level gk_load gauges: a
    #                                   saturated peer holds this server's
    #                                   window OPEN so traffic re-routed
    #                                   off the hot gatekeeper is absorbed
    #                                   instead of shed (closes the
    #                                   "load-blind" AIMD gap)
    read_window_alias: bool = True  # alias a read window onto the previous
    #                                 window's stamp when the store interval
    #                                 is unchanged (LastUpdateTable.mutations
    #                                 seqno): shard plan/refinement caches
    #                                 hit warm across windows
    n_replicas: int = 0          # change-feed read replicas per shard
    #                              (repro_torch.core.replica): settled-stamp
    #                              read windows route to caught-up
    #                              replicas, everything else stays
    #                              primary-served (0 = no replication)
    replica_poll_period: float = 1e-3  # replica change-feed pull cadence
    #                                    in simulated seconds
    replica_promotion: bool = True  # failover promotes the most caught-
    #                                 up replica (partition adopted, WAL
    #                                 top-up of only the missing ops)
    #                                 instead of a cold full replay
    pods: int = 1                # deployment pods: gatekeepers/shards/
    #                              replicas are round-robin assigned and
    #                              cross-pod messages pay
    #                              NetworkModel.cross_pod_latency extra
    #                              (1 = single pod, no surcharge)
    pod_map: Optional[dict] = None  # explicit {actor name: pod id}
    #                                 overrides for the round-robin pod
    #                                 assignment (e.g. {"shard0r0": 1})
    fault_plan: Optional[object] = None  # repro_torch.core.faultinject.FaultPlan
    #                                      (None = no fault injection)
    seed: int = 0
    cost: CostModel = field(default_factory=CostModel)
    network: NetworkModel = field(default_factory=NetworkModel)
    heartbeat_period: float = 5e-3
    device: str = "cuda"         # where every batched stamp compare runs
    #                              (the CUDA kernels; "cpu" runs their
    #                              plain PyTorch versions)


class Weaver:
    def __init__(self, cfg: WeaverConfig = WeaverConfig()):
        check_device(cfg.device)
        self.cfg = cfg
        self.sim = Simulator(seed=cfg.seed, network=cfg.network)
        if cfg.trace_sample_rate > 0:
            from .obs import Tracer
            self.sim.tracer = Tracer(self.sim, cfg.trace_sample_rate)
        if cfg.fault_plan is not None:
            self.sim.fault = FaultInjector(cfg.fault_plan, self.sim)
        self.intern = VidIntern()       # deployment-wide vid interning
        # deployment-wide property-VALUE intern: ragged replies ship
        # packed value ids and decode lazily at the client (per-
        # partition tables would force eager decode at the shard)
        self.prop_vals = PropIntern()
        self.store = BackingStore(self.sim, cfg.n_shards, intern=self.intern,
                                  wal_checkpoint_every=cfg.wal_checkpoint_every,
                                  device=cfg.device)
        self.oracle = OracleServer(self.sim)
        self.manager = ClusterManager(self.sim, cfg.heartbeat_period)
        self.manager.weaver = self
        self.device_plane = None
        if cfg.device_shard_columns:
            from ..dist.columns import DeviceColumnPlane
            self.device_plane = DeviceColumnPlane(cfg.n_gatekeepers,
                                                  device=cfg.device)
        self.gatekeepers: List[Gatekeeper] = [
            Gatekeeper(self.sim, g, cfg.n_gatekeepers, self.store, self.oracle,
                       cfg.cost, cfg.tau, cfg.tau_nop,
                       group_window=cfg.write_group_commit,
                       group_max=cfg.write_group_max,
                       read_window=cfg.read_group_commit,
                       read_group_max=cfg.read_group_max,
                       adaptive=cfg.adaptive_admission,
                       admission_limit=cfg.admission_queue_limit,
                       ack_on_apply=cfg.read_your_writes,
                       nack_shed=cfg.shed_nack,
                       shared_load_signal=cfg.shared_load_signal,
                       read_window_alias=cfg.read_window_alias)
            for g in range(cfg.n_gatekeepers)
        ]
        self.shards: List[Shard] = [
            Shard(self.sim, s, cfg.n_gatekeepers, self.oracle, cfg.cost,
                  self.store.shard_of, intern=self.intern,
                  use_frontier=cfg.frontier_progs,
                  plan_delta=cfg.frontier_plan_delta,
                  coalesce=cfg.frontier_coalesce,
                  plan_cache_entries=cfg.plan_cache_entries,
                  ack_applies=cfg.read_your_writes,
                  device_plane=self.device_plane,
                  prop_vals=self.prop_vals,
                  device=cfg.device)
            for s in range(cfg.n_shards)
        ]
        for gk in self.gatekeepers:
            gk.start(self.gatekeepers, self.shards)
        for sh in self.shards:
            sh.start(self.shards)
            # the LIST is shared (not copied) so gatekeeper promotions
            # propagate to every shard's ack routing automatically
            sh.gatekeepers = self.gatekeepers
        # ---- read replicas (repro_torch.core.replica) -----------------------
        self.replicas: Dict[int, List[ReplicaShard]] = {}
        if cfg.n_replicas > 0:
            for sh in self.shards:
                sh.replicated = True     # keep the change feed
            for s in range(cfg.n_shards):
                self.replicas[s] = [
                    ReplicaShard(self.sim, s, r, cfg.n_gatekeepers,
                                 self.oracle, cfg.cost, self.store.shard_of,
                                 self.shards,
                                 poll_period=cfg.replica_poll_period,
                                 intern=self.intern,
                                 use_frontier=cfg.frontier_progs,
                                 plan_delta=cfg.frontier_plan_delta,
                                 coalesce=cfg.frontier_coalesce,
                                 plan_cache_entries=cfg.plan_cache_entries,
                                 prop_vals=self.prop_vals,
                                 device=cfg.device)
                    for r in range(cfg.n_replicas)]
            for reps in self.replicas.values():
                for rep in reps:
                    rep.gatekeepers = self.gatekeepers
            for gk in self.gatekeepers:
                gk.replicas = self.replicas
        # ---- pod topology ---------------------------------------------
        if cfg.pods > 1 or cfg.pod_map:
            pm = cfg.pod_map or {}
            for g, gk in enumerate(self.gatekeepers):
                gk.pod = pm.get(gk.name, g % cfg.pods)
            for s, sh in enumerate(self.shards):
                sh.pod = pm.get(sh.name, s % cfg.pods)
            for s, reps in self.replicas.items():
                for r, rep in enumerate(reps):
                    # default placement spreads a shard's replicas over
                    # the OTHER pods first (geo read locality: some pod
                    # without the primary still gets an in-pod copy)
                    rep.pod = pm.get(rep.name, (s + 1 + r) % cfg.pods)
        self.coordinator = ProgCoordinator(self.sim)
        self.coordinator.shards = self.shards
        self.coordinator.replicas = self.replicas
        self.coordinator.weaver = self
        self._heartbeats = []
        for i, gk in enumerate(self.gatekeepers):
            self._heartbeats.append(
                HeartbeatSender(self.sim, self.manager, f"gk{i}", gk))
        for i, sh in enumerate(self.shards):
            self._heartbeats.append(
                HeartbeatSender(self.sim, self.manager, f"shard{i}", sh))
        self.manager.start()
        self._prog_ids = itertools.count(1)
        self._client_ids = itertools.count(1)
        self._eids = itertools.count(1)
        self._txids = itertools.count(1)      # client-assigned tx ids
        # session-layer backoff jitter draws from its OWN stream so the
        # network jitter sequence (and thus fault-free timings) is
        # untouched by how many retries fire
        self._client_rng = np.random.default_rng((cfg.seed << 8) ^ 0xC11E47)
        self._rr = itertools.count()
        self._outstanding_progs: Dict[int, Stamp] = {}
        self._incarnations: Dict[str, int] = {}
        if cfg.gc_period > 0:
            PeriodicTimer(self.sim, cfg.gc_period, self._gc)
        if cfg.metrics_period > 0:
            PeriodicTimer(self.sim, cfg.metrics_period, self._sample_metrics)

    # ---- client API -----------------------------------------------------
    def begin_tx(self) -> Transaction:
        cid = next(self._client_ids)
        return Transaction(cid, self._eids, read_fn=self.read_vertex)

    def read_vertex(self, vid: str) -> Optional[dict]:
        """Client read against the backing store (latest committed)."""
        v = self.store.vertices.get(vid)
        if v is None or v.delete_ts is not None:
            return None
        return {
            "id": vid,
            "edges": {eid: dst for eid, (dst, _, dts) in v.edges.items()
                      if dts is None},
            "props": {k: vs[-1][0] for k, vs in v.props.items()},
        }

    def submit_tx(self, tx: Transaction, callback: Callable,
                  gatekeeper: Optional[int] = None) -> None:
        """Async submit; ``callback(TxResult)`` fires on commit/abort.

        Exactly-once client session (§4.3): the transaction gets a
        client-assigned txid and an ack timeout with exponential backoff
        plus jitter.  An unacked submission is resubmitted to the next
        (promoted) gatekeeper — the gatekeeper/store dedup layer makes a
        resubmission of an already-committed transaction answer from the
        recorded outcome instead of re-executing, so it commits once,
        never twice.  A bounded retry budget surfaces an error instead
        of hanging forever."""
        txid = next(self._txids)
        pref = (next(self._rr) if gatekeeper is None else gatekeeper)
        t0 = self.sim.now
        st = {"done": False, "attempt": 0, "nack": None}
        tr = self.sim.tracer
        ctx = tr.maybe_start() if tr is not None else None

        def reply(ok: bool, err: Optional[str], stamp: Stamp) -> None:
            if st["done"]:
                return                   # duplicate/late ack of an earlier try
            if err == SHED_NACK:
                # admission shed NACK: re-route to the next gatekeeper
                # within the SAME attempt (the backoff timer chain and
                # retry budget are untouched — a re-route is free, not a
                # retry); an exhausted rotation waits out the timer
                nk = st["nack"]
                if nk is not None:
                    nk()
                return
            st["done"] = True
            if ctx is not None:
                tr.root_span(ctx, "request", t0, self.sim.now,
                             actor="client", kind="tx", ok=ok,
                             retries=st["attempt"] - 1)
            callback(TxResult(ok=ok, stamp=stamp, error=err,
                              retries=st["attempt"] - 1,
                              latency=self.sim.now - t0))

        def send(k: int, j: int) -> None:
            n = len(self.gatekeepers)
            for off in range(n):         # rotate past known-dead servers
                gk = self.gatekeepers[(pref + k + j + off) % n]
                if gk.alive:
                    break

            def nack(k=k, j=j) -> None:
                st["nack"] = None
                if st["done"] or st["attempt"] != k + 1 \
                        or j + 1 >= len(self.gatekeepers):
                    return               # stale, or rotation exhausted
                self.sim.counters.nack_reroutes += 1
                send(k, j + 1)

            st["nack"] = nack
            self.sim.send(self, gk, gk.submit_tx, self, tx.ops, reply,
                          0, None, txid, nbytes=64 + 48 * len(tx.ops))

        def attempt() -> None:
            if st["done"]:
                return
            k = st["attempt"]
            if k > self.cfg.client_retry_budget:
                self.sim.counters.client_gaveup += 1
                st["done"] = True
                if ctx is not None:
                    tr.root_span(ctx, "request", t0, self.sim.now,
                                 actor="client", kind="tx", ok=False,
                                 retries=k - 1, gaveup=True)
                callback(TxResult(ok=False,
                                  error="client retry budget exhausted",
                                  retries=k - 1, latency=self.sim.now - t0))
                return
            if k > 0:
                self.sim.counters.client_retries += 1
            st["attempt"] = k + 1
            send(k, 0)
            backoff = min(self.cfg.client_backoff_cap,
                          self.cfg.client_backoff_base * (2 ** k))
            backoff *= 1.0 + 0.25 * float(self._client_rng.random())
            self.sim.schedule(backoff, attempt)

        if tr is not None:
            # seed the ambient trace context for the first attempt: every
            # downstream send/schedule inherits it through the heap, so
            # retries, NACK re-routes and store legs stay on this trace
            prev = tr.current
            tr.current = ctx
            try:
                attempt()
            finally:
                tr.current = prev
        else:
            attempt()

    def submit_program(self, name: str, entries: List[Tuple[str, object]],
                       callback: Callable, gatekeeper: Optional[int] = None) -> int:
        """Async node program; ``callback(result, stamp, latency)``.

        With ``read_retry_timeout > 0`` the submission becomes a client
        session like :meth:`submit_tx`: each attempt carries a FRESH
        prog_id (reads are side-effect-free, so re-execution is safe —
        no dedup layer needed), an ack timeout with exponential backoff
        plus jitter resubmits to the next gatekeeper, superseded
        attempts are abandoned at the coordinator, and a bounded budget
        surfaces ``callback(None, None, latency)`` instead of hanging.
        This is what recovers submissions shed by gatekeeper admission
        backpressure or lost to a crash/drop.  The default (0) keeps
        the legacy fire-and-wait behavior."""
        assert name in REGISTRY, f"unknown node program {name}"
        base = self.cfg.read_retry_timeout
        tr = self.sim.tracer
        ctx = tr.maybe_start() if tr is not None else None
        if base <= 0:
            pid = next(self._prog_ids)
            g = (next(self._rr) % len(self.gatekeepers)
                 if gatekeeper is None else gatekeeper)
            gk = self.gatekeepers[g]
            if not gk.alive:
                g = (g + 1) % len(self.gatekeepers)
                gk = self.gatekeepers[g]
            if ctx is not None:
                t0 = self.sim.now

                def _cb(r, s, l, _cb=callback) -> None:
                    tr.root_span(ctx, "request", t0, self.sim.now,
                                 actor="client", kind="prog",
                                 ok=r is not None)
                    _cb(r, s, l)

                self.coordinator.on_complete[pid] = _cb
                prev = tr.current
                tr.current = ctx
                try:
                    self.sim.send(self, gk, gk.submit_program,
                                  self.coordinator, name, entries, pid,
                                  nbytes=64 + 48 * len(entries))
                finally:
                    tr.current = prev
            else:
                self.coordinator.on_complete[pid] = callback
                self.sim.send(self, gk, gk.submit_program, self.coordinator,
                              name, entries, pid,
                              nbytes=64 + 48 * len(entries))
            return pid

        pref = (next(self._rr) if gatekeeper is None else gatekeeper)
        t0 = self.sim.now
        st = {"done": False, "attempt": 0, "pids": []}

        def finish(result, stamp, pid_done=None) -> None:
            if st["done"]:
                return
            st["done"] = True
            for pid in st["pids"]:
                if pid != pid_done:
                    self.coordinator.abandon(pid)
            if ctx is not None:
                tr.root_span(ctx, "request", t0, self.sim.now,
                             actor="client", kind="prog",
                             ok=result is not None,
                             retries=st["attempt"] - 1)
            callback(result, stamp, self.sim.now - t0)

        def send(k: int, j: int) -> None:
            pid = next(self._prog_ids)
            st["pids"].append(pid)
            n = len(self.gatekeepers)
            for off in range(n):         # rotate past known-dead servers
                gk = self.gatekeepers[(pref + k + j + off) % n]
                if gk.alive:
                    break
            self.coordinator.on_complete[pid] = (
                lambda r, s, _l, pid=pid: finish(r, s, pid_done=pid))

            def nack(k=k, j=j, pid=pid) -> None:
                # shed NACK for this exact attempt: re-route within the
                # attempt (fresh pid, same timer chain and budget); an
                # exhausted rotation waits out the ack timer
                if st["done"] or pid != st["pids"][-1] \
                        or j + 1 >= len(self.gatekeepers):
                    return
                self.sim.counters.nack_reroutes += 1
                send(k, j + 1)

            self.coordinator.on_nack[pid] = nack
            self.sim.send(self, gk, gk.submit_program, self.coordinator,
                          name, entries, pid, nbytes=64 + 48 * len(entries))

        def attempt() -> None:
            if st["done"]:
                return
            k = st["attempt"]
            if k > self.cfg.client_retry_budget:
                self.sim.counters.prog_gaveup += 1
                finish(None, None)
                return
            if k > 0:
                self.sim.counters.prog_retries += 1
            st["attempt"] = k + 1
            send(k, 0)
            backoff = min(max(self.cfg.client_backoff_cap, base),
                          base * (2 ** k))
            backoff *= 1.0 + 0.25 * float(self._client_rng.random())
            self.sim.schedule(backoff, attempt)

        if tr is not None:
            prev = tr.current
            tr.current = ctx
            try:
                attempt()
            finally:
                tr.current = prev
        else:
            attempt()
        return st["pids"][0]

    def _prog_finished(self, prog_id: int) -> None:
        self._outstanding_progs.pop(prog_id, None)

    # ---- metrics timeline (repro_torch.core.obs) --------------------------------
    def _sample_metrics(self) -> None:
        """One metrics-timeline row on simulated time: queue depths,
        admission windows, backlog and in-flight programs across the
        whole deployment (``metrics_period`` knob)."""
        m = self.sim.metrics
        now = self.sim.now
        for gk in self.gatekeepers:
            if gk.alive:
                m.gauge(f"gk_admitted:{gk.gid}", float(gk._admitted), now)
                m.gauge(f"gk_backlog:{gk.gid}",
                        max(0.0, gk._busy_until - now), now)
        for sh in self.shards:
            if sh.alive:
                depth = (sum(len(q) for q in sh.queues.values())
                         + len(sh.pending_progs))
                m.gauge(f"shard_queue:{sh.sid}", float(depth), now)
        for reps in self.replicas.values():
            for rep in reps:
                if rep.alive:
                    p = self.shards[rep.sid]
                    lag = (float(p.feed_pos - rep.applied_pos)
                           if p.alive and p.incarnation == rep.sub_inc
                           else -1.0)
                    m.gauge(f"replica_lag:{rep.name}", lag, now)
        m.sample(now, {"progs_in_flight": len(self.coordinator.active)})
        self.sim.counters.metrics_samples += 1

    # ---- synchronous conveniences (drive the simulator) --------------------
    def run_tx(self, tx: Transaction, timeout: float = 5.0) -> TxResult:
        box: List[TxResult] = []
        self.submit_tx(tx, box.append)
        deadline = self.sim.now + timeout
        while not box and self.sim.pending() and self.sim.now < deadline:
            self.sim.run(until=min(deadline, self.sim.now + 5e-3))
        if not box:
            raise TimeoutError("transaction did not complete")
        return box[0]

    def run_program(self, name: str, entries: List[Tuple[str, object]],
                    timeout: float = 10.0):
        box: List[tuple] = []
        self.submit_program(name, entries,
                            lambda r, s, l: box.append((r, s, l)))
        deadline = self.sim.now + timeout
        while not box and self.sim.pending() and self.sim.now < deadline:
            self.sim.run(until=min(deadline, self.sim.now + 5e-3))
        if not box:
            raise TimeoutError("node program did not complete")
        return box[0]

    def settle(self, dt: float = 20e-3) -> None:
        """Let in-flight work drain (bounded)."""
        self.sim.run(until=self.sim.now + dt)

    # ---- GC (§4.5) -----------------------------------------------------------
    def _gc(self) -> None:
        # T_e = earliest outstanding node program, else min gatekeeper clock
        stamps = [s["stamp"] for s in self.coordinator.active.values()]
        if stamps:
            horizon = stamps[0]
            for s in stamps[1:]:
                if compare(s, horizon) is Order.BEFORE:
                    horizon = s
        else:
            clocks = [gk.clock for gk in self.gatekeepers if gk.alive]
            if not clocks:                # every gatekeeper down (fault
                return                    # injection): nothing to advance
            epoch = min(gk.epoch for gk in self.gatekeepers if gk.alive)
            n = len(clocks[0])
            horizon = Stamp(epoch, tuple(min(c[i] for c in clocks)
                                         for i in range(n)), -1, 0)
        for sh in self.shards:
            if sh.alive:
                sh.collect(horizon)
        # replicas GC at the same horizon (their collect also truncates
        # nothing feed-side — only primaries keep feed logs)
        for reps in self.replicas.values():
            for rep in reps:
                if rep.alive:
                    rep.collect(horizon)
        self.oracle.oracle.collect(horizon)
        # store-side GC: bound the LastUpdateTable and drop long-deleted
        # StoredVertex records (see BackingStore.collect)
        self.store.collect(horizon)

    # ---- fault tolerance (§4.3) ------------------------------------------------
    def promote_backup(self, name: str) -> None:
        """Replace a failed server with a backup recovered from the store."""
        if name.startswith("shard"):
            sid = int(name[len("shard"):])
            old = self.shards[sid]
            old.stop()
            inc = self._incarnations.get(name, 0) + 1
            self._incarnations[name] = inc
            nu = Shard(self.sim, sid, self.cfg.n_gatekeepers, self.oracle,
                       self.cfg.cost, self.store.shard_of, intern=self.intern,
                       use_frontier=self.cfg.frontier_progs,
                       plan_delta=self.cfg.frontier_plan_delta,
                       coalesce=self.cfg.frontier_coalesce,
                       plan_cache_entries=self.cfg.plan_cache_entries,
                       ack_applies=self.cfg.read_your_writes,
                       device_plane=self.device_plane,
                       incarnation=inc,
                       prop_vals=self.prop_vals,
                       device=self.cfg.device)
            nu.pod = old.pod
            nu.replicated = old.replicated or self.cfg.n_replicas > 0
            ops = self.store.recover_shard(sid, use_wal=self.cfg.wal_replay)
            reps = [r for r in self.replicas.get(sid, []) if r.alive]
            best = (max(reps, key=lambda r: r.applied_pos)
                    if reps and self.cfg.replica_promotion else None)
            if best is not None:
                # replica promotion: adopt the most caught-up replica's
                # partition and top up only the ops it had not pulled
                best.stop()
                self.replicas[sid] = [r for r in self.replicas[sid]
                                      if r is not best]
                nu.adopt_replica(best, ops)
                self.sim.counters.replica_promotions += 1
                for gk in self.gatekeepers:
                    gk._replica_front.pop((sid, best.rid), None)
            else:
                nu.recover_from(ops)
            nu.gatekeepers = self.gatekeepers
            self.shards[sid] = nu
            for sh in self.shards:
                sh.start(self.shards)
            for gk in self.gatekeepers:
                gk.shards = self.shards
                gk._seq[sid] = 0
            # surviving replicas detect the new incarnation on their
            # next pull and cold-resync from the promoted primary
            self.coordinator.shards = self.shards
            self.manager.register_member(name, nu)
            self._heartbeats.append(
                HeartbeatSender(self.sim, self.manager, name, nu))
        elif name.startswith("gk"):
            gid = int(name[len("gk"):])
            old = self.gatekeepers[gid]
            old.stop()
            nu = Gatekeeper(self.sim, gid, self.cfg.n_gatekeepers, self.store,
                            self.oracle, self.cfg.cost, self.cfg.tau,
                            self.cfg.tau_nop,
                            group_window=self.cfg.write_group_commit,
                            group_max=self.cfg.write_group_max,
                            read_window=self.cfg.read_group_commit,
                            read_group_max=self.cfg.read_group_max,
                            adaptive=self.cfg.adaptive_admission,
                            admission_limit=self.cfg.admission_queue_limit,
                            ack_on_apply=self.cfg.read_your_writes,
                            nack_shed=self.cfg.shed_nack,
                            shared_load_signal=self.cfg.shared_load_signal,
                            read_window_alias=self.cfg.read_window_alias)
            nu.pod = old.pod
            nu.replicas = self.replicas
            self.gatekeepers[gid] = nu
            nu.start(self.gatekeepers, self.shards)
            # refresh surviving gatekeepers' peer lists (no new timers)
            for gk in self.gatekeepers:
                if gk.alive and gk is not nu:
                    gk.peers = [p for p in self.gatekeepers if p is not gk]
            self.manager.register_member(name, nu)
            self._heartbeats.append(
                HeartbeatSender(self.sim, self.manager, name, nu))

    def kill(self, name: str) -> None:
        """Test hook: crash a server now (heartbeats stop immediately)."""
        actor = self.manager.members.get(name)
        if actor is None:
            # replicas are not cluster-manager members (no failover for
            # them); look them up by name directly
            for reps in self.replicas.values():
                for rep in reps:
                    if rep.name == name:
                        rep.alive = False
                        rep.stop()
                        return
            raise KeyError(name)
        actor.alive = False

    # ---- introspection -------------------------------------------------------
    def counters(self) -> dict:
        return self.sim.counters.snapshot()
