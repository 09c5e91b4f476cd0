"""Deterministic discrete-event simulator for Weaver's control plane.

The paper evaluates Weaver on a 44-machine GbE cluster.  This container has
one CPU core, so the control plane (gatekeepers, shards, timeline oracle,
cluster manager) runs as actors on a deterministic event loop with a
parameterized network model.  All benchmark numbers derived from it are in
*simulated* seconds and are reproducible bit-for-bit for a given seed.

Design notes
------------
* Events are ``(time, seq, fn, args, ctx)`` in a heap; ``seq`` breaks ties
  so ordering never depends on callback identity.  ``ctx`` is the trace
  context captured at the scheduling site (None when tracing is off) and
  restored as the tracer's ambient context around the callback — causal
  span parentage flows with events at zero cost to event ordering.
* ``NetworkModel`` charges per-message latency = base + size/bandwidth +
  jitter drawn from a seeded RNG.  Channels between a fixed (src, dst)
  pair are FIFO: the simulator enforces in-order delivery per channel by
  never scheduling a message earlier than the previous one on the same
  channel (this models TCP, which Weaver's FIFO gatekeeper->shard channels
  assume; sequence numbers are still checked at the receiver).
* Actors are plain Python objects; ``Simulator.send`` invokes
  ``dst.on_message(msg)`` at delivery time.
"""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np


@dataclass
class NetworkModel:
    """Latency model: base RPC latency + payload/bandwidth + jitter."""

    base_latency: float = 100e-6        # 100us intra-rack RPC (GbE era)
    bandwidth: float = 125e6            # 1 Gb/s in bytes/sec
    jitter_frac: float = 0.05           # +-5% multiplicative jitter
    local_latency: float = 2e-6         # same-process handoff
    cross_pod_latency: float = 1.5e-3   # extra one-way latency when the
    #                                     sender and receiver sit in
    #                                     different deployment pods (WAN
    #                                     hop; see WeaverConfig.pods)

    def delay(self, nbytes: int, rng: np.random.Generator, local: bool = False) -> float:
        if local:
            return self.local_latency
        base = self.base_latency + nbytes / self.bandwidth
        if self.jitter_frac:
            base *= 1.0 + self.jitter_frac * (2.0 * rng.random() - 1.0)
        return base


@dataclass
class Counters:
    """Global measurement counters (paper Figs. 9-14 read these)."""

    announce_messages: int = 0
    oracle_calls: int = 0
    oracle_cache_hits: int = 0
    nop_messages: int = 0
    tx_committed: int = 0
    tx_retried: int = 0
    tx_aborted: int = 0
    nodeprog_completed: int = 0
    messages_sent: int = 0
    bytes_sent: int = 0
    lock_waits: int = 0            # 2PL baseline
    lock_aborts: int = 0           # 2PL deadlock aborts
    barriers: int = 0              # BSP baseline
    shard_hops: int = 0
    frontier_batches: int = 0      # batched node-program EXECUTIONS
    scalar_deliveries: int = 0     # per-vertex node-program deliveries
    prog_entries_delivered: int = 0  # total (vertex, params) entries
    frontier_coalesced: int = 0    # same-(prog, stamp) deliveries merged
    #                                into another delivery's execution
    scalar_coalesced: int = 0      # scalar entry-list deliveries merged
    plan_cold_builds: int = 0      # ShardPlan built from scratch
    plan_delta_refreshes: int = 0  # ShardPlan patched in place
    plan_rows_refreshed: int = 0   # rows re-evaluated by delta refreshes
    plan_cache_evictions: int = 0  # ShardPlans dropped by the LRU budget
    tx_batches: int = 0            # group-commit windows flushed
    tx_batch_size_sum: int = 0     # transactions admitted across windows
    conflict_rows_checked: int = 0  # (tx, vid) last-update rows compared
    #                                 by the vectorized batch validator
    ragged_replies: int = 0        # RaggedReply output payloads shipped
    #                                by frontier steps (get_edges)
    ragged_values: int = 0         # total edge positions across them
    store_lastupdate_gcd: int = 0  # LastUpdateTable rows dropped by the
    #                                store GC hook (≺ global horizon)
    store_vertices_gcd: int = 0    # deleted StoredVertex records dropped
    #                                by the store GC hook
    store_txresults_gcd: int = 0   # recorded tx outcomes pruned by the
    #                                store GC hook (older than the
    #                                client retry session bound)
    wal_records: int = 0           # redo WAL records appended (tx + group)
    wal_ckpts: int = 0             # WAL checkpoint rewrites at store GC
    wal_replay_ops: int = 0        # ops replayed from the WAL into
    #                                promoted shard backups
    wal_torn_truncated: int = 0    # torn-tail entries truncated by replay
    tx_dedup_hits: int = 0         # resubmitted txs answered from
    #                                store.tx_results instead of
    #                                re-executing (exactly-once)
    shard_dedup_skips: int = 0     # already-applied stamps skipped by a
    #                                shard (re-forwarded after recovery)
    client_retries: int = 0        # client session resubmissions after
    #                                an ack timeout
    client_gaveup: int = 0         # client sessions that exhausted the
    #                                retry budget (error surfaced)
    group_txs_lost: int = 0        # admitted-but-unflushed window txs
    #                                that died with their gatekeeper
    #                                (clients recover them via retry)
    crashes_injected: int = 0      # FaultPlan crash points fired
    msgs_dropped: int = 0          # messages dropped by fault injection
    msgs_duplicated: int = 0       # messages duplicated by fault injection
    msgs_delayed: int = 0          # messages delayed by fault injection
    prog_batches: int = 0          # windowed read-admission flushes
    prog_batch_size_sum: int = 0   # programs admitted across read windows
    read_progs_lost: int = 0       # window reads that died with their
    #                                gatekeeper (read sessions recover
    #                                them via timeout resubmission)
    progs_shed: int = 0            # program submissions shed by gatekeeper
    #                                admission backpressure
    txs_shed: int = 0              # tx submissions shed by gatekeeper
    #                                admission backpressure
    prog_retries: int = 0          # read-session resubmissions after an
    #                                ack timeout (shed/loss recovery)
    prog_gaveup: int = 0           # read sessions that exhausted the
    #                                retry budget (None result surfaced)
    revalidations_skipped: int = 0  # commit-instant write-set
    #                                 revalidations skipped because the
    #                                 LastUpdateTable mutation sequence
    #                                 number did not move since admission
    acks_deferred: int = 0         # tx acks deferred until every
    #                                destination shard applied
    #                                (read_your_writes mode)
    shed_nacks: int = 0            # explicit reject replies sent for
    #                                admission sheds (nack_shed mode)
    nack_reroutes: int = 0         # session re-routes to another
    #                                gatekeeper triggered by a shed NACK
    #                                (same attempt — no timer burned)
    crossgk_batch_merges: int = 0  # shard reorder-buffer merges that
    #                                pulled runnable items from another
    #                                gatekeeper's queued batch into one
    #                                bulk apply
    crossgk_merged_txs: int = 0    # foreign-queue txs applied by those
    #                                merges
    #                              (the admission window / batch-depth
    #                               histograms formerly kept here as
    #                               dict fields now live in the metrics
    #                               registry: sim.metrics histograms
    #                               "admission_window_us" and
    #                               "admission_depth")
    window_grows_shared: int = 0   # AdaptiveWindow growth steps
    #                                triggered ONLY by the shared
    #                                deployment load signal (local
    #                                backlog idle, a peer saturated)
    read_windows_aliased: int = 0  # read windows that reused the
    #                                previous window's stamp because
    #                                the LastUpdateTable mutation seqno
    #                                did not move (plans/caches shared)
    nbr_rows_cached: int = 0       # clustering phase-1 origin rows
    #                                shipped as cache markers instead of
    #                                re-sending the packed values
    spans_recorded: int = 0        # [obs] trace spans recorded
    metrics_samples: int = 0       # [obs] metrics timeline rows sampled
    cross_pod_msgs: int = 0        # messages that paid the cross-pod
    #                                latency surcharge (sender and
    #                                receiver in different pods)
    stamps_settled: int = 0        # read stamps a primary shard marked
    #                                settled (mapped to a change-feed
    #                                position and broadcast to
    #                                gatekeepers for replica routing)
    replica_feed_pulls: int = 0    # change-feed pull requests received
    #                                by primaries from replicas
    replica_feed_entries: int = 0  # feed (stamp, ops) entries shipped
    #                                to replicas in pull responses
    replica_cold_resyncs: int = 0  # replica full-state rebuilds (feed
    #                                truncated past the replica's cursor
    #                                or primary incarnation changed)
    replica_reads_served: int = 0  # read executions served by a replica
    #                                instead of its primary
    replica_read_handoffs: int = 0  # replica-routed reads forwarded
    #                                 back to the primary (settlement
    #                                 token unavailable at the replica)
    replica_promotions: int = 0    # failovers that promoted a caught-up
    #                                replica (partition adopted, WAL
    #                                top-up instead of full replay)

    def snapshot(self) -> dict:
        return {k: (dict(v) if isinstance(v, dict) else v)
                for k, v in self.__dict__.items()}


class Simulator:
    """Deterministic discrete-event loop."""

    def __init__(self, seed: int = 0, network: Optional[NetworkModel] = None):
        self.now: float = 0.0
        self._heap: list = []
        self._seq = itertools.count()
        self.rng = np.random.default_rng(seed)
        self.network = network or NetworkModel()
        self.counters = Counters()
        # optional repro_torch.core.faultinject.FaultInjector; consulted by
        # send() for message faults and by actors at named crash points
        self.fault = None
        # optional repro_torch.core.obs.Tracer (None == tracing disabled; every
        # hook site guards on this) and the always-on metrics registry
        self.tracer = None
        from .obs import MetricsRegistry
        self.metrics = MetricsRegistry()
        # FIFO enforcement: last scheduled delivery time per (src_id, dst_id)
        self._channel_clock: dict[tuple[int, int], float] = {}
        self._actor_ids = itertools.count()
        self._stopped = False

    # ---- actor registry ------------------------------------------------
    def register(self, actor: Any) -> int:
        aid = next(self._actor_ids)
        actor._sim_id = aid
        return aid

    # ---- scheduling ----------------------------------------------------
    def _ctx(self):
        """Ambient trace context to attach to a new event (None when
        tracing is off or the current event is untraced)."""
        return self.tracer.current if self.tracer is not None else None

    def schedule(self, delay: float, fn: Callable, *args) -> None:
        heapq.heappush(self._heap, (self.now + delay, next(self._seq),
                                    fn, args, self._ctx()))

    def send(self, src: Any, dst: Any, fn: Callable, *args, nbytes: int = 256,
             local: bool = False) -> None:
        """Deliver ``fn(*args)`` at ``dst`` after a network delay.

        FIFO per (src, dst) channel: delivery time is clamped to be >= the
        last delivery time already scheduled on the channel.

        An installed fault injector may drop, duplicate or delay the
        message (restricted to client-boundary messages so shard FIFO
        channels cannot stall; see ``repro_torch.core.faultinject``).
        """
        self.counters.messages_sent += 1
        self.counters.bytes_sent += nbytes
        # deployment pods: a message between actors placed in different
        # pods pays a deterministic WAN surcharge (no extra RNG draw, so
        # single-pod runs are bit-identical to pre-pod builds)
        pod_extra = 0.0
        sp = getattr(src, "pod", None)
        dp = getattr(dst, "pod", None)
        if sp is not None and dp is not None and sp != dp:
            pod_extra = self.network.cross_pod_latency
            self.counters.cross_pod_msgs += 1
        extra = 0.0
        if self.fault is not None:
            verdict, extra = self.fault.on_send(getattr(fn, "__name__", ""))
            if verdict == "drop":
                self.counters.msgs_dropped += 1
                return
            if verdict == "dup":
                self.counters.msgs_duplicated += 1
                d2 = self.network.delay(nbytes, self.rng, local=local)
                heapq.heappush(self._heap,
                               (self.now + d2 + pod_extra, next(self._seq),
                                fn, args, self._ctx()))
            elif verdict == "delay":
                self.counters.msgs_delayed += 1
        d = self.network.delay(nbytes, self.rng, local=local) + extra + pod_extra
        t = self.now + d
        key = (getattr(src, "_sim_id", -1), getattr(dst, "_sim_id", -1))
        prev = self._channel_clock.get(key, 0.0)
        if t < prev:
            t = prev + 1e-9
        self._channel_clock[key] = t
        heapq.heappush(self._heap, (t, next(self._seq), fn, args,
                                    self._ctx()))

    def call_after(self, delay: float, fn: Callable, *args) -> None:
        self.schedule(delay, fn, *args)

    # ---- main loop -----------------------------------------------------
    def run(self, until: Optional[float] = None, max_events: int = 50_000_000) -> None:
        self._stopped = False
        n = 0
        while self._heap and not self._stopped:
            t, _, fn, args, ctx = self._heap[0]
            if until is not None and t > until:
                self.now = until
                return
            heapq.heappop(self._heap)
            self.now = t
            if self.tracer is not None:
                self.tracer.current = ctx
                try:
                    fn(*args)
                finally:
                    self.tracer.current = None
            else:
                fn(*args)
            n += 1
            if n >= max_events:
                raise RuntimeError(f"simulation exceeded {max_events} events")

    def stop(self) -> None:
        self._stopped = True

    def pending(self) -> int:
        return len(self._heap)


class PeriodicTimer:
    """Re-arming timer; ``period`` may be changed dynamically (tau tuning)."""

    def __init__(self, sim: Simulator, period: float, fn: Callable,
                 start_delay: Optional[float] = None):
        self.sim = sim
        self.period = period
        self.fn = fn
        self.cancelled = False
        if period > 0:
            sim.schedule(start_delay if start_delay is not None else period, self._fire)

    def _fire(self) -> None:
        if self.cancelled or self.period <= 0:
            return
        self.fn()
        self.sim.schedule(self.period, self._fire)

    def cancel(self) -> None:
        self.cancelled = True
