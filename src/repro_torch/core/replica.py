"""Change-feed read replicas (ISSUE 10).

A :class:`ReplicaShard` is a read-only copy of one primary shard, kept
fresh by pulling the primary's **change feed** — the same
``(stamp, ops)`` stream the primary's own apply path produces — and
applying it through the standard ``MVGraphPartition`` write path, so the
replica's ``PartitionColumns`` delta-refresh its ``ShardPlan``s via the
exact ``cursor()`` / ``CompactionEvent`` contract every other columns
consumer uses.  A replica is "just another delta-refreshed columns
consumer" (ROADMAP big direction 1).

Consistency protocol (why replica reads are bit-identical)
----------------------------------------------------------
Replicas never participate in write ordering; they serve reads only at
**settled** stamps.  A primary settles a read stamp ``w`` the first time
a program at ``w`` becomes runnable: at that instant every gatekeeper
queue head is (or is refined to be) after ``w``, so per-gatekeeper stamp
monotonicity plus the irreversibility of committed oracle orderings
guarantee no write ordered before ``w`` can ever arrive later.  The
primary binds ``w`` to its current feed position ``p`` (a *settlement
token*) — every write visible at ``w`` is in the feed prefix ``[0, p)``.
A replica whose applied position has reached ``p`` therefore holds a
state whose visibility at ``w`` equals the primary's, and refinement
verdicts come from the shared timeline oracle (committed = immutable),
so execution is bit-identical.  Gatekeepers learn tokens by broadcast
and route subsequent same-stamp read windows (the aliased-window hot
path) to any caught-up replica; the first window at a fresh stamp is
always primary-served — the primary remains the semantic oracle.

Liveness: deliveries at a stamp whose token the replica doesn't hold
trigger an immediate feed pull; if a pull requested *after* the
delivery still lacks the token, the delivery is handed back to the
primary (``replica_read_handoffs``), so no read can wedge on a replica.
Feed faults (drop/dup/delay — see ``repro_torch.core.faultinject``) are
absorbed by strict cursor matching: a response only applies when it
starts exactly at the replica's applied position; anything else is
ignored and the periodic poll re-requests.  A replica behind the
primary's truncated feed tail, or subscribed to a dead incarnation,
rebuilds from a redo-op walk of the live partition (cold resync).

On primary death the failover path (``Weaver.promote_backup``) promotes
the most caught-up replica: the new primary adopts the replica's
partition and applied map and tops up only the missing WAL ops.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from .clock import Stamp
from .gatekeeper import CostModel
from .obs import stamp_attr
from .oracle import OracleServer
from .shard import Shard
from .simulation import PeriodicTimer, Simulator


class ReplicaShard(Shard):
    """Read-only shard replica fed by its primary's change feed."""

    def __init__(self, sim: Simulator, sid: int, rid: int, n_gk: int,
                 oracle: OracleServer, cost: CostModel,
                 directory: Callable[[str], Optional[int]],
                 primaries: List[Shard],
                 poll_period: float = 1e-3,
                 **shard_kw):
        super().__init__(sim, sid, n_gk, oracle, cost, directory,
                         ack_applies=False, **shard_kw)
        self.rid = rid
        self.name = f"shard{sid}r{rid}"
        # primaries is Weaver's LIVE shard list (rebound in place on
        # promotion): multi-hop frontiers from a replica hop to
        # primaries, which gate them by the normal queue-clearing rule
        self.primaries = primaries
        self.peers = primaries
        self.poll_period = poll_period
        # subscription state: absolute feed position applied so far,
        # the primary incarnation subscribed to, and settlement tokens
        # (stamp key -> feed position) learned from feed responses
        self.applied_pos = 0
        self.sub_inc = -1            # forces a cold resync on first pull
        self.tokens: Dict[Tuple, int] = {}
        # pull seq numbers let the handoff rule distinguish "the primary
        # answered a pull REQUESTED AFTER this delivery arrived and the
        # token still isn't there" from a stale in-flight response
        self._pull_seq = 0
        self._timer = PeriodicTimer(
            sim, poll_period, self._poll,
            # deterministic stagger so replica fleets don't pull in
            # lockstep
            start_delay=poll_period * (1.0 + 0.1 * (sid * 8 + rid)))

    # ------------------------------------------------------------ feed
    @property
    def primary(self) -> Optional[Shard]:
        return self.primaries[self.sid] if self.sid < len(self.primaries) \
            else None

    def stop(self) -> None:
        super().stop()
        self._timer.cancel()

    def _poll(self) -> None:
        if not self.alive:
            return
        p = self.primary
        if p is None or not p.alive or p is self:
            return
        self._pull_seq += 1
        self.sim.send(self, p, p.feed_pull, self, self.applied_pos,
                      self.sub_inc, self._pull_seq, nbytes=48)

    def feed_apply(self, from_pos: int, entries, tokens: Dict,
                   inc: int, seq: int) -> None:
        """Incremental feed response.  Applies only when it starts
        exactly at our applied position — dropped/duplicated/delayed
        responses can never skip or double-apply ops, they just leave a
        gap the next poll refills."""
        if not self.alive or inc != self.sub_inc:
            return
        if entries and from_pos == self.applied_pos:
            n_ops = self._apply_deduped(entries)
            self.applied_pos += len(entries)
            self._busy_charge(self.cost.shard_op * max(1, n_ops))
        self._merge_tokens(tokens)
        self._after_feed(seq)

    def feed_reset(self, inc: int, pos: int, ops: List[dict],
                   tokens: Dict, seq: int) -> None:
        """Full-state resync: the feed was truncated past our cursor or
        the primary is a new incarnation.  Rebuild from the redo walk."""
        if not self.alive:
            return
        self.sim.counters.replica_cold_resyncs += 1
        self.sub_inc = inc
        self.recover_from(ops)           # fresh partition + applied map
        self.applied_pos = pos
        self.tokens = {}
        self._merge_tokens(tokens)
        self._busy_charge(self.cost.shard_op * max(1, len(ops)))
        self._after_feed(seq)

    def _merge_tokens(self, tokens: Dict) -> None:
        if len(self.tokens) > 20_000:    # bounded, like primary.settled:
            self.tokens.clear()          # a lost token means handoff
        self.tokens.update(tokens)

    def _busy_charge(self, service: float) -> None:
        """Charge feed-apply service time when idle (an apply landing
        mid-execution just extends the next drain's start)."""
        if not self.busy:
            self._finish_after(service)

    def _after_feed(self, seq: int) -> None:
        self._advertise()
        self._forward_unsettled(seq)
        self._kick()

    def _advertise(self) -> None:
        """Tell every gatekeeper the applied-stamp frontier: any settled
        stamp whose token position is <= applied_pos (same incarnation)
        is servable here."""
        for gk in self.gatekeepers:
            if getattr(gk, "alive", False):
                self.sim.send(self, gk, gk.on_replica_frontier, self.sid,
                              self.rid, self.sub_inc, self.applied_pos,
                              nbytes=48)

    def _forward_unsettled(self, seq: int) -> None:
        """Hand deliveries whose stamp the primary no longer has a
        token for back to the primary.  Only deliveries older than the
        pull this response answers are eligible — the response proves
        the primary's token map (sent in full) lacks their stamp."""
        p = self.primary
        if p is None or not p.alive or p is self:
            return
        fwd = [pr for pr in self.pending_progs
               if pr.get("pseq", 0) < seq
               and pr["stamp"].key() not in self.tokens]
        if not fwd:
            return
        fwd_ids = {id(pr) for pr in fwd}
        self.pending_progs = [pr for pr in self.pending_progs
                              if id(pr) not in fwd_ids]
        self.sim.counters.replica_read_handoffs += len(fwd)
        dels = [(pr["prog_id"], pr["delivery_id"], pr["name"],
                 pr["stamp"], pr["entries"], pr["coordinator"])
                for pr in fwd]
        nbytes = 64 + sum(32 + 48 * len(d[4]) for d in dels)
        self.sim.send(self, p, p.deliver_prog_batch, dels, nbytes=nbytes)

    # ------------------------------------------------------- read path
    def _mark_arrivals(self) -> None:
        """Stamp new deliveries with the current pull seq (handoff
        eligibility) and pull immediately if any lacks a token."""
        need_pull = False
        for pr in self.pending_progs:
            if "pseq" not in pr:
                pr["pseq"] = self._pull_seq
                if pr["stamp"].key() not in self.tokens:
                    need_pull = True
        if need_pull:
            self._poll()

    def deliver_prog(self, prog_id, delivery_id, name, stamp, entries,
                     coordinator) -> None:
        super().deliver_prog(prog_id, delivery_id, name, stamp, entries,
                             coordinator)
        if self.alive:
            self._mark_arrivals()

    def deliver_prog_batch(self, deliveries) -> None:
        super().deliver_prog_batch(deliveries)
        if self.alive:
            self._mark_arrivals()

    def _next_delivery(self):
        """Child delivery ids are namespaced ``(sid, seq)`` with a
        per-actor seq — a replica shares ``sid`` with its primary, so
        without its own namespace a replica-emitted child id could
        collide with a primary-emitted one for the SAME program and the
        coordinator's announced/reported sets would close early."""
        self._delivery_ctr = getattr(self, "_delivery_ctr", 0) + 1
        return ("r", self.rid, self._delivery_ctr)

    def _runnable_prog_index(self) -> Optional[int]:
        """Replica gate: a program runs iff its stamp is settled (we
        hold the token) AND our applied position covers the token — no
        queue clearing, no write ordering (the primary already did both
        when it settled the stamp)."""
        for i, prog in enumerate(self.pending_progs):
            pos = self.tokens.get(prog["stamp"].key())
            if pos is not None and self.applied_pos >= pos:
                return i
        return None

    def _exec_prog(self, prog_id, delivery_id, name: str, stamp: Stamp,
                   entries, coordinator, extra_ids=None) -> float:
        self.sim.counters.replica_reads_served += 1
        tr = self.sim.tracer
        if tr is not None:
            ctx = tr.ctx_for_prog(prog_id)
            if ctx is not None:
                now = self.sim.now
                tr.span("replica_read", now, now, actor=self.name,
                        ctx=ctx, shard=self.sid, replica=self.rid,
                        settle_pos=self.tokens.get(stamp.key(), -1),
                        applied_pos=self.applied_pos,
                        stamp=stamp_attr(stamp))
        return super()._exec_prog(prog_id, delivery_id, name, stamp,
                                  entries, coordinator,
                                  extra_ids=extra_ids)
