"""Deterministic fault injection for the Weaver control plane (§4.3).

A seeded :class:`FaultPlan` is a list of :class:`FaultAction` firing
rules; :class:`FaultInjector` (installed as ``Simulator.fault``, wired
by ``WeaverConfig.fault_plan``) evaluates them at two kinds of sites:

* **Named crash points** — actors call ``_crash_point(point)`` at the
  protocol steps the recovery machinery must survive:

  - ``mid_window``       a gatekeeper dies with an admitted-but-unflushed
                         group-commit window (``Gatekeeper.submit_tx``);
  - ``pre_wal``          a gatekeeper dies after validation, before the
                         store apply — nothing durable, nothing forwarded;
  - ``mid_wal``          the store's group append is cut short: a torn
                         tail is left on the log (``valid`` watermark)
                         and the writing gatekeeper dies with it;
  - ``post_wal``         a gatekeeper dies after the WAL durability
                         point but before forwarding/replying — the
                         classic lost-ack window exactly-once dedup
                         must close;
  - ``mid_shard_apply``  a shard dies while draining its queues;
  - ``epoch_barrier``    a *second* actor (the action's ``target``) is
                         killed while the cluster manager commits a new
                         epoch.

* **Message faults** — ``Simulator.send`` asks :meth:`on_send` whether
  to drop, duplicate or delay a message.  Drops and dups are restricted
  to client-boundary and read-path handlers (``reply``, ``submit_tx``,
  ``_resubmit``, ``submit_program``, ``deliver_prog_batch``) because
  gatekeeper->shard write channels are FIFO-with-sequence-numbers: a
  dropped ``enqueue`` would stall the channel forever, which models a
  TCP connection loss, not a packet fault.  Read deliveries carry no
  sequence numbers: a dropped window is recovered by the client read
  sessions (``read_retry_timeout``), a duplicated one is absorbed by
  shard coalescing plus the coordinator's per-delivery report guard
  (single-hop programs; multi-hop dup semantics are not modeled).
  Replica change-feed handlers (``feed_pull`` / ``feed_apply`` /
  ``feed_reset``) are also faultable: strict cursor matching makes a
  dropped, duplicated or delayed feed response a no-op beyond added
  lag, which the replica-consistency battery exercises directly
  (``replica_faults``).

Occurrence counting (``after`` / ``count``) makes every plan
deterministic for a given workload; :meth:`FaultPlan.random` draws a
randomized kill schedule from a seed for the chaos property test.  An
injector starts armed; tests that need fault-free setup traffic
construct it disarmed and :meth:`FaultInjector.arm` it when ready.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

#: crash points an actor may hit itself (epoch_barrier is fired by the
#: cluster manager against the action's target instead)
CRASH_POINTS = ("mid_window", "pre_wal", "mid_wal", "post_wal",
                "mid_shard_apply", "epoch_barrier")


@dataclass
class FaultAction:
    """One firing rule.

    ``kind``: ``"crash"`` (kill ``target`` at ``point``), ``"torn"``
    (cut the group WAL append short — ``arg`` entries survive — and kill
    the writing gatekeeper), or a message fault ``"drop"`` / ``"dup"`` /
    ``"delay"`` (``target`` is then the handler function name).
    ``after`` skips that many matching occurrences before firing;
    ``count`` bounds how many times the rule fires."""

    kind: str
    point: str = ""
    target: str = "*"
    after: int = 0
    count: int = 1
    delay: float = 0.0
    arg: int = 1
    _seen: int = field(default=0, repr=False)
    _fired: int = field(default=0, repr=False)

    def matches(self, point: str, target: str) -> bool:
        return (self.point == point
                and (self.target == "*" or self.target == target))

    def fire(self) -> bool:
        """Occurrence-count one matching site; True when the rule fires."""
        self._seen += 1
        if self._seen <= self.after or self._fired >= self.count:
            return False
        self._fired += 1
        return True


@dataclass
class FaultPlan:
    actions: List[FaultAction] = field(default_factory=list)
    seed: int = 0

    @staticmethod
    def random(seed: int, n_gk: int, n_shards: int, n_crashes: int = 2,
               msg_faults: bool = True, max_after: int = 6,
               replica_faults: bool = False) -> "FaultPlan":
        """A seeded randomized kill schedule over every named crash
        point (the chaos property test's generator).  With
        ``replica_faults`` the plan also hits the change-feed channel:
        random drop/dup/delay on each feed handler plus one sustained
        delayed-``feed_apply`` burst that models a lagging replica."""
        rng = np.random.default_rng(seed)
        actors = [f"gk{g}" for g in range(n_gk)] + \
                 [f"shard{s}" for s in range(n_shards)]
        actions: List[FaultAction] = []
        for _ in range(n_crashes):
            point = CRASH_POINTS[int(rng.integers(len(CRASH_POINTS)))]
            if point == "mid_shard_apply":
                target = f"shard{int(rng.integers(n_shards))}"
            elif point == "epoch_barrier":
                target = actors[int(rng.integers(len(actors)))]
            else:
                target = f"gk{int(rng.integers(n_gk))}"
            kind = "torn" if point == "mid_wal" else "crash"
            actions.append(FaultAction(kind, point=point, target=target,
                                       after=int(rng.integers(max_after)),
                                       arg=1 + int(rng.integers(3))))
        if msg_faults:
            for fn in ("reply", "submit_tx"):
                k = ("drop", "dup", "delay")[int(rng.integers(3))]
                actions.append(FaultAction(
                    k, target=fn, after=int(rng.integers(max_after)),
                    count=1 + int(rng.integers(3)),
                    delay=float(rng.uniform(0.5e-3, 3e-3))))
        if replica_faults:
            for fn in ("feed_pull", "feed_apply", "feed_reset"):
                k = ("drop", "dup", "delay")[int(rng.integers(3))]
                actions.append(FaultAction(
                    k, target=fn, after=int(rng.integers(max_after)),
                    count=1 + int(rng.integers(4)),
                    delay=float(rng.uniform(0.5e-3, 3e-3))))
            # sustained replica lag: a burst of delayed feed responses
            actions.append(FaultAction(
                "delay", target="feed_apply",
                after=int(rng.integers(max_after)),
                count=8 + int(rng.integers(8)),
                delay=float(rng.uniform(2e-3, 8e-3))))
        return FaultPlan(actions, seed=seed)


class FaultInjector:
    """Evaluates a :class:`FaultPlan` deterministically; install as
    ``sim.fault``.  All hits are tallied into the simulator counters."""

    #: handlers message faults may touch: client boundary plus the
    #: replica change-feed channel (see module docstring for why shard
    #: write channels are exempt)
    FAULTABLE_FNS = ("reply", "submit_tx", "_resubmit", "submit_program",
                     "deliver_prog_batch",
                     "feed_pull", "feed_apply", "feed_reset")

    def __init__(self, plan: FaultPlan, sim, armed: bool = True):
        self.plan = plan
        self.sim = sim
        self.armed = armed

    def arm(self) -> None:
        self.armed = True

    def disarm(self) -> None:
        self.armed = False

    # ---- crash points ------------------------------------------------------
    def crash(self, point: str, name: str) -> bool:
        """Should the actor ``name`` die at ``point`` now?"""
        if not self.armed:
            return False
        for a in self.plan.actions:
            if a.kind == "crash" and a.matches(point, name) and a.fire():
                self.sim.counters.crashes_injected += 1
                return True
        return False

    def torn_limit(self, name: str) -> Optional[int]:
        """Entries that survive gatekeeper ``name``'s next group append,
        or None for no mid-WAL fault."""
        if not self.armed:
            return None
        for a in self.plan.actions:
            if a.kind == "torn" and a.matches("mid_wal", name) and a.fire():
                self.sim.counters.crashes_injected += 1
                return a.arg
        return None

    def barrier_victims(self) -> List[str]:
        """Actors to kill while the epoch barrier commits."""
        if not self.armed:
            return []
        out = []
        for a in self.plan.actions:
            if (a.kind == "crash" and a.point == "epoch_barrier"
                    and a.fire()):
                self.sim.counters.crashes_injected += 1
                out.append(a.target)
        return out

    # ---- message faults ----------------------------------------------------
    def on_send(self, fn_name: str) -> Tuple[str, float]:
        """Verdict for one outgoing message: ``("pass"|"drop"|"dup"|
        "delay", extra_delay)``."""
        if self.armed and fn_name in self.FAULTABLE_FNS:
            for a in self.plan.actions:
                if a.kind in ("drop", "dup", "delay") \
                        and (a.target == "*" or a.target == fn_name) \
                        and a.fire():
                    return a.kind, (a.delay if a.kind == "delay" else 0.0)
        return "pass", 0.0
