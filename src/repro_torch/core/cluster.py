"""Cluster manager (paper §3.2, §4.3): failure detection, backup
promotion, and the epoch barrier.

Every gatekeeper and shard server sends heartbeats; when one is declared
dead the manager

1. pauses all gatekeepers (no new stamps issued),
2. increments the global *epoch*,
3. promotes a backup server — a shard backup recovers its partition from
   the backing store; a gatekeeper backup restarts the failed vector
   clock at zero in the new epoch,
4. releases the barrier: all servers enter the new epoch in unison, so
   every pre-failure stamp orders before every post-failure stamp.

The manager itself (like the timeline oracle) stands in for a
Paxos-replicated state machine.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .simulation import PeriodicTimer, Simulator


class ClusterManager:
    def __init__(self, sim: Simulator, heartbeat_period: float = 5e-3,
                 timeout_factor: float = 3.0):
        self.sim = sim
        sim.register(self)
        self.heartbeat_period = heartbeat_period
        self.timeout = heartbeat_period * timeout_factor
        self.last_seen: Dict[str, float] = {}
        self.members: Dict[str, object] = {}
        self.epoch = 0
        self.weaver = None                     # set by Weaver facade
        self._barrier_acks: int = 0
        self._in_barrier = False
        self._checker: Optional[PeriodicTimer] = None
        self.failures_handled: List[str] = []
        self._handled: set = set()

    def start(self) -> None:
        self._checker = PeriodicTimer(self.sim, self.heartbeat_period,
                                      self._check)

    def register_member(self, name: str, actor) -> None:
        self.members[name] = actor
        self.last_seen[name] = self.sim.now
        self._handled.discard(name)

    def heartbeat(self, name: str) -> None:
        self.last_seen[name] = self.sim.now

    # ---- failure detection -------------------------------------------------
    def _check(self) -> None:
        if self._in_barrier:
            return
        dead = [n for n, t in self.last_seen.items()
                if self.sim.now - t > self.timeout and n not in self._handled]
        for name in dead:
            self.on_failure(name)

    def on_failure(self, name: str) -> None:
        """Reconfigure: epoch barrier + backup promotion (§4.3)."""
        if self._in_barrier or name in self._handled:
            return
        self.failures_handled.append(name)
        self._handled.add(name)
        self._in_barrier = True
        actor = self.members[name]
        actor.alive = False
        if self.weaver is not None:
            # phase 1: pause gatekeepers (stop issuing old-epoch stamps)
            for gk in self.weaver.gatekeepers:
                gk.pause_for_epoch()
            # phase 2: promote backup
            self.weaver.promote_backup(name)
            # phase 3: commit new epoch at every server, release barrier
            self.epoch += 1
            barrier_latency = 2 * self.sim.network.base_latency
            def _commit() -> None:
                # fault injection: a SECOND failure during the barrier
                # itself — the victim dies now and is detected by the
                # normal heartbeat check once the barrier releases
                if self.sim.fault is not None:
                    for victim in self.sim.fault.barrier_victims():
                        actor = self.members.get(victim)
                        if actor is not None:
                            actor.alive = False
                for gk in self.weaver.gatekeepers:
                    gk.enter_epoch(self.epoch)
                for sh in self.weaver.shards:
                    sh.enter_epoch(self.epoch)
                self._in_barrier = False
            self.sim.schedule(barrier_latency, _commit)
        else:
            self._in_barrier = False


class HeartbeatSender:
    """Mixin-style helper wiring an actor's heartbeat timer."""

    def __init__(self, sim: Simulator, manager: ClusterManager, name: str,
                 actor) -> None:
        self.sim = sim
        self.manager = manager
        self.name = name
        self.actor = actor
        manager.register_member(name, actor)
        self.timer = PeriodicTimer(sim, manager.heartbeat_period, self._beat,
                                   start_delay=manager.heartbeat_period * 0.5)

    def _beat(self) -> None:
        if getattr(self.actor, "alive", True):
            self.manager.heartbeat(self.name)
