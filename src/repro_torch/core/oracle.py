"""Timeline oracle (Kronos [EuroSys'14] stand-in) — paper §3.4, §4.2.

The oracle maintains a DAG of *events* (one per transaction / node
program, identified by the stamp's unique key) whose edges are
happens-before commitments.  Guarantees, per the paper:

* **acyclicity** — an ``assert_order`` that would close a cycle is refused;
* **transitivity** — queries answer through any chain of explicit edges
  *and* vector-clock-implied order ("the timeline oracle can infer and
  maintain any implicit dependencies captured by the vector clocks");
* **monotonicity** — decisions are irreversible, so shard servers may
  cache them (we expose a ``version`` so negative caches can be
  invalidated cheaply);
* **node-program rule** — when no order exists between a node program and
  a committed write, the program is ordered *after* the write (§4.2,
  wall-clock freshness).

``TimelineOracle`` is the pure state machine; ``OracleServer`` wraps it as
a simulator actor (the Paxos-replicated deployment of the paper maps to a
single authoritative state machine with a configurable commit latency).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .clock import Order, Stamp, compare
from .simulation import Simulator

Key = Tuple[int, int, int]


class CycleError(Exception):
    pass


KIND_TX = 0
KIND_PROG = 1


@dataclass
class _Event:
    stamp: Stamp
    kind: int = KIND_TX
    succ: Set[Key] = field(default_factory=set)
    pred: Set[Key] = field(default_factory=set)


class TimelineOracle:
    """Pure event-ordering state machine."""

    def __init__(self) -> None:
        self.events: Dict[Key, _Event] = {}
        self.version = 0              # bumps on any new event/edge
        self._pos_cache: Set[Tuple[Key, Key]] = set()   # reach(a,b) == True

    # ---- event lifecycle -------------------------------------------------
    def create_event(self, stamp: Stamp, kind: int = KIND_TX) -> Key:
        k = stamp.key()
        if k not in self.events:
            self.events[k] = _Event(stamp, kind)
            self.version += 1
        return k

    def collect(self, horizon: Stamp) -> int:
        """GC: drop events strictly before ``horizon`` (paper §4.5).

        Future stamps are strictly greater than the horizon, so expired
        events can never conflict again.
        """
        dead = [k for k, e in self.events.items()
                if compare(e.stamp, horizon) is Order.BEFORE]
        for k in dead:
            ev = self.events.pop(k)
            for s in ev.succ:
                if s in self.events:
                    self.events[s].pred.discard(k)
            for p in ev.pred:
                if p in self.events:
                    self.events[p].succ.discard(k)
        if dead:
            self.version += 1
            self._pos_cache = {(a, b) for (a, b) in self._pos_cache
                               if a in self.events and b in self.events}
        return len(dead)

    # ---- reachability over the mixed graph --------------------------------
    def _reach_full(self, a: Key, b: Key,
                    vc: Optional[Dict[Key, List[Key]]] = None) -> bool:
        """a ⤳ b over the mixed graph: explicit edges ∪ vclock-implied hops.

        neighbor(x) = succ(x) ∪ {y : stamp(x) ≺ stamp(y)}.  Correct because
        both edge kinds are valid happens-before relations and the relation
        we want is their transitive closure.

        ``vc`` caches each visited event's vclock-implied successors; it
        holds while no event is added or dropped (explicit edges may be,
        and do not enter it), so :meth:`order_events` shares one across
        the searches of a request, and a lone search makes its own.
        """
        if a == b:
            return True
        if (a, b) in self._pos_cache:
            return True
        vc = {} if vc is None else vc
        sb = self.events[b].stamp
        seen = {a}
        stack = [a]
        while stack:
            x = stack.pop()
            ex = self.events[x]
            # explicit successors
            for y in ex.succ:
                if y == b:
                    self._pos_cache.add((a, b))
                    return True
                if y in self.events and y not in seen:
                    seen.add(y)
                    stack.append(y)
            # vclock-implied successors
            sx = ex.stamp
            if compare(sx, sb) is Order.BEFORE:
                self._pos_cache.add((a, b))
                return True
            after = vc.get(x)
            if after is None:
                after = vc[x] = [y for y, ey in self.events.items()
                                 if compare(sx, ey.stamp) is Order.BEFORE]
            for y in after:
                if y not in seen:
                    seen.add(y)
                    stack.append(y)
        return False

    def _order(self, a: Key, b: Key,
               vc: Optional[Dict[Key, List[Key]]] = None) -> Optional[Order]:
        if a not in self.events or b not in self.events:
            return None
        if a == b:
            return Order.EQUAL
        if self._reach_full(a, b, vc):
            return Order.BEFORE
        if self._reach_full(b, a, vc):
            return Order.AFTER
        return None

    def _commit(self, a: Key, b: Key,
                vc: Optional[Dict[Key, List[Key]]] = None) -> None:
        if self._reach_full(a, b, vc):
            return
        if self._reach_full(b, a, vc):
            raise CycleError(f"cannot order {a} before {b}: reverse path exists")
        self.events[a].succ.add(b)
        self.events[b].pred.add(a)
        self.version += 1

    # ---- public API --------------------------------------------------------
    def query_order(self, a: Key, b: Key) -> Optional[Order]:
        """Existing order between two events, or None."""
        return self._order(a, b)

    def assert_order(self, a: Key, b: Key) -> None:
        """Commit a ≺ b; raises CycleError if b ⤳ a already."""
        self._commit(a, b)

    def order_events(self, stamps: Sequence[Stamp],
                     kinds: Optional[Sequence[int]] = None) -> List[Key]:
        """Atomically produce (and commit) a total order for ``stamps``.

        Consistent with all existing commitments and vclock order.  When a
        node program and a transaction are unordered, the program goes
        AFTER the transaction (§4.2).  Ties between transactions break
        deterministically on the stamp key (epoch, clock, gk), so
        independent requests mentioning the same concurrent pair commit
        the same edge instead of contradictory ones.

        Duplicate stamps are collapsed by key: callers batch one request
        per *row* they are refining, and many rows share one writing
        transaction's stamp (a tx that touched k objects contributes k
        identical entries).  The returned chain therefore has one entry
        per distinct key — callers index it by key, never by request
        position.  (Before this dedup, a duplicated key with pending
        predecessors entered Kahn's ready set once while ``n`` counted
        its repeats, so heavily-concurrent batches raised a spurious
        ``CycleError`` from an acyclic constraint set.)
        """
        kinds = list(kinds) if kinds is not None else [KIND_TX] * len(stamps)
        keys: List[Key] = []
        seen = set()
        for s, k in zip(stamps, kinds):
            key = self.create_event(s, k)
            if key not in seen:
                seen.add(key)
                keys.append(key)
        n = len(keys)
        # pairwise existing constraints; every search of the request,
        # the commits' included, shares one cache of vclock successors
        pred_count = {k: 0 for k in keys}
        adj: Dict[Key, Set[Key]] = {k: set() for k in keys}
        vc: Dict[Key, List[Key]] = {}
        for i in range(n):
            for j in range(i + 1, n):
                a, b = keys[i], keys[j]
                o = self._order(a, b, vc)
                if o is Order.BEFORE:
                    adj[a].add(b)
                elif o is Order.AFTER:
                    adj[b].add(a)
        for k, vs in adj.items():
            for v in vs:
                pred_count[v] += 1
        # Kahn with deterministic priority: txs before progs, then stamp key
        def prio(k: Key) -> Tuple:
            ev = self.events[k]
            return (ev.kind, k)
        import heapq
        ready = [(prio(k), k) for k in keys if pred_count[k] == 0]
        heapq.heapify(ready)
        out: List[Key] = []
        while ready:
            _, k = heapq.heappop(ready)
            out.append(k)
            for v in adj[k]:
                pred_count[v] -= 1
                if pred_count[v] == 0:
                    heapq.heappush(ready, (prio(v), v))
        if len(out) != n:  # pragma: no cover - constraints from a DAG
            raise CycleError("constraint subgraph had a cycle")
        # commit missing edges along the chain
        for a, b in zip(out, out[1:]):
            self._commit(a, b, vc)
        return out


class OracleServer:
    """Simulator actor wrapping :class:`TimelineOracle` with RPC latency.

    ``commit_latency`` models the Paxos round of the replicated deployment.
    """

    def __init__(self, sim: Simulator, commit_latency: float = 150e-6):
        self.sim = sim
        sim.register(self)
        self.oracle = TimelineOracle()
        self.commit_latency = commit_latency

    # Async API: shard calls, reply delivered via callback after RTT.
    def request_order(self, src, stamps: Sequence[Stamp],
                      kinds: Sequence[int], reply) -> None:
        self.sim.counters.oracle_calls += 1
        def _serve():
            order = self.oracle.order_events(stamps, kinds)
            self.sim.send(self, src, reply, order, nbytes=64 * len(stamps))
        # request network hop + paxos commit
        self.sim.send(src, self, lambda: self.sim.schedule(self.commit_latency, _serve),
                      nbytes=64 * len(stamps))

    def collect(self, horizon: Stamp) -> int:
        return self.oracle.collect(horizon)
