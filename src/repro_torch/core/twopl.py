"""Two-phase-locking distributed graph store — the Titan stand-in (§5.2).

Titan v0.4.2 "uses two-phase commit with distributed locking in the
commit phase to ensure serializability [and] always has to
pessimistically lock all objects in the transaction, irrespective of the
ratio of reads and writes".  This engine reproduces that cost model on
the same simulator, same cost constants and same graph sharding as
Weaver, so throughput/latency comparisons are apples-to-apples:

* every transaction (reads included) acquires locks on all touched
  vertices, in global vid order (deadlock-free), one lock-manager RPC per
  vertex to the owning shard;
* writes then apply at the owning shards; a two-phase commit (prepare +
  commit RPC per participant shard) finishes the transaction;
* locks release with the commit message.

Contention on hot vertices serializes behind the FIFO lock queues.

Pure Python over the port's simulator and cost model, as the reference's
``core/twopl.py``: the same ops and seed give the same replies,
simulated latencies and ``sim.now``.  Placement hashes vertex ids with
Python's salted ``hash``, so compare runs inside one process.
"""

from __future__ import annotations

import itertools
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from .gatekeeper import CostModel
from .simulation import NetworkModel, Simulator


class LockShard:
    """Shard server: lock table + graph data (single-version; 2PL needs none).

    ``LOCK_CLAIM`` models Titan's consistency protocol: a lock is a
    *claim column* written to the backing store (Cassandra quorum write +
    re-read to verify the claim won) before the transaction may proceed —
    milliseconds per locked key on the paper's hardware.  Titan's default
    ``storage.lock-wait-time`` is 100 ms per key; 5 ms here is
    deliberately conservative (favours the baseline).
    """

    LOCK_CLAIM = 5e-3

    def __init__(self, sim: Simulator, sid: int, cost: CostModel):
        self.sim = sim
        sim.register(self)
        self.sid = sid
        self.cost = cost
        self.locks: Dict[str, deque] = {}          # vid -> waiter queue
        self.holder: Dict[str, int] = {}           # vid -> tx id
        self.vertices: Dict[str, dict] = {}        # vid -> {edges, props}

    def acquire(self, requester, txid: int, vid: str, grant: Callable) -> None:
        q = self.locks.setdefault(vid, deque())
        if vid not in self.holder:
            self.holder[vid] = txid
            self.sim.schedule(self.cost.lock_op + self.LOCK_CLAIM,
                              lambda: self.sim.send(self, requester, grant))
        else:
            self.sim.counters.lock_waits += 1
            q.append((requester, txid, grant))

    def release(self, txid: int, vids: List[str]) -> None:
        for vid in vids:
            if self.holder.get(vid) == txid:
                del self.holder[vid]
                q = self.locks.get(vid)
                if q:
                    requester, ntx, grant = q.popleft()
                    self.holder[vid] = ntx
                    self.sim.schedule(self.cost.lock_op + self.LOCK_CLAIM,
                                      lambda g=grant, r=requester:
                                      self.sim.send(self, r, g))

    # ---- data ops (executed under locks) --------------------------------
    def apply_ops(self, ops: List[dict]) -> None:
        for op in ops:
            k = op["op"]
            if k == "create_vertex":
                self.vertices[op["vid"]] = {"edges": {}, "props": {}}
            elif k == "delete_vertex":
                self.vertices.pop(op["vid"], None)
            elif k == "create_edge":
                self.vertices[op["src"]]["edges"][op["eid"]] = op["dst"]
            elif k == "delete_edge":
                self.vertices[op["src"]]["edges"].pop(op["eid"], None)
            elif k == "set_vertex_prop":
                self.vertices[op["vid"]]["props"][op["key"]] = op["value"]

    def read_vertex(self, vid: str) -> Optional[dict]:
        return self.vertices.get(vid)


class TwoPLStore:
    """Client-facing coordinator implementing lock -> execute -> 2PC."""

    def __init__(self, n_shards: int = 4, cost: Optional[CostModel] = None,
                 network: Optional[NetworkModel] = None, seed: int = 0):
        self.sim = Simulator(seed=seed, network=network or NetworkModel())
        self.sim.register(self)
        self.cost = cost or CostModel()
        self.shards = [LockShard(self.sim, s, self.cost)
                       for s in range(n_shards)]
        self.n_shards = n_shards
        self._txids = itertools.count(1)
        self._eids = itertools.count(1)

    def place(self, vid: str) -> int:
        return hash(vid) % self.n_shards

    def fresh_eid(self) -> int:
        return next(self._eids)

    # ---- transaction: reads and writes all lock --------------------------
    def submit(self, ops: List[dict], callback: Callable) -> None:
        txid = next(self._txids)
        t0 = self.sim.now
        touched = sorted({self._vertex_of(op) for op in ops})
        by_shard: Dict[int, List[str]] = {}
        for vid in touched:
            by_shard.setdefault(self.place(vid), []).append(vid)

        lock_plan = [(self.place(vid), vid) for vid in touched]
        state = {"i": 0, "reads": {}}

        def acquire_next() -> None:
            if state["i"] >= len(lock_plan):
                execute()
                return
            sid, vid = lock_plan[state["i"]]
            state["i"] += 1
            shard = self.shards[sid]
            self.sim.send(self, shard, shard.acquire, self, txid, vid,
                          acquire_next, nbytes=64)

        def execute() -> None:
            # apply writes at owning shards; collect reads
            writes_by_shard: Dict[int, List[dict]] = {}
            for op in ops:
                if op["op"] == "get_vertex":
                    sid = self.place(op["vid"])
                    state["reads"][op["vid"]] = \
                        self.shards[sid].read_vertex(op["vid"])
                else:
                    sid = self.place(self._vertex_of(op))
                    writes_by_shard.setdefault(sid, []).append(op)
            participants = set(by_shard) | set(writes_by_shard)
            # two-phase commit: prepare RTT then commit+release RTT
            remaining = {"n": len(participants)}

            def prepared() -> None:
                remaining["n"] -= 1
                if remaining["n"] == 0:
                    commit()

            for sid in participants:
                shard = self.shards[sid]
                wops = writes_by_shard.get(sid, [])
                def _prep(shard=shard, wops=wops):
                    shard.apply_ops(wops)
                    self.sim.send(shard, self, prepared, nbytes=32)
                self.sim.send(self, shard, _prep, nbytes=64 + 48 * len(wops))

            def commit() -> None:
                done = {"n": len(by_shard)}
                def released() -> None:
                    done["n"] -= 1
                    if done["n"] == 0:
                        self.sim.counters.tx_committed += 1
                        callback({"ok": True, "reads": state["reads"],
                                  "latency": self.sim.now - t0})
                for sid, vids in by_shard.items():
                    shard = self.shards[sid]
                    def _rel(shard=shard, vids=vids):
                        shard.release(txid, vids)
                        self.sim.send(shard, self, released, nbytes=32)
                    self.sim.send(self, shard, _rel, nbytes=64)
                if not by_shard:
                    self.sim.counters.tx_committed += 1
                    callback({"ok": True, "reads": state["reads"],
                              "latency": self.sim.now - t0})

        acquire_next()

    @staticmethod
    def _vertex_of(op: dict) -> str:
        return op.get("vid") or op.get("src")

    # ---- synchronous bootstrap (benchmark setup) --------------------------
    def load_graph(self, edges: List[Tuple[str, str]]) -> None:
        seen = set()
        for s, d in edges:
            for v in (s, d):
                if v not in seen:
                    seen.add(v)
                    self.shards[self.place(v)].vertices[v] = {
                        "edges": {}, "props": {}}
        for s, d in edges:
            eid = self.fresh_eid()
            self.shards[self.place(s)].vertices[s]["edges"][eid] = d
