"""Barrier-synchronous (GraphLab-style) traversal engines — §5.3 baseline.

Two execution engines over the same simulator, cost model and partitioned
graph as Weaver:

* **sync** — Pregel/GraphLab-sync: BFS by global supersteps; every
  superstep ends with a master barrier (all workers report, master
  broadcasts next step).  Latency stacks ``max(worker time) + barrier``
  per level — the paper's "synchronous GraphLab uses barriers".
* **async** — GraphLab-async: workers process their queues continuously
  but must acquire locks on a vertex's neighbourhood before running the
  vertex program ("prevents neighboring vertices from executing
  simultaneously"), paying a lock RPC per remote neighbour.

Weaver's node programs, by contrast, propagate shard-to-shard with no
barriers and no locks — only snapshot reads — which is where the 4-9x
latency gap of Fig. 11 comes from.

Pure Python over the port's simulator and cost model, as the reference's
``core/bsp.py``: the same graph and seed give the same answers, simulated
latencies and ``sim.now``.  Placement hashes vertex ids with Python's
salted ``hash``, so compare runs inside one process.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np

from .gatekeeper import CostModel
from .simulation import NetworkModel, Simulator


class BSPWorker:
    def __init__(self, sim: Simulator, wid: int, cost: CostModel):
        self.sim = sim
        sim.register(self)
        self.wid = wid
        self.cost = cost
        self.adj: Dict[str, List[str]] = {}

    def service_time(self, frontier: List[str]) -> float:
        t = 0.0
        for v in frontier:
            t += self.cost.prog_vertex + self.cost.bsp_update
            t += self.cost.prog_edge * len(self.adj.get(v, []))
        return t


class BSPEngine:
    #: Per-superstep engine overhead: Pregel/GraphLab-sync pays a
    #: scheduling + vertex-state-commit + barrier round per superstep
    #: (ms-scale on real clusters even for near-empty supersteps; see
    #: Pregel [SIGMOD'10] / GraphLab [OSDI'12] evaluations).
    ENGINE_STEP = 1.0e-3

    def __init__(self, n_workers: int = 4, cost: Optional[CostModel] = None,
                 network: Optional[NetworkModel] = None, seed: int = 0,
                 engine_step: Optional[float] = None):
        self.sim = Simulator(seed=seed, network=network or NetworkModel())
        self.sim.register(self)
        self.cost = cost or CostModel()
        self.engine_step = (engine_step if engine_step is not None
                            else self.ENGINE_STEP)
        self.workers = [BSPWorker(self.sim, w, self.cost)
                        for w in range(n_workers)]
        self.n_workers = n_workers

    def place(self, vid: str) -> int:
        return hash(vid) % self.n_workers

    def load_graph(self, edges: List[Tuple[str, str]]) -> None:
        for s, d in edges:
            self.workers[self.place(s)].adj.setdefault(s, []).append(d)
            self.workers[self.place(d)].adj.setdefault(d, [])

    # ---- synchronous engine ---------------------------------------------
    def bfs_sync(self, source: str, target: Optional[str],
                 callback: Callable) -> None:
        t0 = self.sim.now
        visited: Set[str] = set()
        state = {"frontier": {source}, "levels": 0}

        def superstep() -> None:
            frontier = state["frontier"]
            if not frontier or (target is not None and target in visited):
                callback({"reached": target in visited if target else True,
                          "visited": len(visited),
                          "levels": state["levels"],
                          "latency": self.sim.now - t0})
                return
            # scatter frontier to owners
            by_worker: Dict[int, List[str]] = {}
            for v in frontier:
                by_worker.setdefault(self.place(v), []).append(v)
            nxt: Set[str] = set()
            done = {"n": len(by_worker)}
            worker_finish = []

            def worker_done(new_frontier: List[str]) -> None:
                nxt.update(new_frontier)
                done["n"] -= 1
                if done["n"] == 0:
                    # barrier: master RTT + per-superstep engine overhead
                    self.sim.counters.barriers += 1
                    barrier = (2 * self.sim.network.base_latency
                               + self.engine_step)
                    visited.update(frontier)
                    state["frontier"] = {v for v in nxt if v not in visited
                                         and v not in frontier}
                    state["levels"] += 1
                    self.sim.schedule(barrier, superstep)

            for wid, vs in by_worker.items():
                worker = self.workers[wid]
                def _run(worker=worker, vs=vs):
                    st = worker.service_time(vs)
                    out: List[str] = []
                    for v in vs:
                        out.extend(worker.adj.get(v, []))
                    self.sim.schedule(
                        st, lambda out=out: self.sim.send(
                            worker, self, lambda: worker_done(out),
                            nbytes=64 + 16 * len(out)))
                self.sim.send(self, worker, _run, nbytes=64 + 16 * len(vs))

        superstep()

    # ---- asynchronous engine (neighbour locking) ---------------------------
    def bfs_async(self, source: str, target: Optional[str],
                  callback: Callable) -> None:
        t0 = self.sim.now
        visited: Set[str] = set()
        outstanding = {"n": 0}
        finished = {"done": False}

        def finish() -> None:
            if finished["done"]:
                return
            finished["done"] = True
            callback({"reached": target in visited if target else True,
                      "visited": len(visited),
                      "latency": self.sim.now - t0})

        def activate(v: str) -> None:
            if v in visited or finished["done"]:
                maybe_done()
                return
            visited.add(v)
            wid = self.place(v)
            worker = self.workers[wid]
            nbrs = worker.adj.get(v, [])
            # neighbour locking: one lock RPC per remotely-owned neighbour
            remote = [u for u in nbrs if self.place(u) != wid]
            lock_cost = (self.cost.lock_op * len(nbrs)
                         + 2 * self.sim.network.base_latency
                         * min(len(remote), self.n_workers - 1))
            self.sim.counters.lock_waits += len(remote)
            st = (self.cost.prog_vertex + self.cost.bsp_update
                  + self.cost.prog_edge * len(nbrs) + lock_cost)

            def done() -> None:
                if target is not None and v == target:
                    finish()
                for u in nbrs:
                    if u not in visited:
                        outstanding["n"] += 1
                        self.sim.send(worker, self,
                                      lambda u=u: activate(u), nbytes=64)
                maybe_done()

            self.sim.schedule(st, done)

        def maybe_done() -> None:
            outstanding["n"] -= 1
            if outstanding["n"] <= 0:
                finish()

        outstanding["n"] = 1
        self.sim.send(self, self.workers[self.place(source)],
                      lambda: activate(source), nbytes=64)


class _ColWorker:
    """Endpoint actor for :class:`ColumnarBSPEngine` messages.

    Holds this worker's edge partition as a CSR-ish pair of int arrays
    (``srcs`` sorted ascending, ``dsts`` aligned) instead of the
    interpreted engine's dict-of-lists adjacency.
    """

    def __init__(self, sim: Simulator, wid: int):
        self.sim = sim
        sim.register(self)
        self.wid = wid
        self.srcs = np.zeros(0, dtype=np.int64)
        self.dsts = np.zeros(0, dtype=np.int64)


class ColumnarBSPEngine:
    """Vectorized BSP baseline over columnar edge slices.

    Same simulator, network model, barrier/lock *coordination* charges and
    result contract as :class:`BSPEngine`, but the per-superstep frontier
    expansion is one vectorized ragged gather over the worker's sorted
    edge columns instead of a Python loop over an adjacency dict.  Compute
    is charged at columnar rates (``prog_plan_row`` per scanned row plus
    one ``bsp_update`` per SIMD group of frontier vertices), so what is
    left in the simulated latency is exactly the coordination the paper's
    Fig. 11 argues about: barriers (sync) and neighbourhood locks (async)
    — not interpreter overhead.

    * ``bfs_sync`` mirrors ``BSPEngine.bfs_sync`` superstep-for-superstep:
      termination check at superstep start, one batch per participating
      worker per superstep, identical barrier charge
      (``2*base_latency + engine_step``) and ``counters.barriers``.
    * ``bfs_async`` mirrors the interpreted activation structure and
      charges the *identical* neighbourhood-lock cost
      (``lock_op*|nbrs| + 2*base_latency*min(|remote|, W-1)`` and
      ``counters.lock_waits``); only the per-vertex compute term uses the
      columnar rates.

    Results (``reached`` / ``visited`` / ``levels``) are identical to the
    interpreted engine on the same graph; ``tests``/``benchmarks`` assert
    this at equal inputs.
    """

    ENGINE_STEP = BSPEngine.ENGINE_STEP
    #: vertices whose vertex-program state commit is amortized into one
    #: columnar update (a 32-lane batch of int32 BFS levels)
    SIMD = 32

    def __init__(self, n_workers: int = 4, cost: Optional[CostModel] = None,
                 network: Optional[NetworkModel] = None, seed: int = 0,
                 engine_step: Optional[float] = None):
        self.sim = Simulator(seed=seed, network=network or NetworkModel())
        self.sim.register(self)
        self.cost = cost or CostModel()
        self.engine_step = (engine_step if engine_step is not None
                            else self.ENGINE_STEP)
        self.workers = [_ColWorker(self.sim, w) for w in range(n_workers)]
        self.n_workers = n_workers
        self._ids: Dict[str, int] = {}
        self._owner = np.zeros(0, dtype=np.int32)

    # placement must match BSPEngine so both baselines simulate the same
    # partitioning (and the same remote-neighbour lock traffic)
    def place(self, vid: str) -> int:
        return hash(vid) % self.n_workers

    def _intern(self, vid: str) -> int:
        i = self._ids.get(vid)
        if i is None:
            i = len(self._ids)
            self._ids[vid] = i
        return i

    def load_graph(self, edges: List[Tuple[str, str]]) -> None:
        src = np.fromiter((self._intern(s) for s, _ in edges),
                          dtype=np.int64, count=len(edges))
        dst = np.fromiter((self._intern(d) for _, d in edges),
                          dtype=np.int64, count=len(edges))
        owner = np.empty(len(self._ids), dtype=np.int32)
        for vid, i in self._ids.items():
            owner[i] = self.place(vid)
        self._owner = owner
        wsrc = owner[src] if len(edges) else np.zeros(0, dtype=np.int32)
        for w, worker in enumerate(self.workers):
            m = wsrc == w
            s, d = src[m], dst[m]
            order = np.argsort(s, kind="stable")
            worker.srcs = s[order]
            worker.dsts = d[order]

    @staticmethod
    def _expand(worker: "_ColWorker", vs: np.ndarray) -> np.ndarray:
        """Ragged gather: all out-neighbours of ``vs`` in one shot."""
        lo = np.searchsorted(worker.srcs, vs, side="left")
        hi = np.searchsorted(worker.srcs, vs, side="right")
        counts = hi - lo
        total = int(counts.sum())
        if total == 0:
            return np.zeros(0, dtype=np.int64)
        starts = np.repeat(lo, counts)
        offs = np.arange(total) - np.repeat(np.cumsum(counts) - counts,
                                            counts)
        return worker.dsts[starts + offs]

    def _service(self, n_vertices: int, n_out: int) -> float:
        return (self.cost.prog_plan_row * (n_vertices + n_out)
                + self.cost.bsp_update * -(-n_vertices // self.SIMD))

    # ---- synchronous engine ---------------------------------------------
    def bfs_sync(self, source: str, target: Optional[str],
                 callback: Callable) -> None:
        t0 = self.sim.now
        visited = np.zeros(len(self._ids), dtype=bool)
        sid = self._ids.get(source)
        tid = self._ids.get(target) if target is not None else None
        state = {
            "frontier": (np.array([sid], dtype=np.int64) if sid is not None
                         else np.zeros(0, dtype=np.int64)),
            "levels": 0,
        }

        def superstep() -> None:
            frontier = state["frontier"]
            if frontier.size == 0 or (tid is not None and visited[tid]):
                reached = (bool(visited[tid]) if tid is not None
                           else target is None)
                callback({"reached": reached,
                          "visited": int(visited.sum()),
                          "levels": state["levels"],
                          "latency": self.sim.now - t0})
                return
            owners = self._owner[frontier]
            uw = np.unique(owners)
            parts: List[np.ndarray] = []
            done = {"n": int(uw.size)}

            def worker_done(out: np.ndarray) -> None:
                parts.append(out)
                done["n"] -= 1
                if done["n"] == 0:
                    self.sim.counters.barriers += 1
                    barrier = (2 * self.sim.network.base_latency
                               + self.engine_step)
                    visited[frontier] = True
                    cand = (np.unique(np.concatenate(parts)) if parts
                            else np.zeros(0, dtype=np.int64))
                    state["frontier"] = cand[~visited[cand]]
                    state["levels"] += 1
                    self.sim.schedule(barrier, superstep)

            for w in uw.tolist():
                worker = self.workers[w]
                vs = frontier[owners == w]

                def _run(worker=worker, vs=vs):
                    out = self._expand(worker, vs)
                    st = self._service(int(vs.size), int(out.size))
                    self.sim.schedule(
                        st, lambda out=out: self.sim.send(
                            worker, self, lambda: worker_done(out),
                            nbytes=64 + 16 * int(out.size)))

                self.sim.send(self, worker, _run,
                              nbytes=64 + 16 * int(vs.size))

        superstep()

    # ---- asynchronous engine (neighbour locking) -----------------------
    def bfs_async(self, source: str, target: Optional[str],
                  callback: Callable) -> None:
        t0 = self.sim.now
        visited = np.zeros(len(self._ids), dtype=bool)
        sid = self._ids.get(source)
        tid = self._ids.get(target) if target is not None else None
        outstanding = {"n": 0}
        finished = {"done": False}

        def finish() -> None:
            if finished["done"]:
                return
            finished["done"] = True
            reached = (bool(visited[tid]) if tid is not None
                       else target is None)
            callback({"reached": reached,
                      "visited": int(visited.sum()),
                      "latency": self.sim.now - t0})

        def activate(v: int) -> None:
            if visited[v] or finished["done"]:
                maybe_done()
                return
            visited[v] = True
            w = int(self._owner[v])
            worker = self.workers[w]
            lo = int(np.searchsorted(worker.srcs, v, side="left"))
            hi = int(np.searchsorted(worker.srcs, v, side="right"))
            nbrs = worker.dsts[lo:hi]
            n_remote = int((self._owner[nbrs] != w).sum())
            lock_cost = (self.cost.lock_op * int(nbrs.size)
                         + 2 * self.sim.network.base_latency
                         * min(n_remote, self.n_workers - 1))
            self.sim.counters.lock_waits += n_remote
            st = (self.cost.prog_plan_row * (1 + int(nbrs.size))
                  + self.cost.bsp_update + lock_cost)

            def done() -> None:
                if tid is not None and v == tid:
                    finish()
                todo = nbrs[~visited[nbrs]]
                for u in todo.tolist():
                    outstanding["n"] += 1
                    self.sim.send(worker, self,
                                  lambda u=u: activate(u), nbytes=64)
                maybe_done()

            self.sim.schedule(st, done)

        def maybe_done() -> None:
            outstanding["n"] -= 1
            if outstanding["n"] <= 0:
                finish()

        outstanding["n"] = 1
        if sid is None:
            self.sim.schedule(0.0, finish)
            return
        self.sim.send(self, self.workers[int(self._owner[sid])],
                      lambda: activate(sid), nbytes=64)
