"""Shared driver machinery of the port's database examples and benchmark
drivers: graph loading, a closed-loop client driver, latency stats, and
the blockchain ingest of the block-query benchmark.  All latencies are
*simulated* seconds (deterministic).

These are the port's copies of ``benchmarks/common.py``'s
``load_weaver_graph``, ``stats`` and ``ClosedLoopDriver`` and of
``benchmarks/block_query.py``'s ``build_chain_in_weaver``.
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


def device_args(description: str, argv=None) -> argparse.Namespace:
    """An example's command line: ``--device`` (the card by default;
    without one that raises, naming ``--device cpu``)."""
    from repro_torch.core.analytics import check_device
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda",
                    help="where the store's stamp compares run: cuda (the "
                         "default) or cpu")
    args = ap.parse_args(argv)
    try:
        check_device(args.device)
    except RuntimeError:
        raise RuntimeError(f"--device {args.device} needs a CUDA device and "
                           f"none is available; pass --device cpu") from None
    return args


def load_weaver_graph(w, edges: List[Tuple[str, str]],
                      chunk: int = 128) -> List[str]:
    """Create every endpoint of ``edges`` (sorted), then the edges, in
    transactions of ``chunk`` ops; returns the sorted vertex ids."""
    vertices = sorted({v for e in edges for v in e})
    for i in range(0, len(vertices), chunk):
        tx = w.begin_tx()
        for v in vertices[i:i + chunk]:
            tx.create_vertex(v)
        r = w.run_tx(tx)
        if not r.ok:
            raise RuntimeError(f"loading vertices failed: {r.error}")
    for i in range(0, len(edges), chunk):
        tx = w.begin_tx()
        for s, d in edges[i:i + chunk]:
            tx.create_edge(s, d)
        r = w.run_tx(tx)
        if not r.ok:
            raise RuntimeError(f"loading edges failed: {r.error}")
    return vertices


def stats(latencies: List[float]) -> Dict[str, float]:
    if not latencies:
        return {"n": 0}
    a = np.asarray(latencies)
    return {
        "n": int(a.size),
        "mean_ms": float(a.mean() * 1e3),
        "p50_ms": float(np.percentile(a, 50) * 1e3),
        "p90_ms": float(np.percentile(a, 90) * 1e3),
        "p99_ms": float(np.percentile(a, 99) * 1e3),
        "max_ms": float(a.max() * 1e3),
    }


class ClosedLoopDriver:
    """N concurrent clients; each issues the next request on completion.

    ``issue(client_id, req_index, on_done)`` must submit one request and
    arrange for ``on_done(latency)`` to fire at completion.
    """

    def __init__(self, sim, n_clients: int, n_requests: int,
                 issue: Callable[[int, int, Callable], None]):
        self.sim = sim
        self.n_clients = n_clients
        self.n_requests = n_requests
        self.issue = issue
        self.completed = 0
        self.issued = 0
        self.latencies: List[float] = []
        self.t_start: Optional[float] = None
        self.t_end: Optional[float] = None

    def run(self, timeout: float = 300.0) -> Dict:
        self.t_start = self.sim.now

        def next_req(cid: int) -> None:
            if self.issued >= self.n_requests:
                return
            idx = self.issued
            self.issued += 1

            def done(latency: float) -> None:
                self.completed += 1
                self.latencies.append(latency)
                if self.completed >= self.n_requests:
                    self.t_end = self.sim.now
                    return
                next_req(cid)

            self.issue(cid, idx, done)

        for c in range(self.n_clients):
            next_req(c)
        deadline = self.sim.now + timeout
        while (self.completed < self.n_requests and self.sim.pending()
               and self.sim.now < deadline):
            self.sim.run(until=min(deadline, self.sim.now + 50e-3))
        if self.t_end is None:
            self.t_end = self.sim.now
        dt = max(self.t_end - self.t_start, 1e-9)
        return {
            "completed": self.completed,
            "duration_s": dt,
            "throughput_per_s": self.completed / dt,
            **stats(self.latencies),
        }


def build_chain_in_weaver(w, chain: List[dict]) -> None:
    """Ingest ``synth.blockchain`` blocks: one transaction per block (the
    block, its transactions and their values), then one for the output
    addresses, as a real ingest does."""
    for block in chain:
        tx = w.begin_tx()
        tx.create_vertex(block["id"])
        for t in block["txs"]:
            tx.create_vertex(t["id"])
            e = tx.create_edge(block["id"], t["id"])
            tx.set_edge_prop(e, "type", "contains")
            tx.set_vertex_prop(t["id"], "value", t["value"])
        r = w.run_tx(tx)
        if not r.ok:
            raise RuntimeError(f"ingesting {block['id']} failed: {r.error}")
        tx2 = w.begin_tx()
        staged = set()
        for t in block["txs"]:
            for a in t["outputs"]:
                if a not in staged and w.read_vertex(a) is None:
                    tx2.create_vertex(a)
                    staged.add(a)
                tx2.create_edge(t["id"], a)
        r2 = w.run_tx(tx2)
        if not r2.ok:
            raise RuntimeError(f"ingesting {block['id']}'s outputs failed: "
                               f"{r2.error}")
