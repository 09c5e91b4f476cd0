"""The paper's baselines in the port (``core.bsp``: GraphLab-style sync
and async BFS, interpreted and columnar; ``core.twopl``: the Titan-style
2PL store) against the reference's on the same graph and seed: the same
answers, the same simulated latencies, the same ``sim.now`` and the same
counters.  Both packages place vertices by Python's salted ``hash``, so
each pair runs in one process."""

import dataclasses

import numpy as np
import pytest

from repro.core import bsp as ref_bsp
from repro.core import twopl as ref_twopl
from repro_torch.core import bsp as port_bsp
from repro_torch.core import twopl as port_twopl
from repro_torch.data import synth


def graph(seed: int, n_users: int = 300):
    return synth.social_graph(np.random.default_rng(seed), n_users, 5)


def run_bfs(mod, engine: str, mode: str, edges, source, target, seed):
    e = getattr(mod, engine)(n_workers=4, seed=seed)
    e.load_graph(edges)
    out = []
    getattr(e, mode)(source, target, out.append)
    e.sim.run(until=e.sim.now + 60.0)
    return out, e.sim.now, dataclasses.asdict(e.sim.counters)


@pytest.mark.parametrize("target", ["u5", None, "nowhere"])
@pytest.mark.parametrize("mode", ["bfs_sync", "bfs_async"])
@pytest.mark.parametrize("engine", ["BSPEngine", "ColumnarBSPEngine"])
def test_bsp_matches_reference(engine, mode, target):
    edges = graph(1)
    want = run_bfs(ref_bsp, engine, mode, edges, "u0", target, seed=3)
    got = run_bfs(port_bsp, engine, mode, edges, "u0", target, seed=3)
    assert got == want
    assert len(got[0]) == 1 and got[0][0]["visited"] > 0


@pytest.mark.parametrize("mode", ["bfs_sync", "bfs_async"])
def test_columnar_bsp_answers_as_interpreted(mode):
    """The columnar engine's oracle is the interpreted one: same reached,
    visited and levels (latencies differ by design)."""
    edges = graph(2)
    (a,), _, _ = run_bfs(port_bsp, "BSPEngine", mode, edges, "u3", "u9", 0)
    (b,), _, _ = run_bfs(port_bsp, "ColumnarBSPEngine", mode, edges, "u3",
                         "u9", 0)
    keys = ("reached", "levels") if mode == "bfs_sync" else ("reached",)
    assert {k: a[k] for k in keys} == {k: b[k] for k in keys}


def twopl_ops(seed: int, vertices, n: int):
    """Seeded 2PL transactions: reads, property writes on hot vertices,
    edge creates and deletes, each touching 1-3 vertices."""
    rng = np.random.default_rng(seed)
    txs = []
    for i in range(n):
        ops = []
        for _ in range(int(rng.integers(1, 4))):
            v = vertices[int(rng.integers(min(len(vertices), 12)))]
            r = rng.random()
            if r < 0.5:
                ops.append({"op": "get_vertex", "vid": v})
            elif r < 0.8:
                ops.append({"op": "set_vertex_prop", "vid": v, "key": "k",
                            "value": i})
            else:
                ops.append({"op": "create_edge", "src": v, "eid": 10_000 + i,
                            "dst": vertices[int(rng.integers(len(vertices)))]})
        txs.append(ops)
    return txs


def run_twopl(mod, edges, txs, seed: int, spacing: float):
    s = mod.TwoPLStore(n_shards=4, seed=seed)
    s.load_graph(edges)
    done = []
    for i, ops in enumerate(txs):
        s.sim.schedule(i * spacing, s.submit, ops,
                       lambda r, i=i: done.append((i, r)))
    s.sim.run(until=60.0)
    return done, s.sim.now, dataclasses.asdict(s.sim.counters)


@pytest.mark.parametrize("spacing", [0.0, 2e-3])
@pytest.mark.parametrize("seed", [0, 1])
def test_twopl_matches_reference(seed, spacing):
    edges = graph(seed, 80)
    vertices = sorted({v for e in edges for v in e})
    txs = twopl_ops(seed, vertices, 60)
    want = run_twopl(ref_twopl, edges, txs, seed, spacing)
    got = run_twopl(port_twopl, edges, txs, seed, spacing)
    assert got == want
    done, _, counters = got
    assert len(done) == 60 and all(r["ok"] for _, r in done)
    assert counters["tx_committed"] == 60
    if spacing == 0.0:
        assert counters["lock_waits"] > 0
