"""The yardstick on the CPU: the plain references against hand-worked
answers and networkx, the generators' counts and determinism, the write
window, the root rule and the byte and round counts."""

import networkx as nx
import numpy as np
import pytest
import torch

from pathlib import Path

from weaverbench import graphs, harness, work
from weaverbench.reference import bfs as ref_bfs
from weaverbench.reference import pagerank as ref_pagerank

INF = ref_bfs.UNREACHED

# 0 -> 1 -> 2, 0 -> 2, 3 -> 0; 3 is reached from no one
SRC = torch.tensor([0, 1, 0, 3], dtype=torch.int32)
DST = torch.tensor([1, 2, 2, 0], dtype=torch.int32)


REPO = Path(__file__).resolve().parent.parent
NAMES = ["urand", "g500"]


def tiny(name):
    return {"urand": {"name": "tiny_urand", "generator": "urand",
                      "scale": 10, "edge_factor": 16, "graph_seed": 1},
            "g500": {"name": "tiny_g500", "generator": "kronecker",
                     "scale": 10, "edge_factor": 16, "a": 0.57, "b": 0.19,
                     "c": 0.19, "graph_seed": 2}}[name]


def build(cfg, seed):
    return harness.load(REPO, "generators", cfg["generator"]).build(
        cfg, seed, "cpu")


def bfs_query(traffic, live, seed):
    return harness.load(REPO, "kinds", "bfs").Query(traffic, live, seed)


def test_bfs_reference_hand_worked():
    lv = ref_bfs.levels(SRC, DST, 4, 0).tolist()
    assert lv == [0, 1, 1, INF]
    assert ref_bfs.levels(SRC, DST, 4, 3).tolist() == [1, 2, 2, 0]
    assert ref_bfs.levels(SRC, DST, 4, 2).tolist() == [INF, INF, 0, INF]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bfs_reference_matches_networkx(seed):
    rng = np.random.default_rng(seed)
    n, m = 300, 700
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    g = nx.MultiDiGraph()
    g.add_nodes_from(range(n))
    g.add_edges_from(zip(src.tolist(), dst.tolist()))
    for root in (0, 17, 299):
        want = nx.single_source_shortest_path_length(g, root)
        got = ref_bfs.levels(torch.from_numpy(src).int(),
                             torch.from_numpy(dst).int(), n, root).tolist()
        assert got == [want.get(v, INF) for v in range(n)]


def test_pagerank_reference_hand_worked():
    # out-degrees 2, 1, 0 (clamped to 1), 1; one round from 1/4
    pr = ref_pagerank.ranks(SRC, DST, 4, 1, 0.85).tolist()
    base = 0.15 / 4
    want = [base + 0.85 * 0.25,                      # from 3
            base + 0.85 * 0.125,                     # from 0 (half)
            base + 0.85 * (0.125 + 0.25),            # from 0 and 1
            base]
    assert pr == pytest.approx(want, rel=1e-12)


def test_pagerank_reference_matches_networkx():
    rng = np.random.default_rng(4)
    n = 200
    g = nx.DiGraph()
    for v in range(n):               # no dangling vertex, no parallel edge
        for u in rng.choice(n, size=3, replace=False):
            if u != v:
                g.add_edge(v, int(u))
    src, dst = (torch.tensor(x, dtype=torch.int32) for x in zip(*g.edges))
    got = ref_pagerank.ranks(src, dst, n, 300, 0.85).numpy()
    want = nx.pagerank(g, alpha=0.85, tol=1e-14, max_iter=2000)
    np.testing.assert_allclose(got, [want[v] for v in range(n)], rtol=1e-9)


def test_pagerank_control_is_bfloat16():
    pr = ref_pagerank.ranks(SRC, DST, 4, 3, 0.85, torch.bfloat16)
    assert pr.dtype == torch.bfloat16


@pytest.mark.parametrize("name", NAMES)
def test_generator_counts_and_order(name):
    cfg = tiny(name)
    g = build(cfg, 2**40 + 3)
    n = 2 ** cfg["scale"]
    m = 2 * cfg["edge_factor"] * n
    assert g.n == n and g.src.numel() == m == g.dst.numel()
    assert g.src.dtype == g.dst.dtype == torch.int32
    assert not bool((g.src == g.dst).any())
    assert int(g.src.min()) >= 0 and int(g.src.max()) < n
    key = g.dst.long() * n + g.src.long()
    assert bool((key[1:] >= key[:-1]).all())       # CSC: (dst, src)
    fwd = torch.sort(g.src.long() * n + g.dst.long()).values
    assert torch.equal(fwd, key)                    # both directions held
    s = torch.arange(m)
    assert torch.equal(g.twin[g.twin.long()].long(), s)
    assert torch.equal(g.src[g.twin.long()], g.dst)
    assert torch.equal(g.dst[g.twin.long()], g.src)


@pytest.mark.parametrize("name", NAMES)
def test_generator_determinism_by_seed(name):
    a = build(tiny(name), 7)
    b = build(tiny(name), 7)
    c = build(tiny(name), 8)
    assert torch.equal(a.src, b.src) and torch.equal(a.dst, b.dst)
    assert not torch.equal(a.src, c.src)
    # another seed holds the same graph under other ids, each id keeping
    # its in-degree: the same CSC segments, other sources in them
    assert a.self_loops_redrawn == c.self_loops_redrawn
    assert torch.equal(a.dst, c.dst)
    assert torch.equal(torch.bincount(a.src, minlength=a.n).sort().values,
                       torch.bincount(c.src, minlength=c.n).sort().values)
    other = build(dict(tiny(name), graph_seed=99), 7)
    assert not torch.equal(torch.bincount(a.dst, minlength=a.n).sort().values,
                           torch.bincount(other.dst,
                                          minlength=a.n).sort().values)


def test_sub_seed_takes_any_whole_number():
    seeds = {graphs.sub_seed(s, "write", 3) for s in
             (0, 1, 2**31 + 5, 2**33, 10**20, -1)}
    assert len(seeds) == 6 and all(0 <= s < 2**63 for s in seeds)


@pytest.mark.parametrize("name", NAMES)
def test_write_window(name):
    g = build(tiny(name), 11)
    live = graphs.LiveGraph(g, 0.01)
    assert live.count == 4 * round(g.src.numel() * 0.01 / 4)
    dst0, src0 = live.dst.clone(), live.src.clone()
    deg0 = torch.bincount(live.src, minlength=live.n)
    copy = live.clone()
    slot = torch.arange(live.src.numel())
    for k in range(5):
        before = live.src.clone()
        live.write_window(k)
        slots, old = live.last
        assert slots.numel() == live.count
        assert torch.equal(old, before[slots])
        assert torch.equal(live.stale_src(), before)
        changed = int((live.src != before).sum())
        assert live.count // 2 < changed <= live.count
        assert not bool((live.src == live.dst).any())
        # still undirected, each slot's twin its reverse, degrees kept
        tw = live.twin.long()
        assert torch.equal(tw[tw], slot)
        assert torch.equal(live.src[tw], live.dst)
        assert torch.equal(live.dst[tw], live.src)
        assert torch.equal(torch.bincount(live.src, minlength=live.n), deg0)
        assert torch.equal(live.outdeg, deg0.int())
    assert torch.equal(live.dst, dst0)              # destination-major holds
    for k in range(5):
        copy.write_window(k)
    assert torch.equal(copy.src, live.src)          # the replay is exact
    assert torch.equal(copy.twin, live.twin)
    assert not torch.equal(src0, live.src)


def test_edge_swap_hand_worked():
    # the 4-cycle 0 - 1 - 2 - 3 - 0 held both ways; one swap of the
    # picked pair {a, b}, {c, d} gives {a, d}, {c, b}
    s = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    d = torch.tensor([1, 2, 3, 0], dtype=torch.int32)
    g = graphs.undirected(4, s, d, 1, 1, 0)
    live = graphs.LiveGraph(g, 0.5)                 # one pair a window
    assert live.picks == 2
    edges = lambda: sorted({tuple(sorted(e)) for e in
                            zip(live.src.tolist(), live.dst.tolist())})
    before = edges()
    src0 = live.src.clone()
    live.write_window(0)
    slots, old = live.last
    p1, _, p2, _ = slots.tolist()
    a, c = int(old[0]), int(old[2])
    b, dd = int(live.dst[p1]), int(live.dst[p2])
    assert not torch.equal(live.src, src0)    # graph seed 1: window 0 swaps
    assert (int(live.src[p1]), int(live.src[p2])) == (c, a)
    gone = {tuple(sorted(e)) for e in [(a, b), (c, dd)]}
    made = {tuple(sorted(e)) for e in [(a, dd), (c, b)]}
    assert set(edges()) == (set(before) - gone) | made
    live.write_window(1)                      # one left alone: no change
    assert torch.equal(live.src, live.stale_src())
    assert sorted(torch.bincount(live.src, minlength=4).tolist()) == [2] * 4


def _by_rank(live):
    """The snapshot's edges as sorted (src, dst) keys over ranks."""
    rank = torch.empty_like(live.perm)
    rank[live.perm] = torch.arange(live.n)
    return torch.sort(rank[live.src.long()] * live.n
                      + rank[live.dst.long()]).values


@pytest.mark.parametrize("name", NAMES)
def test_every_seed_holds_the_same_snapshots_under_its_own_ids(name):
    a = graphs.LiveGraph(build(tiny(name), 3), 0.001)
    b = graphs.LiveGraph(build(tiny(name), 2**35 + 9), 0.001)
    assert not torch.equal(a.src, b.src)
    for k in range(4):
        assert torch.equal(_by_rank(a), _by_rank(b))
        a.write_window(k)
        b.write_window(k)
    assert torch.equal(_by_rank(a), _by_rank(b))


@pytest.mark.parametrize("name", NAMES)
def test_root_rule(name):
    g = build(tiny(name), 5)
    live = graphs.LiveGraph(g, 0.001)
    traffic = {"root_min_out_degree": 1, "roots": 64}
    q = bfs_query(traffic, live, 5)
    deg = torch.bincount(g.src, minlength=g.n)
    assert len(set(q.pool.tolist())) == 64
    assert all(int(deg[r]) >= 1 for r in q.pool)
    roots = [q.args(k) for k in range(200)]
    assert roots == [q.args(k) for k in range(200)]  # drawn from the seed
    for c in range(3):                               # each pass: the pool
        assert sorted(roots[64 * c: 64 * (c + 1)]) == sorted(q.pool)
    assert roots[:64] != roots[64:128]               # in another order
    # another seed: the same roots under its own ids, in another order
    g2 = build(tiny(name), 6)
    q2 = bfs_query(traffic, graphs.LiveGraph(g2, 0.001), 6)
    rank = lambda perm, ids: sorted(
        int((perm == i).nonzero()) for i in ids)
    assert rank(g.perm, q.pool) == rank(g2.perm, q2.pool)


def test_byte_and_round_counts_hand_counted():
    # SRC/DST: 4 vertices, 4 edges; BFS from 0 reaches 0, 1, 2
    lv = ref_bfs.levels(SRC, DST, 4, 0)
    outdeg = torch.bincount(SRC, minlength=4)
    assert work.bfs_rounds(int(lv[lv != INF].max())) == 2
    assert int(work.bfs_traversed_edges(lv, outdeg, True)) == 3  # 01 02 12
    assert int(work.bfs_traversed_edges(ref_bfs.levels(SRC, DST, 4, 3),
                                        outdeg, True)) == 4
    # the path 0 - 1 - 2 and the edge 3 - 4, held both ways: a BFS from 0
    # traverses the two edges of its component, each once
    s = torch.tensor([0, 1, 1, 2, 3, 4], dtype=torch.int32)
    d = torch.tensor([1, 0, 2, 1, 4, 3], dtype=torch.int32)
    deg = torch.bincount(s, minlength=5)
    lv = ref_bfs.levels(s, d, 5, 0)
    assert int(work.bfs_traversed_edges(lv, deg, False)) == 2
    assert int(work.bfs_traversed_edges(ref_bfs.levels(s, d, 5, 3), deg,
                                        False)) == 1
    assert work.pagerank_rounds(20) == 21
    # 20 rounds x 4 edges x 4 B of source index, then 4 ranks x 4 B
    assert work.pagerank_least_bytes(4, 4, 20) == 20 * 16 + 16
