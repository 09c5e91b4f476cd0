"""The port's snapshot traversals (``repro_torch.core.analytics``) against
the reference's jitted JAX functions on the same arrays: BFS levels,
reachability, connected components and sssp exactly, pagerank to rtol
1e-5, and the padded-table clustering coefficient exactly.  Covers empty
segments (isolated vertices), unreachable vertices, ``max_iters`` caps,
the ``_ga`` variants over ``snapshot_arrays`` of a port Weaver, and
``sssp_weighted``'s early stop."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import analytics as A
from repro_torch.core import Weaver, WeaverConfig
from repro_torch.core import analytics as P

PR_RTOL = 1e-5


def random_graph(seed: int, n: int, m: int, isolated: int = 0):
    """``m`` random edges over the first ``n - isolated`` vertices (the
    rest have no edge: empty segments)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n - isolated, m).astype(np.int32)
    dst = rng.integers(0, n - isolated, m).astype(np.int32)
    return src, dst


GRAPHS = [  # (seed, n, m, isolated)
    (0, 30, 60, 0), (1, 200, 450, 20), (2, 50, 20, 5), (3, 7, 0, 0),
    (4, 64, 400, 0), (5, 40, 39, 1),
]


def both(src, dst):
    return (jnp.asarray(src), jnp.asarray(dst),
            torch.from_numpy(src), torch.from_numpy(dst))


@pytest.mark.parametrize("max_iters", [None, 1, 2])
@pytest.mark.parametrize("graph", GRAPHS)
def test_bfs_levels_matches_reference(graph, max_iters):
    seed, n, m, iso = graph
    src, dst = random_graph(seed, n, m, iso)
    js, jd, ts, td = both(src, dst)
    sources = [0, n // 3]
    want = np.asarray(A.bfs_levels(js, jd, n, jnp.asarray(sources),
                                   max_iters))
    got = P.bfs_levels(ts, td, n, torch.tensor(sources), max_iters)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if iso:
        assert (got.numpy()[n - iso:] == P.INF).all()   # never overflows


def test_bfs_line_graph_and_sorted_hint():
    src = np.array([0, 1, 2], np.int32)
    dst = np.array([1, 2, 3], np.int32)
    for hint in (False, True):
        got = P.bfs_levels(torch.from_numpy(src), torch.from_numpy(dst), 4,
                           [0], dst_sorted=hint)
        assert got.tolist() == [0, 1, 2, 3]
    got = P.bfs_levels(src, dst, 5, [0], max_iters=2)   # numpy in, CPU out
    assert got.tolist() == [0, 1, 2, int(P.INF), int(P.INF)]


@pytest.mark.parametrize("graph", GRAPHS)
def test_reachable_matches_reference(graph):
    seed, n, m, iso = graph
    src, dst = random_graph(seed, n, m, iso)
    ts, td = torch.from_numpy(src), torch.from_numpy(dst)
    for target in range(0, n, max(1, n // 7)):
        assert P.reachable(ts, td, n, 0, target) == A.reachable(
            src, dst, n, 0, target)


@pytest.mark.parametrize("max_iters", [64, 1, 2])
@pytest.mark.parametrize("graph", GRAPHS)
def test_connected_components_matches_reference(graph, max_iters):
    seed, n, m, iso = graph
    src, dst = random_graph(seed, n, m, iso)
    js, jd, ts, td = both(src, dst)
    want = np.asarray(A.connected_components(js, jd, n, max_iters))
    got = P.connected_components(ts, td, n, max_iters)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_iters", [20, 1, 5])
@pytest.mark.parametrize("graph", GRAPHS)
def test_pagerank_matches_reference(graph, n_iters):
    seed, n, m, iso = graph
    src, dst = random_graph(seed, n, m, iso)
    js, jd, ts, td = both(src, dst)
    want = np.asarray(A.pagerank(js, jd, n, n_iters))
    got = P.pagerank(ts, td, n, n_iters)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=PR_RTOL, atol=0)


@pytest.mark.parametrize("graph", GRAPHS)
def test_sssp_weighted_matches_reference(graph):
    seed, n, m, iso = graph
    src, dst = random_graph(seed, n, m, iso)
    w = np.random.default_rng(seed + 100).integers(1, 10, m).astype(
        np.float32)
    js, jd, ts, td = both(src, dst)
    want = np.asarray(A.sssp_weighted(js, jd, jnp.asarray(w), n,
                                      jnp.asarray([0])))
    got = P.sssp_weighted(ts, td, torch.from_numpy(w), n, [0])
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    if iso:
        assert (got.numpy()[n - iso:] == np.float32(3.4e38)).all()


def test_sssp_weighted_stops_early_with_the_reference_result(monkeypatch):
    """A star of 400 vertices settles in one round: the port stops after
    the round that changes nothing (2 rounds of 399), and returns the
    array the reference's 399 rounds give."""
    n = 400
    src = np.zeros(n - 1, np.int32)
    dst = np.arange(1, n, dtype=np.int32)
    w = np.arange(1, n, dtype=np.float32) % 9 + 1
    want = np.asarray(A.sssp_weighted(jnp.asarray(src), jnp.asarray(dst),
                                      jnp.asarray(w), n, jnp.asarray([0])))
    rounds = []
    reduce_ = P._segment_reduce
    monkeypatch.setattr(P, "_segment_reduce",
                        lambda *a: rounds.append(1) or reduce_(*a))
    got = P.sssp_weighted(torch.from_numpy(src), torch.from_numpy(dst),
                          torch.from_numpy(w), n, [0])
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(rounds) == 2


@pytest.mark.parametrize("graph, max_deg", [
    (GRAPHS[0], 3), (GRAPHS[1], 8), (GRAPHS[1], 64), (GRAPHS[2], 1),
    (GRAPHS[3], 8), (GRAPHS[4], 3), (GRAPHS[4], 64), (GRAPHS[5], 8)])
def test_clustering_coefficients_padded_matches_reference(graph, max_deg):
    seed, n, m, iso = graph
    src, dst = random_graph(seed, n, m, iso)
    src[::7] = dst[::7]                       # self-loops are skipped
    want = np.asarray(A.clustering_coefficients_jax(src, dst, n, max_deg))
    got = P.clustering_coefficients_padded(torch.from_numpy(src),
                                           torch.from_numpy(dst), n, max_deg)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_clustering_chunks_do_not_change_the_result(monkeypatch):
    src, dst = random_graph(9, 120, 900)
    want = np.asarray(A.clustering_coefficients_jax(src, dst, 120, 16))
    monkeypatch.setattr(P, "_CC_CHUNK_ELEMS", 16 * 16 * 7)   # 7 per chunk
    got = P.clustering_coefficients_padded(src, dst, 120, 16)
    np.testing.assert_array_equal(got.numpy(), want)


def port_snapshot(seed: int):
    """A port Weaver on the CPU with a seeded graph and some deletes."""
    rng = np.random.default_rng(seed)
    w = Weaver(WeaverConfig(n_gatekeepers=2, n_shards=3, seed=seed,
                            device="cpu"))
    tx = w.begin_tx()
    for i in range(60):
        tx.create_vertex(f"v{i}")
    handles = [tx.create_edge(f"v{a}", f"v{b}")
               for a, b in rng.integers(0, 50, (150, 2)).tolist()]
    assert w.run_tx(tx).ok
    tx = w.begin_tx()
    for h in handles[::5]:
        tx.delete_edge(h)
    assert w.run_tx(tx).ok
    _, stamp, _ = w.run_program("count_edges", [("v0", None)])
    return P.snapshot_arrays(w, stamp)


@pytest.mark.parametrize("seed", [0, 1])
def test_ga_variants_on_a_port_snapshot_match_reference(seed):
    ga = port_snapshot(seed)
    src = [ga.index["v0"], ga.index["v7"]]
    np.testing.assert_array_equal(
        P.bfs_levels_ga(ga, src, device="cpu").numpy(),
        np.asarray(A.bfs_levels_ga(ga, src)))
    np.testing.assert_array_equal(
        P.bfs_levels_ga(ga, src, max_iters=1, device="cpu").numpy(),
        np.asarray(A.bfs_levels_ga(ga, src, max_iters=1)))
    np.testing.assert_array_equal(
        P.connected_components_ga(ga, device="cpu").numpy(),
        np.asarray(A.connected_components_ga(ga)))
    np.testing.assert_allclose(P.pagerank_ga(ga, device="cpu").numpy(),
                               np.asarray(A.pagerank_ga(ga)), rtol=PR_RTOL,
                               atol=0)


def test_ga_variants_need_a_card_for_cuda():
    ga = port_snapshot(0)
    if torch.cuda.is_available():
        pytest.skip("this process has a CUDA device")
    for fn in (lambda: P.bfs_levels_ga(ga, [0]),
               lambda: P.connected_components_ga(ga),
               lambda: P.pagerank_ga(ga)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            fn()
