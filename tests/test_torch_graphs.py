"""The port's numpy graph utilities and neighbour sampler
(``repro_torch.data.graphs`` / ``sampler``) give arrays bit-identical to
the reference's from the same seeds."""

import numpy as np
import pytest

from repro.data import graphs as ref_g
from repro.data import sampler as ref_s
from repro_torch.data import graphs as g
from repro_torch.data import sampler as s


def same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("power_law", [False, True])
def test_random_graph_csr_and_dst_sort(power_law):
    src, dst = g.random_graph(np.random.default_rng(3), 50, 400, power_law)
    rs, rd = ref_g.random_graph(np.random.default_rng(3), 50, 400,
                                power_law)
    same(src, rs)
    same(dst, rd)
    c, rc = g.build_csr(src, dst, 50), ref_g.build_csr(rs, rd, 50)
    same(c.indptr, rc.indptr)
    same(c.indices, rc.indices)
    assert c.n_edges == rc.n_edges and c.degree(7) == rc.degree(7)
    same(c.neighbors(7), rc.neighbors(7))
    for a, b in zip(g.sort_edges_by_dst(src, dst),
                    ref_g.sort_edges_by_dst(rs, rd)):
        same(a, b)


@pytest.mark.parametrize("with_pos", [False, True])
def test_batch_molecules(with_pos):
    a = g.batch_molecules(np.random.default_rng(1), 4, 6, 10, 5, with_pos)
    b = ref_g.batch_molecules(np.random.default_rng(1), 4, 6, 10, 5,
                              with_pos)
    assert a.keys() == b.keys()
    for k in a:
        same(a[k], b[k])


@pytest.mark.parametrize("cap", [None, 2])
def test_triplets_and_padding(cap):
    src, dst = g.random_graph(np.random.default_rng(2), 12, 40)
    ti, to = g.build_triplets(src, dst, max_per_edge=cap)
    rti, rto = ref_g.build_triplets(src, dst, max_per_edge=cap)
    same(ti, rti)
    same(to, rto)
    for target in (5, ti.size + 7):
        for a, b in zip(g.pad_triplets(ti, to, target, 39),
                        ref_g.pad_triplets(rti, rto, target, 39)):
            same(a, b)


@pytest.mark.parametrize("pad", [False, True])
def test_neighbor_sampler(pad):
    src, dst = g.random_graph(np.random.default_rng(4), 200, 2000)
    graph = g.build_csr(src, dst, 200)
    fan = [5, 3]
    seeds = np.arange(0, 40, 4)
    pad_to = s.NeighborSampler.max_sizes(len(seeds), fan) if pad else None
    assert pad_to == (ref_s.NeighborSampler.max_sizes(len(seeds), fan)
                      if pad else None)
    a = s.NeighborSampler(graph, fan, seed=9)
    b = ref_s.NeighborSampler(ref_g.build_csr(src, dst, 200), fan, seed=9)
    for _ in range(2):                       # the rng advances alike
        x, y = a.sample(seeds, pad_to), b.sample(seeds, pad_to)
        for f in ("node_ids", "edge_src", "edge_dst", "seeds"):
            same(getattr(x, f), getattr(y, f))
        assert (x.n_real_nodes, x.n_real_edges) == (y.n_real_nodes,
                                                    y.n_real_edges)


def test_chip_smoke_power_law_edges_equal_random_graph():
    """random_graph(power_law=True) with chip_smoke's device-side search
    (torch.searchsorted) gives the reference's edges and leaves the rng
    where the reference leaves it."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    a, b = np.random.default_rng(8), np.random.default_rng(8)
    src, dst = g.random_graph(a, 5000, 20000, power_law=True,
                              search=chip_smoke.device_search("cpu"))
    want_src, want_dst = ref_g.random_graph(b, 5000, 20000, power_law=True)
    same(src.numpy(), want_src)
    same(dst.numpy(), want_dst)
    assert a.random() == b.random()
