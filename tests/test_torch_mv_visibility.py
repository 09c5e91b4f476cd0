"""Port's stamp-compare wrappers (``repro_torch.kernels.mv_visibility``)
on CPU tensors and host arrays == the reference's Pallas kernels run in
interpret mode, ``visibility_ref`` and ``writepath._np_before_pairs``,
bit for bit, and the port's ``visible_edges_at`` == the reference's.
The CUDA kernels themselves run only on the card
(``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``)."""

import os
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import repro.core as ref_core
from repro.core import analytics as ref_analytics
from repro.core import clock as ref_clock
from repro.core import writepath as ref_wp
from repro.kernels.mv_visibility import kernel as ref_kernel
from repro.kernels.mv_visibility import ops as ref_ops
import repro_torch.core as port_core
from repro_torch.core import analytics as port_analytics
from repro_torch.kernels.mv_visibility import kernel, ops, ref

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

NO_STAMP = ref_clock.NO_STAMP


def stamp_rows(rng, n, q):
    rows = rng.integers(0, 5, size=(n, q.size)).astype(np.int32)
    rows[:, 0] = q[0] + rng.integers(-1, 2, size=n)
    rows[rng.random(n) < 0.15, 1:] = q[1:]
    rows[rng.random(n) < 0.2] = NO_STAMP
    return rows


def case(n, c, seed):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 5, size=c).astype(np.int32)
    q[0] = 1
    qs = np.repeat(q[None], n, axis=0)
    qs[rng.random(n) < 0.5, 0] += 1
    return stamp_rows(rng, n, q), stamp_rows(rng, n, q), q, qs


T = torch.from_numpy


@pytest.fixture(autouse=True)
def _zero_counts():
    kernel.reset_launches()
    yield
    # CPU tensors never reach a kernel: the counters stay at zero
    assert kernel.launches == {"before": 0, "visibility": 0,
                               "before_pairs": 0, "visibility_residue": 0}


@pytest.mark.parametrize("n", [0, 1, 1023, 1025, 5000])
@pytest.mark.parametrize("c", [3, 9])
def test_cpu_route_matches_reference_kernels(n, c):
    create, delete, q, qs = case(n, c, 7 * n + c)
    got_b = ops.before_mask(T(create), T(q))
    got_v = ops.visibility_mask(T(create), T(delete), T(q))
    got_p = ops.before_pairs(T(create), T(qs))
    for got in (got_b, got_v, got_p):
        assert got.dtype == torch.bool and got.shape == (n,)
    if n:
        want_b = np.asarray(ref_ops.before_mask(
            jnp.asarray(create), jnp.asarray(q), interpret=True))
        want_v = np.asarray(ref_ops.visibility_mask(
            jnp.asarray(create), jnp.asarray(delete), jnp.asarray(q),
            interpret=True))
    else:                       # the Pallas grid needs one block
        want_b = ref_clock._np_before(create, q)
        want_v = ref_clock.visibility_mask_np(create, delete, q)
    np.testing.assert_array_equal(got_b.numpy(), want_b)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_array_equal(got_p.numpy(),
                                  ref_wp._np_before_pairs(create, qs))


def test_padded_tail_is_invisible():
    """The reference pads to its block with NO_STAMP rows; the port reads
    unpadded rows, and NO_STAMP rows come out False in both (the case of
    tests/test_snapshot_columnar.py::test_padded_tail_is_invisible)."""
    rng = np.random.default_rng(0)
    n, block = 100, 128
    create, delete, _, _ = case(n, 3, 0)
    create[:, 0] = rng.integers(0, 2, size=n)
    c_pad = np.pad(create, ((0, block - n), (0, 0)),
                   constant_values=NO_STAMP)
    d_pad = np.pad(delete, ((0, block - n), (0, 0)),
                   constant_values=NO_STAMP)
    q = np.asarray([1, 3, 3], np.int32)
    full = np.asarray(ref_kernel.visibility_pallas(
        jnp.asarray(c_pad.T), jnp.asarray(d_pad.T), jnp.asarray(q),
        block_n=block, interpret=True))
    got = ops.visibility_mask(T(c_pad), T(d_pad), T(q)).numpy()
    np.testing.assert_array_equal(got, full)
    assert not got[n:].any()
    np.testing.assert_array_equal(
        ops.visibility_mask(T(create), T(delete), T(q)).numpy(), full[:n])


def test_partition_columns_from_reference_arrays():
    """Port visibility over a port PartitionColumns built from a reference
    partition's packed arrays == the reference's Pallas kernel."""
    from repro.core import Weaver, WeaverConfig
    from repro.core.clock import Stamp
    w = Weaver(WeaverConfig(n_gatekeepers=2, n_shards=1, gc_period=0))
    part = w.shards[0].partition
    rng = np.random.default_rng(3)
    clk = [0, 0]

    def nxt():
        g = int(rng.integers(2))
        clk[g] += 1
        return Stamp(0, tuple(clk), g, clk[g])

    for i in range(60):
        part.create_vertex(f"v{i}", nxt())
    for i in range(200):
        part.create_edge(f"v{rng.integers(60)}", f"v{rng.integers(60)}",
                         nxt())
    for i in range(0, 60, 7):
        part.delete_vertex(f"v{i}", nxt())
    cols = part.columns
    pc = port_analytics.columns_from_numpy(
        2, cols.v_gid.view(), cols.v_create.view(), cols.v_delete.view(),
        cols.e_src.view(), cols.e_dst.view(), cols.e_create.view(),
        cols.e_delete.view())
    assert (pc.n_v, pc.n_e) == (cols.n_v, cols.n_e)
    for rc, rd, pcr, pdr in (
            (cols.v_create, cols.v_delete, pc.v_create, pc.v_delete),
            (cols.e_create, cols.e_delete, pc.e_create, pc.e_delete)):
        q = np.median(rc.view(), axis=0).astype(np.int32)   # mid-stream
        want = np.asarray(ref_ops.visibility_mask(
            jnp.asarray(rc.view()), jnp.asarray(rd.view()), jnp.asarray(q),
            interpret=True))
        got = ops.visibility_mask(T(pcr.view()), T(pdr.view()), T(q))
        np.testing.assert_array_equal(got.numpy(), want)
        assert want.any() and not want.all()


@pytest.mark.parametrize("bad", ["dtype", "shape", "q_shape", "strided",
                                 "mixed"])
def test_wrappers_reject_bad_input(bad):
    create, delete, q, qs = case(16, 3, 1)
    rows, qt = T(create), T(q)
    if bad == "dtype":
        rows = rows.to(torch.int64)
    elif bad == "shape":
        rows = rows.flatten()
    elif bad == "q_shape":
        qt = T(qs)
    elif bad == "strided":
        rows = T(np.ascontiguousarray(create.T)).T
    with pytest.raises((TypeError, ValueError)):
        if bad == "mixed":
            ops.visibility_mask(rows, T(delete[:8]), qt)
        else:
            ops.before_mask(rows, qt)


def test_non_cpu_tensor_goes_to_the_kernel_or_raises():
    """Only a CPU tensor takes the plain version: any other device goes
    to the CUDA wrapper, which refuses what it cannot launch on."""
    create, _, q, _ = case(8, 3, 2)
    rows = T(create).to("meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.before_mask(rows, T(q).to("meta"))


def test_plain_versions_agree_with_each_other():
    create, delete, q, qs = case(777, 5, 4)
    b = ref.before(T(create), T(q))
    np.testing.assert_array_equal(
        ref.before_pairs(T(create), T(np.repeat(q[None], 777, 0))).numpy(),
        b.numpy())
    np.testing.assert_array_equal(
        ref.visibility(T(create), T(delete), T(q)).numpy(),
        (b & ~ref.before(T(delete), T(q))).numpy())


@pytest.mark.parametrize("n", [1, 31, 32, 33, 1023, 1025])
def test_pack_bits_matches_numpy_packbits(n):
    """ref.pack_bits (the plain twin of the kernels' bit form) gives the
    bytes of np.packbits(bitorder="little"), zero-padded to whole words."""
    mask = np.random.default_rng(n).random(n) < 0.4
    got = ref.pack_bits(T(mask))
    assert got.dtype == torch.int32 and got.shape == ((n + 31) // 32,)
    want = np.packbits(mask, bitorder="little")
    want = np.pad(want, (0, -want.size % 4))
    np.testing.assert_array_equal(got.numpy().view(np.uint8), want)
    np.testing.assert_array_equal(
        np.unpackbits(got.numpy().view(np.uint8), count=n,
                      bitorder="little").view(bool), mask)


def _pallas_before(rows, q, block=128):
    """The reference's before_pallas in interpret mode over (N, C) rows,
    padded with NO_STAMP rows to whole blocks (N = 0 takes one block)."""
    n = rows.shape[0]
    n_pad = max(1, -(-n // block)) * block
    padded = np.pad(rows, ((0, n_pad - n), (0, 0)), constant_values=NO_STAMP)
    return np.asarray(ref_kernel.before_pallas(
        jnp.asarray(padded.T), jnp.asarray(q), block_n=block,
        interpret=True))[:n]


@pytest.mark.parametrize("n", [0, 1, 33, 1025])
@pytest.mark.parametrize("c", [3, 9])
def test_host_entries_cpu_route_match_reference(n, c):
    """ops.before_host / before_pairs_host with device="cpu" (numpy in,
    numpy bool out) == before_pallas in interpret mode and
    writepath._np_before_pairs; a row view and int64 input too."""
    create, _, q, qs = case(n, c, 11 * n + c)
    got_b = ops.before_host(create, q, "cpu")
    got_p = ops.before_pairs_host(create, qs, "cpu")
    for got in (got_b, got_p):
        assert isinstance(got, np.ndarray)
        assert got.dtype == bool and got.shape == (n,)
    np.testing.assert_array_equal(got_b, _pallas_before(create, q))
    np.testing.assert_array_equal(got_p, ref_wp._np_before_pairs(create, qs))
    if n > 1:
        np.testing.assert_array_equal(
            ops.before_host(create[1:].astype(np.int64), q, "cpu"),
            got_b[1:])
        np.testing.assert_array_equal(
            ops.before_pairs_host(create[::2], qs[::2], "cpu"), got_p[::2])


@pytest.mark.parametrize("bad", ["dtype", "shape", "q_shape", "list"])
def test_host_entries_reject_bad_input(bad):
    create, _, q, qs = case(16, 3, 1)
    rows = create
    if bad == "dtype":
        rows = create.astype(np.float32)
    elif bad == "shape":
        rows = create.ravel()
    elif bad == "q_shape":
        q = qs
    elif bad == "list":
        rows = create.tolist()
    with pytest.raises((TypeError, ValueError)):
        ops.before_host(rows, q, "cpu")
    with pytest.raises((TypeError, ValueError)):
        kernel.before_host(rows, q, "cpu")        # the card entry refuses


def test_snapshot_eval_merged_call_equals_two_calls():
    """SnapshotEngine._eval evaluates create and delete rows in ONE
    before_host call; its cb, db equal two separate calls."""
    from types import SimpleNamespace
    create, delete, q, _ = case(300, 3, 5)
    eng = SimpleNamespace(device="cpu")
    cb, db = port_analytics.SnapshotEngine._eval(
        eng, create, delete, None, None, q, None, False, [])
    np.testing.assert_array_equal(
        cb, port_analytics._before_batch(create, q, "cpu"))
    np.testing.assert_array_equal(
        db, port_analytics._before_batch(delete, q, "cpu"))
    assert cb.shape == db.shape == (300,) and cb.any() and db.any()
    empty = np.zeros((0, 3), np.int32)
    cb0, db0 = port_analytics.SnapshotEngine._eval(
        eng, empty, empty, None, None, q, None, True, [])
    assert cb0.shape == db0.shape == (0,)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 1023, 1025])
@pytest.mark.parametrize("c", [2, 3, 4, 5, 6, 7, 8, 9, 17])
def test_visibility_cpu_routes_match_reference(n, c):
    """ops.visibility_host(..., "cpu") and ops.visibility_mask on CPU
    tensors == visibility_pallas in interpret mode and visibility_ref
    (through the reference's ops.visibility_mask), at every compiled
    width of the kernel and one it reads at run time, with NO_STAMP rows
    and tied epochs."""
    create, delete, q, _ = case(n, c, 13 * n + c)
    if n >= 32:                 # both kinds of row in each table
        for rows in (create, delete):
            assert (rows[:, 0] == NO_STAMP).any()
            assert (rows[:, 0] == q[0]).any()
    args = (jnp.asarray(create), jnp.asarray(delete), jnp.asarray(q))
    want = np.asarray(ref_ops.visibility_mask(*args, interpret=True))
    np.testing.assert_array_equal(
        np.asarray(ref_ops.visibility_mask(*args, use_ref=True)), want)
    got_host = ops.visibility_host(create, delete, q, "cpu")
    assert isinstance(got_host, np.ndarray)
    assert got_host.dtype == bool and got_host.shape == (n,)
    np.testing.assert_array_equal(got_host, want)
    np.testing.assert_array_equal(
        ops.visibility_mask(T(create), T(delete), T(q)).numpy(), want)
    if n > 1:                   # a row view and int64 input take it too
        np.testing.assert_array_equal(
            ops.visibility_host(create[1:].astype(np.int64), delete[1:], q,
                                "cpu"), want[1:])


@pytest.mark.parametrize("n", [1, 31, 32, 33, 1023, 1025])
def test_pack_bits_of_visibility_matches_numpy_packbits(n):
    """The plain twin of visibility's bit form, ref.pack_bits over
    ref.visibility, gives np.packbits(bitorder="little")'s bytes."""
    create, delete, q, _ = case(n, 3, 17 * n)
    mask = ref.visibility(T(create), T(delete), T(q))
    got = ref.pack_bits(mask)
    assert got.dtype == torch.int32 and got.shape == ((n + 31) // 32,)
    want = np.packbits(mask.numpy(), bitorder="little")
    np.testing.assert_array_equal(got.numpy().view(np.uint8),
                                  np.pad(want, (0, -want.size % 4)))


@pytest.mark.parametrize("bad", ["dtype", "shape", "q_shape", "list",
                                 "mixed"])
def test_visibility_host_rejects_bad_input(bad):
    create, delete, q, qs = case(16, 3, 1)
    if bad == "dtype":
        create = create.astype(np.float32)
    elif bad == "shape":
        create = create.ravel()
    elif bad == "q_shape":
        q = qs
    elif bad == "list":
        delete = delete.tolist()
    elif bad == "mixed":
        delete = delete[:8]
    with pytest.raises((TypeError, ValueError)):
        ops.visibility_host(create, delete, q, "cpu")
    with pytest.raises((TypeError, ValueError)):
        kernel.visibility_host(create, delete, q, "cpu")  # card entry


def test_visible_edges_at_matches_reference_on_a_seeded_stream():
    """One seeded stream (creates, edge deletes, GC) through the reference
    Weaver and the port's on the CPU: at each program's stamp the port's
    visible_edges_at(..., device="cpu") == the reference's (edges and
    mask), and its mask == ops.visibility_host over the raw rows."""
    steps = chip_smoke.make_stream(9, 40, avg_degree=6, n_tx=30, n_prog=3,
                                   chunk=64)
    kw = dict(n_gatekeepers=2, n_shards=2, seed=9)
    _, w_ref = chip_smoke.run_stream(
        ref_core, ref_analytics, ref_core.WeaverConfig(**kw), steps)
    _, w_port = chip_smoke.run_stream(
        port_core, port_analytics,
        port_core.WeaverConfig(device="cpu", **kw), steps, device="cpu")
    n_checked = 0
    for name in ("count_edges", "get_edges"):
        _, at_ref, _ = w_ref.run_program(name, [("u0", None)])
        _, at_port, _ = w_port.run_program(name, [("u0", None)])
        ga_ref = ref_analytics.snapshot_arrays(w_ref, at_ref, keep_raw=True)
        ga = port_analytics.snapshot_arrays(w_port, at_port, keep_raw=True)
        want = ref_analytics.visible_edges_at(ga_ref, at_ref, 2)
        got = port_analytics.visible_edges_at(ga, at_port, 2, device="cpu")
        for g, x in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(x))
        np.testing.assert_array_equal(
            got[2], ops.visibility_host(ga.edge_create, ga.edge_delete,
                                        port_analytics.clock.pack(at_port, 2),
                                        "cpu"))
        assert got[2].any() and not got[2].all()
        n_checked += got[2].size
    assert n_checked > 100
    ga.edge_create = ga.edge_create[:0]
    ga.edge_delete = ga.edge_delete[:0]
    src, dst, mask = port_analytics.visible_edges_at(ga, at_port, 2,
                                                     device="cpu")
    assert src.size == dst.size == mask.size == 0 and mask.dtype == bool
