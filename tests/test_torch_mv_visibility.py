"""Port's stamp-compare wrappers (``repro_torch.kernels.mv_visibility``)
on CPU tensors == the reference's Pallas kernels run in interpret mode
and ``writepath._np_before_pairs``, bit for bit.  The CUDA kernels
themselves run only on the card (``tests/test_torch_kernels_cuda.py``
and ``chip_smoke.py``)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import clock as ref_clock
from repro.core import writepath as ref_wp
from repro.kernels.mv_visibility import kernel as ref_kernel
from repro.kernels.mv_visibility import ops as ref_ops
from repro_torch.core import analytics as port_analytics
from repro_torch.kernels.mv_visibility import kernel, ops, ref

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
                               "before_pairs": 0}


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
