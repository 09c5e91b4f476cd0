"""Port's sorted-segment helpers (``repro_torch.kernels.segment_mp.ops``)
== the reference's, on numpy inputs (``reduceat``) and on torch tensors
(``scatter_reduce``)."""

import numpy as np
import pytest
import torch

from repro.kernels.segment_mp import ops as ref_ops
from repro_torch.kernels.segment_mp import ops


def sorted_case(n, seed):
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, max(1, n // 3), size=n)).astype(np.int64)
    vals = rng.normal(size=n)
    return keys, vals


@pytest.mark.parametrize("op", ["min", "max", "sum"])
@pytest.mark.parametrize("n", [0, 1, 17, 1000])
def test_segment_reduce_sorted_matches_reference(op, n):
    keys, vals = sorted_case(n, n)
    want_k, want_v = ref_ops.segment_reduce_sorted(vals, keys, op,
                                                   use_jax=False)
    got_k, got_v = ops.segment_reduce_sorted(vals, keys, op)
    np.testing.assert_array_equal(got_k, want_k)
    np.testing.assert_array_equal(got_v, want_v)
    t_k, t_v = ops.segment_reduce_sorted(torch.from_numpy(vals),
                                         torch.from_numpy(keys), op)
    np.testing.assert_array_equal(t_k.numpy(), want_k)
    np.testing.assert_allclose(t_v.numpy(), want_v, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(ops.segment_starts(keys),
                                  ref_ops.segment_starts(keys))
    np.testing.assert_array_equal(
        ops.segment_starts(torch.from_numpy(keys)).numpy(),
        ref_ops.segment_starts(keys))


@pytest.mark.parametrize("n", [0, 5, 400])
def test_segment_count_sorted_matches_reference(n):
    keys, _ = sorted_case(n, 3 * n + 1)
    want = ref_ops.segment_count_sorted(keys)
    for got in (ops.segment_count_sorted(keys),
                [x.numpy() for x in
                 ops.segment_count_sorted(torch.from_numpy(keys))]):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


# ------------------------------------------------ segment_matmul_reduce ---
# The port's segment_matmul_reduce on CPU tensors (its plain version)
# against the reference's Pallas kernel in interpret mode, at the
# reference tests' cases and tolerances (tests/test_kernels.py).

import jax.numpy as jnp  # noqa: E402

from repro.kernels.segment_mp.ref import segment_matmul_reduce_ref  # noqa
from repro_torch.kernels.segment_mp import kernel as smp_kernel  # noqa
from repro_torch.models import mp as port_mp  # noqa: E402

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def mp_case(n, e, d, f, seed, hub=None):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d, f)).astype(np.float32)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    if hub is not None:
        dst = np.where(rng.random(e) < 0.5, hub,
                       rng.integers(0, n, e)).astype(np.int32)
    return x, w, src, dst


@pytest.mark.parametrize("n,e,d,f,dtype", [
    (64, 256, 16, 32, "float32"),
    (128, 1000, 64, 64, "float32"),
    (300, 2000, 32, 8, "float32"),
    (128, 512, 128, 128, "bfloat16"),
    (17, 3, 8, 16, "float32"),          # tiny/ragged
])
def test_segment_matmul_reduce_matches_pallas(n, e, d, f, dtype):
    x, w, src, dst = mp_case(n, e, d, f, e + d)
    want = np.asarray(ref_ops.segment_matmul_reduce(
        jnp.asarray(x, dtype), jnp.asarray(w, dtype), jnp.asarray(src),
        jnp.asarray(dst), n, block_n=32, block_e=64), np.float32)
    tdt = TORCH_DT[dtype]
    got = ops.segment_matmul_reduce(
        torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt),
        torch.from_numpy(src), torch.from_numpy(dst), n)
    assert got.dtype == tdt and got.shape == (n, f)
    got = got.float().numpy()
    if dtype == "bfloat16":
        # as in the reference test: against the fp32 ground truth
        truth = np.asarray(segment_matmul_reduce_ref(
            jnp.asarray(jnp.asarray(x, dtype), jnp.float32),
            jnp.asarray(jnp.asarray(w, dtype), jnp.float32),
            jnp.asarray(src), jnp.asarray(dst), n))
        np.testing.assert_allclose(got, truth, rtol=3e-2, atol=3e-1)
        np.testing.assert_allclose(want, truth, rtol=3e-2, atol=3e-1)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_segment_matmul_reduce_hub_matches_pallas():
    """Power-law dst distribution (one hub node takes half the edges)."""
    n, e, d, f = 100, 3000, 16, 16
    x, w, src, dst = mp_case(n, e, d, f, 0, hub=7)
    want = np.asarray(ref_ops.segment_matmul_reduce(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(src), jnp.asarray(dst),
        n, block_n=32, block_e=128))
    got = ops.segment_matmul_reduce(*map(torch.from_numpy, (x, w, src, dst)),
                                    n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_propagate_matmul_kernel_switch_and_sorted_flag():
    """The port's mp seam: plain path == reference jnp path; with the
    kernel switch on, CPU tensors take the kernel's plain version; the
    dst_sorted claim on sorted edges changes nothing."""
    from repro.models import mp as ref_mp
    n, e, d, f = 40, 200, 8, 8
    x, w, src, dst = mp_case(n, e, d, f, 1)
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    want = np.asarray(ref_mp.propagate_matmul(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(src), jnp.asarray(dst),
        n, dst_sorted=True))
    args = [torch.from_numpy(a) for a in (x, w, src, dst)]
    base = port_mp.propagate_matmul(*args, n)
    srt = port_mp.propagate_matmul(*args, n, dst_sorted=True)
    port_mp.set_use_kernel(True)
    try:
        fused = port_mp.propagate_matmul(*args, n, dst_sorted=True)
    finally:
        port_mp.set_use_kernel(False)
    for got in (base, srt, fused):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("chunk", [1, 4, 1024])
def test_kernel_plan_covers_every_heavy_row_once(chunk):
    """The hub-splitting plan the CUDA kernel runs from (built on the
    tensors' device, so checkable here): every row above ``chunk`` edges
    is cut into consecutive chunks of at most ``chunk`` edges that tile
    its edge range exactly; summing x rows chunk by chunk gives the
    row's sum."""
    n, e, d = 50, 3000, 4
    x, _, src, dst = mp_case(n, e, d, 1, 3, hub=7)
    dst = np.sort(dst)
    indptr = ops.csr_indptr(torch.from_numpy(dst), n)
    np.testing.assert_array_equal(
        indptr.numpy(), np.searchsorted(dst, np.arange(n + 1)))
    assert indptr.dtype == torch.int32
    rows, ptr, lo, hi = smp_kernel.plan(indptr, chunk)
    deg = np.diff(indptr.numpy())
    np.testing.assert_array_equal(rows.numpy(), np.flatnonzero(deg > chunk))
    for t in (rows, ptr, lo, hi):
        assert t.dtype == torch.int32
    xs = torch.from_numpy(x)[torch.from_numpy(src).long()]
    for h, r in enumerate(rows.tolist()):
        cl, ch = lo[ptr[h]:ptr[h + 1]], hi[ptr[h]:ptr[h + 1]]
        assert cl[0] == indptr[r] and ch[-1] == indptr[r + 1]
        assert torch.equal(cl[1:], ch[:-1])
        assert bool(((ch - cl) <= chunk).all() and ((ch - cl) > 0).all())
        parts = torch.stack([xs[a:b].sum(0) for a, b in
                             zip(cl.tolist(), ch.tolist())])
        torch.testing.assert_close(parts.sum(0), xs[indptr[r]:indptr[r + 1]]
                                   .sum(0), rtol=1e-5, atol=1e-5)
