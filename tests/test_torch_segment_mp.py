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


def chunk_ranges(ptr, cptr, chunk):
    """``chunk_kernel``'s view of a plan ``cptr`` over row pointers
    ``ptr``, worked out as ``csrc/segment_mp.cu`` does: chunk k finds its
    row as the last a with ``cptr[a] <= k`` (binary search) and covers
    ``chunk`` entries from ``ptr[a] + (k - cptr[a]) * chunk``, clipped at
    the row's end.  Returns (a, lo, hi) per chunk."""
    ip, cp = ptr.tolist(), cptr.tolist()
    n = len(ip) - 1
    out = []
    for k in range(cp[n]):
        a, b = 0, n
        while b - a > 1:
            mid = (a + b) >> 1
            a, b = (mid, b) if cp[mid] <= k else (a, mid)
        lo = ip[a] + (k - cp[a]) * chunk
        out.append((a, lo, min(lo + chunk, ip[a + 1])))
    return out


def expand_plan(indptr, chunk):
    """Per dst row, the edge ranges the CUDA passes sum for it, in order:
    ``row_kernel`` sums a row's second-level partials when it has any
    (each the sum of a range of first-level partials), else its
    first-level partials (each the sum of a range of edges), else its own
    edges.  Returns (chunk_ptr, chunk2_ptr, ranges per row)."""
    c1 = smp_kernel.plan(indptr, chunk)
    c2 = smp_kernel.plan(c1, chunk)
    l1 = chunk_ranges(indptr, c1, chunk)
    l2 = chunk_ranges(c1, c2, chunk)
    ip, p1, p2 = indptr.tolist(), c1.tolist(), c2.tolist()
    rows = []
    for v in range(len(ip) - 1):
        if p2[v + 1] > p2[v]:
            assert all(l2[k][0] == v for k in range(p2[v], p2[v + 1]))
            parts = [p for k in range(p2[v], p2[v + 1])
                     for p in range(l2[k][1], l2[k][2])]
            assert all(0 < l2[k][2] - l2[k][1] <= chunk
                       for k in range(p2[v], p2[v + 1]))
        else:
            parts = list(range(p1[v], p1[v + 1]))
        assert all(l1[k][0] == v for k in parts)
        rows.append([l1[k][1:] for k in parts] if parts
                    else [(ip[v], ip[v + 1])])
    return c1, c2, rows


def check_plan(indptr, chunk):
    """Every edge of every row is summed exactly once and in edge order;
    only rows above ``chunk`` edges are split, each into ceil(deg /
    chunk) non-empty chunks of at most ``chunk`` edges, and only rows of
    more than ``chunk`` chunks a second time; both levels' chunk counts
    stay within the bounds the wrapper allocates from N and E alone."""
    c1, c2, rows = expand_plan(indptr, chunk)
    for c in (c1, c2):
        assert c.dtype == torch.int32
        assert c.shape == indptr.shape and int(c[0]) == 0
    n, e = indptr.numel() - 1, int(indptr[-1])
    m1 = smp_kernel.max_chunks(n, e, chunk)
    assert int(c1[-1]) <= m1
    assert int(c2[-1]) <= smp_kernel.max_chunks(n, m1, chunk)
    deg = np.diff(indptr.numpy())
    n_ch = np.diff(c1.numpy())
    np.testing.assert_array_equal(np.flatnonzero(n_ch),
                                  np.flatnonzero(deg > chunk))
    np.testing.assert_array_equal(n_ch[deg > chunk],
                                  -(-deg[deg > chunk] // chunk))
    np.testing.assert_array_equal(np.flatnonzero(np.diff(c2.numpy())),
                                  np.flatnonzero(n_ch > chunk))
    ip = indptr.tolist()
    for v, ranges in enumerate(rows):
        edges = [j for lo, hi in ranges for j in range(lo, hi)]
        assert edges == list(range(ip[v], ip[v + 1])), v
        if deg[v] > chunk:
            assert all(0 < hi - lo <= chunk for lo, hi in ranges)
    return rows


@pytest.mark.parametrize("chunk", [1, 4, 1024])
def test_kernel_plan_covers_every_heavy_row_once(chunk):
    """The hub-splitting plan the CUDA kernel runs from (built on the
    tensors' device, so checkable here): every row above ``chunk`` edges
    is cut into consecutive chunks of at most ``chunk`` edges that tile
    its edge range exactly, every other row is summed whole; summing x
    rows chunk by chunk gives the row's sum."""
    n, e, d = 50, 3000, 4
    x, _, src, dst = mp_case(n, e, d, 1, 3, hub=7)
    dst = np.sort(dst)
    indptr = ops.csr_indptr(torch.from_numpy(dst), n)
    np.testing.assert_array_equal(
        indptr.numpy(), np.searchsorted(dst, np.arange(n + 1)))
    assert indptr.dtype == torch.int32
    rows = check_plan(indptr, chunk)
    xs = torch.from_numpy(x)[torch.from_numpy(src).long()]
    for v, ranges in enumerate(rows):
        parts = torch.stack([xs[a:b].sum(0) for a, b in ranges])
        torch.testing.assert_close(parts.sum(0), xs[indptr[v]:indptr[v + 1]]
                                   .sum(0), rtol=1e-5, atol=1e-5)


C = smp_kernel.CHUNK


@pytest.mark.parametrize("degrees", [
    [0, 0, 5, 0],                          # empty rows
    [C, C + 1, 0, C - 1, 1],               # exactly CHUNK and CHUNK + 1
    [3 * C, 2 * C + 1, 5 * C + 7, C + 1],  # every row a hub
    [0, 0, 0],                             # no edges at all
    [1] * 40 + [17 * C + 3],               # one hub of 18 chunks
    [2, C * C + 5, 0, C * C],              # two levels, and just one
])
def test_kernel_plan_edge_cases(degrees):
    """The sync-free plan at the kernel's own CHUNK: empty rows, rows of
    exactly CHUNK and CHUNK + 1 edges, an all-hub graph, a graph without
    edges, a hub of many chunks and one of more than CHUNK chunks (split
    again) are each covered exactly once and in order."""
    indptr = torch.from_numpy(np.r_[0, np.cumsum(degrees)].astype(np.int32))
    check_plan(indptr, C)


@pytest.mark.parametrize("d,f,dtype,order", [
    (100, 64, torch.float32, "transform"),    # ogb-products: 256 < 400 B
    (1433, 8, torch.float32, "transform"),    # gat-cora: 32 B < 5.7 KB
    (16, 64, torch.float32, "aggregate"),     # gin-tu, first layer
    (64, 64, torch.float32, "aggregate"),     # gin-tu, tie: 256 = 256 B
    (100, 64, torch.bfloat16, "aggregate"),   # bf16 x: 256 > 200 B
    (64, 32, torch.bfloat16, "aggregate"),    # bf16 tie: 128 = 128 B
    (100, 8, torch.bfloat16, "transform"),    # 32 < 200 B
])
def test_select_order_gathers_the_narrower_rows(d, f, dtype, order):
    assert smp_kernel.select_order(d, f, dtype) == order


@pytest.mark.parametrize("width,es,ptr,vec,lanes", [
    (64, 4, 0, 16, 16),      # ogb-products' h rows: 16 lanes x float4
    (100, 4, 0, 16, 32),     # ogb-products' x rows: 25 float4, 32 lanes
    (16, 4, 0, 16, 4),       # gin-tu's x: one row per 4 lanes
    (10, 4, 0, 8, 8),        # F = 10: 5 float2
    (33, 2, 0, 2, 32),       # odd bf16 width: one element, 33 -> slices
    (64, 4, 4, 4, 32),       # x at a 4-byte-aligned address
])
def test_gather_launch_shape_rule(width, es, ptr, vec, lanes):
    got = smp_kernel.vec_bytes(width * es, es, ptr)
    assert got == vec
    assert smp_kernel.group_lanes(width * es // got) == lanes
