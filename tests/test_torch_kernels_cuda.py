"""The port's CUDA kernels against their plain versions, on the card.

Imports only ``torch`` and ``repro_torch``, so it also runs where JAX is
absent: ``python -m pytest -q tests/test_torch_kernels_cuda.py`` on a
CUDA machine.  Without a card the kernel test skips with its reason;
the build helpers are checked everywhere."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.mv_visibility import kernel, ref
from repro_torch.kernels.segment_mp import kernel as smp_kernel
from repro_torch.kernels.segment_mp import ops as smp_ops
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.embedding_bag import kernel as eb_kernel
from repro_torch.kernels.embedding_bag import ops as eb_ops

NO_STAMP = ref.NO_STAMP


def case(n, c, seed):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 5, size=c).astype(np.int32)
    q[0] = 1

    def rows():
        r = rng.integers(0, 5, size=(n, c)).astype(np.int32)
        r[:, 0] = q[0] + rng.integers(-1, 2, size=n)
        r[rng.random(n) < 0.15, 1:] = q[1:]
        r[rng.random(n) < 0.2] = NO_STAMP
        return r

    qs = np.repeat(q[None], n, axis=0)
    qs[rng.random(n) < 0.5, 0] += 1
    return rows(), rows(), q, qs


def test_cuda_kernels_match_plain():
    """Card only: each CUDA kernel == its plain version on the device,
    including ragged tails, and each launch is counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    dev = torch.device("cuda")
    kernel.reset_launches()
    shapes = [(n, c) for n in (1, 1023, 1025, 100_000) for c in (3, 9)]
    for n, c in shapes:
        a = [torch.from_numpy(x).to(dev) for x in case(n, c, n + c)]
        assert torch.equal(kernel.before(a[0], a[2]), ref.before(a[0], a[2]))
        assert torch.equal(kernel.visibility(a[0], a[1], a[2]),
                           ref.visibility(a[0], a[1], a[2]))
        assert torch.equal(kernel.before_pairs(a[0], a[3]),
                           ref.before_pairs(a[0], a[3]))
        res = torch.empty(1 + n, dtype=torch.int64, device=dev)
        bits = kernel.visibility_residue(a[0], a[1], a[2], res)
        want_bits, want_entries = ref.visibility_residue(a[0], a[1], a[2])
        assert torch.equal(bits, want_bits)
        assert int(res[0]) == want_entries.numel()
        assert torch.equal(res[1:1 + int(res[0])].sort().values,
                           want_entries)
    torch.cuda.synchronize()
    assert kernel.launches == {k: len(shapes) for k in kernel.launches}
    empty = torch.zeros((0, 3), dtype=torch.int32, device=dev)
    assert kernel.before(empty, a[2][:3]).shape == (0,)   # no launch
    assert kernel.launches["before"] == len(shapes)
    kernel.reset_launches()


def test_stamp_compare_forms_and_host_entries_match_plain():
    """Card only: before / before_pairs / visibility in both output forms
    (bytes, and bit words against ref.pack_bits) and their three host
    entries == their plain versions at chip_smoke's cases (C in (3, 9), N
    in STAMP_NS and 100,000, views whose address is not 16-byte aligned,
    and C = 17 and 40); each form and entry is one counted launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    cs = smoke()
    kernel.reset_launches()
    n_cases = 0
    for (n, c, off), _, checks in cs.stamp_edge_cases(0, "cuda", 100_000):
        assert not any(checks.values()), f"N={n} C={c} offset {off}: {checks}"
        n_cases += 1
    assert kernel.launches == {"before": 3 * n_cases,
                               "visibility": 3 * n_cases,
                               "before_pairs": 3 * n_cases,
                               "visibility_residue": 0}
    assert kernel.before_host(np.zeros((0, 3), np.int32),
                              np.zeros(3, np.int32)).shape == (0,)
    assert kernel.launches["before"] == 3 * n_cases          # no launch
    kernel.reset_launches()


def test_host_entries_allocate_nothing_when_warm():
    """Card only: once its buffers have grown, a host entry's call (one
    H2D copy, one launch, one D2H copy, one wait) makes no CUDA
    allocation: 100 warm calls of each leave
    memory_stats()["allocation.all.allocated"] unchanged."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    rows, dele, q, qs = case(1024, 3, 5)
    want_b = ref.before(torch.from_numpy(rows), torch.from_numpy(q)).numpy()
    want_p = ref.before_pairs(torch.from_numpy(rows),
                              torch.from_numpy(qs)).numpy()
    want_v = ref.visibility(torch.from_numpy(rows), torch.from_numpy(dele),
                            torch.from_numpy(q)).numpy()
    for _ in range(3):
        kernel.before_host(rows, q)
        kernel.before_pairs_host(rows, qs)
        kernel.visibility_host(rows, dele, q)
    torch.cuda.synchronize()
    kernel.reset_launches()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    for i in range(100):
        m = i % 1024 + 1                        # smaller calls fit too
        np.testing.assert_array_equal(kernel.before_host(rows[:m], q),
                                      want_b[:m])
        np.testing.assert_array_equal(
            kernel.before_pairs_host(rows[:m], qs[:m]), want_p[:m])
        np.testing.assert_array_equal(
            kernel.visibility_host(rows[:m], dele[:m], q), want_v[:m])
    assert torch.cuda.memory_stats()["allocation.all.allocated"] == before
    assert kernel.launches == {"before": 100, "visibility": 100,
                               "before_pairs": 100, "visibility_residue": 0}
    kernel.reset_launches()


def test_rec_server_bad_item_id_raises_and_context_lives():
    """Card only: an item id past SASRec's table raises IndexError on
    the host before any upload, and the same server then answers a good
    top_k as before (in a subprocess, so that a regression that reaches
    the bag kernel's trap cannot end this process's CUDA context)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the server runs on the card")
    assert "outside" in smoke().rec_bad_id_subprocess()


def test_build_keys_library_by_source_and_needs_nvcc(monkeypatch, tmp_path):
    assert build.sources() == ["bfs_round", "embedding_bag",
                               "flash_attention", "flash_attention_tc",
                               "flash_decode", "mv_visibility", "segment_mp"]
    path = build.library_path("mv_visibility")
    assert path.parent == build.BUILD_DIR and path.suffix == ".so"
    assert path == build.library_path("mv_visibility")       # stable key
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.nvcc()


def smoke():
    """chip_smoke.py, whose segment_mp cases and checks this file shares."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


def test_segment_mp_kernel_matches_plain():
    """Card only: the segment_mp kernel == its plain version on the
    device at chip_smoke's cases and tolerances (the reference tests'
    cases, hub rows split into chunks, gat-cora's D = 1433, bf16, each
    gather order and their tie) and at F = 300 with a hub and with x at
    an address only 4-byte aligned; each call is one counted launch of
    the order chip_smoke's rule names."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    cs = smoke()
    dev = torch.device("cuda")
    smp_kernel.reset_launches()
    orders = set()
    for case, got, (ok, err, tol), order in cs.mp_edge_cases(0, dev):
        n, e, d, f, dt, hub, kind = case
        assert got.dtype == dt and got.shape == (n, f)
        assert ok, f"N={n} E={e} D={d} F={f} {dt}: max |err| {err}; {tol}"
        assert order == cs.mp_order(d, f, dt), case
        orders.add((order, dt))
    assert len(orders) == 4          # both orders, in fp32 and in bf16
    rng = np.random.default_rng(0)
    x, w, src, dst = cs.mp_case(rng, 1000, 4000, 64, 300, 3, dev)
    got = smp_ops.segment_matmul_reduce(x, w, src, dst, 1000)
    ok, err, tol = cs.mp_check(got, x, w, src, dst, 1000, "hub")
    assert ok, f"F = 300: max |err| {err}; {tol}"
    buf = torch.zeros(1000 * 64 + 1, device=dev)
    x_off = buf[1:].view(1000, 64)      # aggregate first, 4-byte loads
    x_off.copy_(x)
    assert smp_kernel.vec_bytes(64 * 4, 4, x_off.data_ptr()) == 4
    got = smp_ops.segment_matmul_reduce(x_off, w, src, dst, 1000)
    ok, err, tol = cs.mp_check(got, x, w, src, dst, 1000, "hub")
    assert ok, f"offset x: max |err| {err}; {tol}"
    torch.cuda.synchronize()
    assert smp_kernel.launches["segment_mp"] == len(cs.MP_CASES) + 2
    assert smp_kernel.launches["segment_mp"] == \
        smp_kernel.launches["segment_mp_aggregate"] + \
        smp_kernel.launches["segment_mp_transform"]
    smp_kernel.reset_launches()


def test_segment_mp_plan_on_card_matches_plain():
    """Card only: the hub plan the kernel builds (three passes: counts,
    scan, fill) == its plain version, at both levels, for empty rows,
    rows of exactly CHUNK and CHUNK + 1 edges, an all-hub graph, hubs of
    more than CHUNK chunks, and graphs spanning several plan blocks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    c = smp_kernel.CHUNK
    rng = np.random.default_rng(0)
    cases = [[0, 0, 5, 0], [c, c + 1, 0, c - 1, 1], [3 * c, 2 * c + 1],
             [2, c * c + 5, 0, c * c], [0] * 3000 + [c + 1] * 7,
             list(rng.zipf(1.3, 5000) % (4 * c * c))]
    for degrees in cases:
        indptr = torch.from_numpy(np.r_[0, np.cumsum(degrees)]
                                  .astype(np.int32)).cuda()
        for chunk in (c, 4):
            got = smp_kernel.plan_on_card(indptr, chunk)
            assert torch.equal(got, smp_kernel.plan(indptr, chunk))
            assert torch.equal(smp_kernel.plan_on_card(got, chunk),
                               smp_kernel.plan(got, chunk))


def test_segment_mp_wrapper_refuses_cpu_and_grad():
    """The kernel wrapper launches on CUDA tensors or raises: it refuses
    CPU tensors, and inputs that require grad (it has no backward)."""
    before = smp_kernel.launches["segment_mp"]
    x, w, src, dst = smoke().mp_case(np.random.default_rng(0), 10, 30, 4, 4,
                                     None, "cpu")
    order = torch.argsort(dst, stable=True)
    src, dst = src[order], dst[order]
    indptr = smp_ops.csr_indptr(dst, 10)
    with pytest.raises(ValueError, match="CUDA tensors"):
        smp_kernel.segment_mp(x, w, src, indptr)
    with pytest.raises(ValueError, match="no backward"):
        smp_kernel.segment_mp(x, w.requires_grad_(), src, indptr)
    assert smp_kernel.launches["segment_mp"] == before


def test_flash_attention_kernel_matches_plain():
    """Card only: the flash_attention kernels == their plain version
    (fp32) on the device at chip_smoke's cases and tolerances: the
    reference tests' cases, Sq > Sk causal (rows with no valid key),
    ragged Sq and Sk, n_rep 1 to 16, D up to 256, per-row kv_len over a
    strided cache (windows past a full cache among them), and constant v,
    through each of the three variants; each call is one counted launch
    of the variant that select_variant names."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    cs = smoke()
    dev = torch.device("cuda")
    fa_kernel.reset_launches()
    for case, got, (ok, err, _, tol) in cs.flash_edge_cases(0, dev):
        b, sq, sk, hq, hkv, d, causal, window, dt, kind = case
        assert got.dtype == dt and got.shape == (b, sq, hq, d)
        assert ok, f"{case}: max |err| {err}; {tol}"
    torch.cuda.synchronize()
    assert fa_kernel.launches["flash_attention"] == len(cs.FLASH_CASES)
    rng = np.random.default_rng(0)
    want = {"flash_tc": 0, "flash_decode": 0, "flash_simt": 0}
    for case in cs.FLASH_CASES:
        q, k, v, _ = cs.flash_case(rng, case, dev)
        want["flash_" + fa_kernel.select_variant(
            q.dtype, q.shape, k.shape,
            fa_kernel._vec_ok((q, k, v), q.shape[-1]))] += 1
    assert {k: fa_kernel.launches[k] for k in want} == want
    assert all(want.values())
    fa_kernel.reset_launches()


def test_embedding_bag_kernel_matches_plain():
    """Card only: the embedding_bag kernel == its plain version at
    chip_smoke's cases and tolerances (the reference tests' cases,
    all-pad bags, mean mode with weights in bf16, one-index bags bit for
    bit, more than 32 indices per bag, odd D, several bags per group,
    int64 indices) and over a table at an address only 4-byte aligned;
    each call is one counted launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    cs = smoke()
    dev = torch.device("cuda")
    eb_kernel.reset_launches()
    for case, got, (ok, err, tol) in cs.bag_edge_cases(0, dev):
        v, d, b, l, weighted, mode, dt, kind = case
        assert got.dtype == dt and got.shape == (b, d)
        assert ok, f"V={v} D={d} B={b} L={l} {mode} {dt}: {err}; {tol}"
    rng = np.random.default_rng(0)
    table, idx, w = cs.bag_case(rng, 400, 48, 50, 11, True, "ref",
                                torch.float32, dev)
    buf = torch.zeros(400 * 48 + 1, device=dev)
    t_off = buf[1:].view(400, 48)
    t_off.copy_(table)
    assert eb_kernel.vec_bytes(48 * 4, 4, t_off.data_ptr()) == 4
    for mode in ("sum", "mean"):
        got = eb_ops.embedding_bag(t_off, idx, w, mode=mode)
        ok, err, tol = cs.bag_check(got, table, idx, w, mode, "ref")
        assert ok, f"offset table, {mode}: {err}; {tol}"
    torch.cuda.synchronize()
    assert eb_kernel.launches["embedding_bag"] == len(cs.BAG_CASES) + 2
    eb_kernel.reset_launches()


def test_embedding_bag_index_past_table_faults_at_sync():
    """Card only: a bag index >= V launches (the wrapper reads nothing
    back), and the kernel's trap raises a CUDA error at the next
    torch.cuda.synchronize(), in a subprocess (a trap ends the
    context)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    assert "error at synchronize" in smoke().bag_out_of_range()


def test_kernel_wrappers_make_no_synchronising_call():
    """Card only: embedding_bag and segment_mp, through ops and kernel,
    run under torch.cuda.set_sync_debug_mode("error") without raising:
    neither wrapper synchronises or reads device memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    cs = smoke()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for d, f in ((48, 24), (16, 64)):                 # both orders
        x, w, src, dst = cs.mp_case(rng, 300, 5000, d, f, 5, dev)
        dst_s, order = torch.sort(dst, stable=True)
        src_s, indptr = src[order], smp_ops.csr_indptr(dst_s, 300)
        for dt in (torch.float32, torch.bfloat16):
            xt, wt = x.to(dt), w.to(dt)
            cs.sync_free(lambda: smp_ops.segment_matmul_reduce(
                xt, wt, src, dst, 300))
            cs.sync_free(lambda: smp_kernel.segment_mp(xt, wt, src_s, indptr))
    for kind, dt in (("ref", torch.float32), ("ref64", torch.bfloat16)):
        table, idx, w = cs.bag_case(rng, 500, 50, 64, 9, True, kind, dt, dev)
        for mode in ("sum", "mean"):
            cs.sync_free(lambda: eb_ops.embedding_bag(table, idx, w, mode))
            cs.sync_free(lambda: eb_kernel.embedding_bag(
                table, idx, None, mode == "mean"))
    torch.cuda.synchronize()
    smp_kernel.reset_launches()
    eb_kernel.reset_launches()


def test_attention_and_bag_wrappers_refuse_cpu_and_grad():
    """The kernel wrappers launch on CUDA tensors or raise: they refuse
    CPU tensors and inputs that require grad (no backward).  The bag's
    index range is checked on the card (see
    test_embedding_bag_index_past_table_faults_at_sync)."""
    q = torch.zeros((1, 4, 2, 8))
    k = torch.zeros((1, 4, 1, 8))
    fa_kernel.reset_launches()
    eb_kernel.reset_launches()
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa_kernel.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="no backward"):
        fa_kernel.flash_attention(q.requires_grad_(), k, k)
    table = torch.zeros((5, 3))
    idx = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        eb_kernel.embedding_bag(table, idx)
    with pytest.raises(ValueError, match="no backward"):
        eb_kernel.embedding_bag(table.requires_grad_(), idx)
    assert fa_kernel.launches["flash_attention"] == 0
    assert eb_kernel.launches["embedding_bag"] == 0

