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
    torch.cuda.synchronize()
    assert kernel.launches == {k: len(shapes) for k in kernel.launches}
    empty = torch.zeros((0, 3), dtype=torch.int32, device=dev)
    assert kernel.before(empty, a[2][:3]).shape == (0,)   # no launch
    assert kernel.launches["before"] == len(shapes)
    kernel.reset_launches()


def test_build_keys_library_by_source_and_needs_nvcc(monkeypatch, tmp_path):
    assert build.sources() == ["embedding_bag", "flash_attention",
                               "flash_attention_tc", "flash_decode",
                               "mv_visibility", "segment_mp"]
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
    cases, a hub row split into chunks, gat-cora's D = 1433, bf16) and at
    F = 300 with a hub; each call is one counted launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    cs = smoke()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    smp_kernel.reset_launches()
    cases = cs.MP_CASES + [(1000, 4000, 64, 300, torch.float32, 3, "hub")]
    for n, e, d, f, dt, hub, kind in cases:
        x, w, src, dst = cs.mp_case(rng, n, e, d, f, hub, dev)
        got = smp_ops.segment_matmul_reduce(x.to(dt), w.to(dt), src, dst, n)
        assert got.dtype == dt and got.shape == (n, f)
        ok, err, tol = cs.mp_check(got, x, w, src, dst, n, kind)
        assert ok, f"N={n} E={e} D={d} F={f} {dt}: max |err| {err}; {tol}"
    torch.cuda.synchronize()
    assert smp_kernel.launches["segment_mp"] == len(cases)
    smp_kernel.reset_launches()


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
    chip_smoke's cases and tolerances (the reference tests' cases, an
    all-pad bag, mean mode with weights in bf16, one-index bags bit for
    bit, more than 32 indices per bag); each call is one counted launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    cs = smoke()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    eb_kernel.reset_launches()
    for v, d, b, l, weighted, mode, dt, kind in cs.BAG_CASES:
        table, idx, w = cs.bag_case(rng, v, d, b, l, weighted, kind, dt, dev)
        got = eb_ops.embedding_bag(table, idx, w, mode=mode)
        assert got.dtype == dt and got.shape == (b, d)
        ok, err, tol = cs.bag_check(got, table, idx, w, mode, kind)
        assert ok, f"V={v} D={d} B={b} L={l} {mode} {dt}: {err}; {tol}"
    torch.cuda.synchronize()
    assert eb_kernel.launches["embedding_bag"] == len(cs.BAG_CASES)
    eb_kernel.reset_launches()


def test_attention_and_bag_wrappers_refuse_cpu_and_grad():
    """The kernel wrappers launch on CUDA tensors or raise: they refuse
    CPU tensors and inputs that require grad (no backward), and the bag
    refuses an index past the table."""
    q = torch.zeros((1, 4, 2, 8))
    k = torch.zeros((1, 4, 1, 8))
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
    if torch.cuda.is_available():
        with pytest.raises(IndexError, match="out of range"):
            eb_kernel.embedding_bag(torch.zeros((5, 3), device="cuda"),
                                    torch.full((2, 2), 5, dtype=torch.int32,
                                               device="cuda"))
