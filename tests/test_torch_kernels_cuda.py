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
    assert build.sources() == ["mv_visibility", "segment_mp"]
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
