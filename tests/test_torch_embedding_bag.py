"""The port's EmbeddingBag wrapper (``repro_torch.kernels.embedding_bag``)
on CPU tensors, i.e. its plain version, against the reference's Pallas
kernel in interpret mode (through the reference's ``ops.embedding_bag``)
at the reference tests' cases and tolerances (tests/test_kernels.py):
1e-5 fp32, 3e-2 bf16, sum and mean (division by the clamped sum of the
weights), -1 pads, an all-pad bag (0), and SASRec's one-index bags
(the table row itself, bit for bit)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag import ops as ref_ops
from repro_torch.kernels.embedding_bag import kernel, ops


def _t(a, bf16):
    t = torch.from_numpy(np.asarray(a, np.float32))
    return t.to(torch.bfloat16) if bf16 else t


@pytest.mark.parametrize("v,d,b,l,weighted,mode,bf16", [
    (50, 128, 4, 6, False, "sum", False),
    (200, 128, 8, 10, True, "sum", False),
    (100, 256, 3, 5, True, "mean", False),
    (64, 128, 16, 4, False, "mean", False),
    (32, 128, 5, 7, True, "sum", True),
    (1000, 50, 33, 50, True, "mean", True),
    (300, 300, 7, 40, True, "sum", False),
])
def test_plain_version_matches_pallas(v, d, b, l, weighted, mode, bf16):
    rng = np.random.default_rng(v + b)
    table = rng.normal(size=(v, d)).astype(np.float32)
    idx = rng.integers(0, v, size=(b, l)).astype(np.int32)
    idx[rng.random((b, l)) < 0.2] = -1
    w = (np.abs(rng.normal(size=(b, l))) + 0.1).astype(np.float32) \
        if weighted else None
    jd = jnp.bfloat16 if bf16 else jnp.float32
    want = ref_ops.embedding_bag(jnp.asarray(table, jd), jnp.asarray(idx),
                                 None if w is None else jnp.asarray(w),
                                 mode=mode)
    got = ops.embedding_bag(_t(table, bf16), torch.from_numpy(idx),
                            None if w is None else torch.from_numpy(w),
                            mode=mode)
    assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert got.shape == (b, d)
    tol = 3e-2 if bf16 else 1e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               rtol=tol, atol=tol)


def test_all_padding_bag_is_zero():
    table = torch.ones((10, 128))
    idx = torch.full((2, 3), -1, dtype=torch.int32)
    got = ops.embedding_bag(table, idx)
    assert torch.equal(got, torch.zeros((2, 128)))
    want = ref_ops.embedding_bag(jnp.ones((10, 128)),
                                 jnp.full((2, 3), -1, jnp.int32))
    np.testing.assert_array_equal(np.asarray(want), 0.0)
    assert torch.equal(ops.embedding_bag(table, idx, mode="mean"),
                       torch.zeros((2, 128)))


def test_one_index_bags_are_the_rows():
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.normal(size=(500, 50)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 500, size=(64, 1)).astype(np.int32))
    assert torch.equal(ops.embedding_bag(table, idx), table[idx[:, 0].long()])
    assert kernel.launches["embedding_bag"] == 0      # CPU: no launch


@pytest.mark.parametrize("d,es,ptr,vec,lanes", [
    (50, 4, 0, 8, 32),       # sasrec fp32: 200-byte rows, float2 on 25
    (50, 2, 0, 4, 32),       # sasrec bf16: 100-byte rows, 4-byte loads
    (33, 4, 0, 4, 32),       # odd D fp32: one element per lane
    (33, 2, 0, 2, 32),       # odd D bf16: one element per lane
    (64, 4, 4, 4, 32),       # a table at a 4-byte-aligned address
    (64, 4, 8, 8, 32),       # ... at an 8-byte-aligned one
    (128, 4, 0, 16, 32),     # 32 float4 on 32 lanes
    (16, 4, 0, 16, 4),       # 64-byte rows: 8 bags per warp
    (300, 4, 0, 16, 32),     # 75 float4: three slices of 32 lanes
])
def test_bag_vector_width_rule(d, es, ptr, vec, lanes):
    """The widest of 16, 8, 4 bytes dividing the row stride and the
    pointer, else one element; lanes per bag the power of two at or above
    the row's vector count, 4 to 32."""
    got = kernel.vec_bytes(d * es, es, ptr)
    assert got == vec
    assert kernel.group_lanes(d * es // got) == lanes


@pytest.mark.parametrize("l,per_group", [(1, 8), (2, 4), (3, 3), (7, 2),
                                         (8, 1), (50, 1)])
def test_bags_per_group_keeps_eight_rows_in_flight(l, per_group):
    assert kernel.bags_per_group(l) == per_group
    assert per_group * l >= kernel.UNROLL or per_group == 1


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_int64_indices_match_int32(mode):
    """The wrapper takes SASRec's int64 ids as they are; on the CPU (the
    plain version) they give the int32 result."""
    rng = np.random.default_rng(5)
    table = torch.from_numpy(rng.normal(size=(300, 50)).astype(np.float32))
    idx = rng.integers(0, 300, size=(20, 9)).astype(np.int32)
    idx[rng.random((20, 9)) < 0.2] = -1
    w = torch.from_numpy((np.abs(rng.normal(size=(20, 9))) + 0.1)
                         .astype(np.float32))
    a = ops.embedding_bag(table, torch.from_numpy(idx), w, mode=mode)
    b = ops.embedding_bag(table, torch.from_numpy(idx.astype(np.int64)), w,
                          mode=mode)
    assert torch.equal(a, b)
