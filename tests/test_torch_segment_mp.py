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
