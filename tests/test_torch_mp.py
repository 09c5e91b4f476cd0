"""The port's message-passing seam (``repro_torch.models.mp``) == the
reference's (``repro.models.mp``) on the same numpy inputs: values,
empty segments (``jax.ops.segment_*``'s identities), the sorted flag,
and gradients, including ties of segment max/min."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mp as ref_mp
from repro_torch.models import mp

N = 12                       # segments 9..11 receive no edge


def case(seed, e=40, d=3, sort=False):
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, N - 3, e).astype(np.int32)
    src = rng.integers(0, N, e).astype(np.int32)
    if sort:
        order = np.argsort(dst, kind="stable")
        src, dst = src[order], dst[order]
    msgs = rng.normal(size=(e, d)).astype(np.float32)
    x = rng.normal(size=(N, d)).astype(np.float32)
    return msgs, x, src, dst


T = torch.from_numpy
J = jnp.asarray


@pytest.mark.parametrize("name", ["scatter_sum", "scatter_mean",
                                  "scatter_max", "scatter_min"])
@pytest.mark.parametrize("sort", [False, True])
def test_scatters_match_reference(name, sort):
    msgs, _, _, dst = case(1, sort=sort)
    want = np.asarray(getattr(ref_mp, name)(J(msgs), J(dst), N,
                                            sorted_ids=sort))
    got = getattr(mp, name)(T(msgs), T(dst), N, sorted_ids=sort).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # the empty segments hold the reference's identities (+-inf, 0)
    np.testing.assert_array_equal(got[N - 3:], want[N - 3:])


def test_empty_segment_identities_and_int_dtype():
    msgs = T(np.arange(6, dtype=np.int32).reshape(3, 2))
    dst = T(np.array([0, 0, 2], np.int32))
    for name in ("scatter_max", "scatter_min"):
        want = np.asarray(getattr(ref_mp, name)(J(msgs.numpy()),
                                                J(dst.numpy()), 4))
        got = getattr(mp, name)(msgs, dst, 4).numpy()
        np.testing.assert_array_equal(got, want)
    got = mp.scatter_max(T(np.zeros((0, 2), np.float32)),
                         T(np.zeros(0, np.int32)), 3).numpy()
    assert np.all(got == -np.inf) and got.shape == (3, 2)


@pytest.mark.parametrize("sort", [False, True])
def test_gather_degree_softmax_propagate(sort):
    msgs, x, src, dst = case(2, sort=sort)
    np.testing.assert_array_equal(mp.gather_src(T(x), T(src)).numpy(),
                                  np.asarray(ref_mp.gather_src(J(x), J(src))))
    np.testing.assert_array_equal(
        mp.degree(T(dst), N, sorted_ids=sort).numpy(),
        np.asarray(ref_mp.degree(J(dst), N, sorted_ids=sort)))
    for lg in (msgs[:, 0], msgs):          # (E,) and per-head (E, H)
        want = np.asarray(jax.vmap(
            lambda c: ref_mp.segment_softmax(c, J(dst), N, sort),
            in_axes=-1, out_axes=-1)(J(lg.reshape(len(lg), -1))))
        got = mp.segment_softmax(T(lg), T(dst), N, sorted_ids=sort).numpy()
        np.testing.assert_allclose(got.reshape(want.shape), want,
                                   rtol=1e-6, atol=1e-7)
    w = np.random.default_rng(3).normal(size=(3, 5)).astype(np.float32)
    want = np.asarray(ref_mp.propagate_matmul(J(x), J(w), J(src), J(dst), N,
                                              dst_sorted=sort))
    got = mp.propagate_matmul(T(x), T(w), T(src), T(dst), N,
                              dst_sorted=sort).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_sorted_module_default():
    assert not mp._sorted(False)
    mp.set_sorted_indices(True)
    try:
        assert mp._sorted(False)
    finally:
        mp.set_sorted_indices(False)
    assert mp._sorted(True) and not mp._sorted(False)


@pytest.mark.parametrize("name", ["scatter_max", "scatter_min",
                                  "scatter_mean", "scatter_sum"])
def test_gradients_match_reference_with_ties(name):
    """d(sum(out * g))/d msgs agrees, including tied maxima/minima (both
    frameworks split the gradient evenly between ties) and messages into
    segments that are otherwise empty."""
    rng = np.random.default_rng(4)
    msgs = rng.integers(0, 3, size=(30, 2)).astype(np.float32)   # ties
    dst = rng.integers(0, N - 3, 30).astype(np.int32)
    g = rng.normal(size=(N, 2)).astype(np.float32)

    def ref_obj(m):
        out = getattr(ref_mp, name)(m, J(dst), N)
        return jnp.sum(jnp.where(jnp.isfinite(out), out, 0.0) * J(g))

    want = np.asarray(jax.grad(ref_obj)(J(msgs)))
    tm = T(msgs).requires_grad_()
    out = getattr(mp, name)(tm, T(dst), N)
    torch.sum(torch.where(torch.isfinite(out), out, 0.0) * T(g)).backward()
    np.testing.assert_allclose(tm.grad.numpy(), want, rtol=1e-6, atol=1e-6)


def test_segment_softmax_gradient_matches_reference():
    msgs, _, _, dst = case(5)
    lg = msgs[:, :2]
    g = np.random.default_rng(6).normal(size=lg.shape).astype(np.float32)
    want = np.asarray(jax.grad(lambda z: jnp.sum(jax.vmap(
        lambda c: ref_mp.segment_softmax(c, J(dst), N), in_axes=1,
        out_axes=1)(z) * J(g)))(J(lg)))
    t = T(lg).requires_grad_()
    torch.sum(mp.segment_softmax(t, T(dst), N) * T(g)).backward()
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-5, atol=1e-6)
