"""The port's collectives (``repro_torch.dist.collectives``) on 8 gloo
ranks, each a spawned process on the CPU, against the JAX package.

* ``moe_alltoall_block`` against the reference's ``moe_alltoall_block``,
  called outside ``with mesh:`` in a subprocess with 8 host devices (the
  reference's own ``with mesh:`` + jit tests fail on this tree's jax):
  global and
  local overflow, in and out of the overflow regime, the same ``c_dev``,
  and ``exact_c_dev``; max |err| / max |y| < 2e-4, the reference test's
  tolerance.  ``moe_alltoall_exact_c_dev`` returns the reference's
  integer, and the exact-sized dispatch equals the static one bit for
  bit.
* ``moe_block(moe_impl="a2a")`` under a mesh against the port's scatter
  path (itself bit for bit with the reference's), in and out of overflow.
* ``grad_sync`` / ``cross_pod_allreduce`` on (pod 2, data 2, model 2)
  against the reference tests' expectations, and per-rank trees against
  their fp64 mean.
* The config errors, in this process.

One spawn per mesh shape (a module fixture); the JAX subprocess runs
beside the (2, 4) spawn.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import dist
from repro_torch.dist import collectives
from repro_torch.launch.mesh import run_local
from repro_torch.models import moe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-4          # max |err| / max |y|: the reference tests' tolerance
E, D, F_, K, T = 8, 32, 16, 2, 256
# (name, overflow, capacity, c_dev, local_capacity_factor)
CASES = [("global_overflow", "global", 32, 0, 2.0),
         ("global_ample", "global", 128, 0, 2.0),
         ("global_cdev", "global", 32, 72, 2.0),
         ("local_ample", "local", None, 0, 4.0),
         ("local_overflow", "local", None, 0, 0.5)]


def inputs():
    rng = np.random.default_rng(0)
    return {"xf": rng.standard_normal((T, D), np.float32),
            "logits": rng.standard_normal((T, E), np.float32),
            "wg": 0.1 * rng.standard_normal((E, D, F_), np.float32),
            "wu": 0.1 * rng.standard_normal((E, D, F_), np.float32),
            "wd": 0.1 * rng.standard_normal((E, F_, D), np.float32)}


# The reference's functions outside ``with mesh:`` (which fails on this
# tree's jax): ``moe_alltoall_block`` jitted (called eagerly it runs op by
# op over the 8 host devices, ~18 s a call), the exact sizing pass eagerly
# (it refuses tracers).
JAX_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, {src!r})
    import numpy as np
    import jax
    import jax.numpy as jnp
    from repro.dist import collectives
    a = dict(np.load({inp!r}))
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    block = jax.jit(collectives.moe_alltoall_block, static_argnums=(5, 6),
                    static_argnames=("c_dev", "capacity", "overflow",
                                     "local_capacity_factor", "exact_c_dev"))
    out = {{}}
    args = [jnp.asarray(a[k]) for k in ("xf", "logits", "wg", "wu", "wd")]
    for name, overflow, cap, c_dev, lcf in {cases!r}:
        out[name] = np.asarray(block(
            *args, mesh, {k}, c_dev=c_dev, capacity=cap,
            overflow=overflow, local_capacity_factor=lcf))
    for cap in (32, 128):
        c = collectives.moe_alltoall_exact_c_dev(args[1], mesh, {k},
                                                 capacity=cap)
        out[f"exact_{{cap}}"] = np.asarray(c)
        out[f"y_exact_{{cap}}"] = np.asarray(block(
            *args, mesh, {k}, c_dev=c, capacity=cap, exact_c_dev=True))
    np.savez({out!r}, **out)
""")


def a2a_ranks(rank, world, a):
    """Every case on this rank: whole outputs, the exact c_dev and the
    counted collective bytes."""
    mesh = dist.make_mesh((2, 4), ("data", "model"))
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    blk = {k: dist.local_block(t[k], dist.P("model"), mesh)
           for k in ("wg", "wu", "wd")}
    args = (t["xf"], t["logits"], blk["wg"], blk["wu"], blk["wd"], mesh, K)
    out, sent = {}, {}
    for name, overflow, cap, c_dev, lcf in CASES:
        dist.reset_counts()
        out[name] = collectives.moe_alltoall_block(
            *args, c_dev=c_dev, capacity=cap, overflow=overflow,
            local_capacity_factor=lcf).numpy()
        sent[name] = dict(dist.counts)
    for cap in (32, 128):
        c = collectives.moe_alltoall_exact_c_dev(t["logits"], mesh, K,
                                                 capacity=cap)
        out[f"exact_{cap}"] = c
        out[f"y_exact_{cap}"] = collectives.moe_alltoall_block(
            *args, c_dev=c, capacity=cap, exact_c_dev=True).numpy()
        out[f"y_static_{cap}"] = collectives.moe_alltoall_block(
            *args, c_dev=0, capacity=cap).numpy()

    # moe_block: the a2a path under the mesh vs the scatter path without
    cfg = moe.MoEConfig(n_experts=8, top_k=2, d_expert=16)
    p = moe.init_moe(torch.Generator().manual_seed(0), 32, cfg,
                     dtype=torch.float32)
    x = torch.randn((4, 16, 32), generator=torch.Generator().manual_seed(1))
    blocks = moe.expert_block(p, mesh)
    for label, cf_s, cf_a in (("ample", 4.0, 8.0), ("overflow", 0.25, 0.25)):
        y_s, aux_s = moe.moe_block(
            p, x, dataclasses.replace(cfg, capacity_factor=cf_s))
        dist.set_mesh(mesh)
        try:
            y_a, aux_a = moe.moe_block(
                blocks, x, dataclasses.replace(cfg, capacity_factor=cf_a,
                                               moe_impl="a2a"))
            # whole expert weights under the mesh are refused
            try:
                moe.moe_block(p, x, dataclasses.replace(cfg,
                                                        moe_impl="a2a"))
                out[f"refused_{label}"] = False
            except ValueError as e:
                out[f"refused_{label}"] = "expert_block" in str(e)
        finally:
            dist.set_mesh(None)
        out[f"moe_{label}"] = (y_s.numpy(), y_a.numpy(), float(aux_s),
                               float(aux_a))
    out["block_rows"] = blocks["w_gate"].shape[0]
    return out, sent


def sync_ranks(rank, world):
    """grad_sync / cross_pod_allreduce on (pod 2, data 2, model 2)."""
    from repro_torch.dist.collectives import cross_pod_allreduce, grad_sync
    mesh = dist.make_mesh((2, 2, 2), ("pod", "data", "model"))
    x = torch.arange(48.0).reshape(4, 12)
    out = {
        "pod": cross_pod_allreduce(mesh, x, in_spec=dist.P("pod", None)),
        "pod_q": cross_pod_allreduce(mesh, x, compress=True,
                                     in_spec=dist.P("pod", None)),
        "ident": cross_pod_allreduce(mesh, x)}
    g = {"w": torch.arange(24.0).reshape(4, 6) / 10.0, "b": torch.ones(7)}
    out["rep"] = grad_sync(mesh, g)
    out["rep_q"] = grad_sync(mesh, g, int8_cross_pod=True)
    # a different tree on each rank: every rank gets the mean over the
    # ranks of its model coordinate (the dp group)
    own = own_tree(rank)
    dist.reset_counts()
    out["own"] = grad_sync(mesh, own)
    out["own_sent"] = dict(dist.counts)
    out["own_q"] = grad_sync(mesh, own, int8_cross_pod=True)
    out["model_coord"] = mesh.coord("model")
    return out


@pytest.fixture(scope="module")
def a2a(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("a2a")
    a = inputs()
    np.savez(tmp / "in.npz", **a)
    script = JAX_SCRIPT.format(src=os.path.join(REPO, "src"),
                               inp=str(tmp / "in.npz"),
                               out=str(tmp / "jax.npz"), cases=CASES, k=K)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", script], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        ranks = run_local(a2a_ranks, 8, "gloo", args=(a,))
    finally:
        so, se = ref.communicate(timeout=300)
    assert ref.returncode == 0, se[-3000:]
    return ranks, dict(np.load(tmp / "jax.npz"))


@pytest.fixture(scope="module")
def synced():
    return run_local(sync_ranks, 8, "gloo")


def rel(got, want) -> float:
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_a2a_matches_reference(a2a, name):
    ranks, ref = a2a
    for out, _ in ranks:          # whole on every rank, the same
        assert rel(out[name], ref[name]) < TOL, name
        np.testing.assert_array_equal(out[name], ranks[0][0][name])


def test_overflow_regime_is_real(a2a):
    """The overflow cases drop pairs: their outputs differ from the
    ample ones (global) and from each other (local)."""
    _, ref = a2a
    assert np.max(np.abs(ref["global_overflow"] - ref["global_ample"])) \
        > 1e-3
    assert np.max(np.abs(ref["local_overflow"] - ref["local_ample"])) > 1e-3


@pytest.mark.parametrize("cap", [32, 128])
def test_exact_c_dev_matches_reference(a2a, cap):
    ranks, ref = a2a
    bound = min(T // 8 * K, E // 4 * cap)
    for out, _ in ranks:
        assert out[f"exact_{cap}"] == int(ref[f"exact_{cap}"])
        assert out[f"exact_{cap}"] % 8 == 0
        assert 8 <= out[f"exact_{cap}"] <= bound
        # exact sizing never changes numerics: bit for bit
        np.testing.assert_array_equal(out[f"y_exact_{cap}"],
                                      out[f"y_static_{cap}"])
        assert rel(out[f"y_exact_{cap}"], ref[f"y_exact_{cap}"]) < TOL
    assert ranks[0][0]["exact_32"] < min(T // 8 * K, E // 4 * 32)


def test_a2a_counts_what_crosses_the_wire(a2a):
    """Per rank: the two activation all-to-alls and the expert ids at
    the static c_dev, the (E,) count gather and the output's token
    block gather; nothing else."""
    ranks, _ = a2a
    c_dev = min(T // 8 * K, E // 4 * 32)
    want = {"all_to_all@model": {"calls": 3, "bytes": 4 * c_dev * (2 * D
                                                                 + 1) * 4},
            "all_gather@data+model": {"calls": 2,
                                      "bytes": E * 4 + T // 8 * D * 4}}
    for _, sent in ranks:
        assert sent["global_overflow"] == want


@pytest.mark.parametrize("label", ["ample", "overflow"])
def test_moe_block_a2a_matches_scatter(a2a, label):
    ranks, _ = a2a
    y_s, y_a, aux_s, aux_a = ranks[0][0][f"moe_{label}"]
    assert rel(y_a, y_s) < TOL
    assert aux_a == aux_s
    assert ranks[0][0][f"refused_{label}"]
    assert ranks[0][0]["block_rows"] == 2       # 8 experts over 4 shards
    if label == "overflow":
        assert np.max(np.abs(y_s - ranks[0][0]["moe_ample"][0])) > 1e-3


def test_cross_pod_allreduce(synced):
    x = np.arange(48.0).reshape(4, 12).astype(np.float32)
    ref = np.tile(x.reshape(2, 2, 12).mean(0), (2, 1))
    for out in synced:
        np.testing.assert_allclose(out["pod"].numpy(), ref, rtol=1e-6)
        np.testing.assert_allclose(out["pod_q"].numpy(), ref, rtol=0.02,
                                   atol=0.5)
        np.testing.assert_allclose(out["ident"].numpy(), x, rtol=1e-6)


def test_grad_sync_replicated_is_identity(synced):
    w = np.arange(24.0).reshape(4, 6) / 10.0
    for out in synced:
        np.testing.assert_array_equal(out["rep"]["w"].numpy(),
                                      w.astype(np.float32))
        np.testing.assert_array_equal(out["rep"]["b"].numpy(), np.ones(7))
        np.testing.assert_allclose(out["rep_q"]["w"].numpy(), w, rtol=0.02,
                                   atol=0.02)


def test_grad_sync_means_over_the_dp_group(synced):
    """Each rank's tree differs; the result is the fp64 mean over the
    four ranks of the same model coordinate, within fp32 rounding (plain)
    and within the reference test's 0.02 (int8 across pods)."""
    nbytes = (64 * 33 + 5) * 4
    for out in synced:
        group = [r for r, o in enumerate(synced)
                 if o["model_coord"] == out["model_coord"]]
        assert len(group) == 4
        trees = [own_tree(r) for r in group]
        for leaf in (lambda t: t["w"], lambda t: t["b"][0]):
            want = np.mean([leaf(t).numpy().astype(np.float64)
                            for t in trees], axis=0)
            np.testing.assert_allclose(leaf(out["own"]).numpy(), want,
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(leaf(out["own_q"]).numpy(), want,
                                       rtol=0.02, atol=0.02)
        # one fp32 mean over 'data', one over 'pod', per leaf
        assert out["own_sent"] == {
            "psum@data": {"calls": 2, "bytes": nbytes},
            "psum@pod": {"calls": 2, "bytes": nbytes}}


def own_tree(rank):
    """Rank ``rank``'s gradient tree in ``sync_ranks``."""
    return {"w": torch.randn((64, 33), generator=torch.Generator()
                             .manual_seed(100 + rank)),
            "b": [torch.randn((5,), generator=torch.Generator()
                              .manual_seed(200 + rank))]}


class FakeMesh:
    shape = {"model": 2}
    axis_names = ("model",)


def test_config_errors():
    """overflow='global' without a capacity and unknown modes are config
    errors; the local mode's size is its formula (host math only)."""
    xf = np.zeros((8, 4), np.float32)
    with pytest.raises(ValueError, match="capacity"):
        collectives.moe_alltoall_block(
            xf, None, np.zeros((2, 4, 4)), None, None, FakeMesh(),
            top_k=1, c_dev=4, overflow="global")
    with pytest.raises(ValueError, match="overflow"):
        collectives.moe_alltoall_block(
            xf, None, np.zeros((2, 4, 4)), None, None, FakeMesh(),
            top_k=1, c_dev=4, overflow="banana")
    got = collectives.moe_alltoall_exact_c_dev(
        np.zeros((8, 4), np.float32), FakeMesh(), top_k=1,
        overflow="local", local_capacity_factor=2.0)
    assert got == 4, got
    with pytest.raises(ValueError, match="capacity"):
        collectives.moe_alltoall_exact_c_dev(np.zeros((8, 4)), FakeMesh(),
                                             top_k=1)
    with pytest.raises(ValueError, match="overflow"):
        collectives.moe_alltoall_exact_c_dev(np.zeros((8, 4)), FakeMesh(),
                                             top_k=1, overflow="banana")


def test_identity_without_a_mesh_or_dp_axis():
    g = {"w": torch.ones(3)}
    assert collectives.grad_sync(None, g) is g
    assert collectives.cross_pod_allreduce(FakeMesh(), g["w"]) is g["w"]
    x = torch.ones(4)
    assert dist.constrain(x, lambda m: dist.P("model")) is x
