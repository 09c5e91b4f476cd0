"""Gradients through the port's expert-parallel all-to-all
(``moe_block(moe_impl="a2a")`` under a mesh) on gloo ranks, each a
spawned process on the CPU.

* On 4 ranks (model 4) and 8 ranks (data 2, model 4), 8 experts, top-2,
  d 32, d_expert 16, fp32: the a2a path's value, aux loss and gradients
  (x, the router, each rank's block of every expert weight) against the
  port's scatter path in one process, in and out of overflow: max |err|
  / max |want| < 2e-4 per tensor (the reference tests' tolerance).
* The scatter path's gradients against ``jax.grad`` of the reference's
  ``moe_block`` on the same numpy inputs, in a subprocess (outside
  ``with mesh:``, which fails on this tree's jax), at 1e-4 of each
  tensor's scale (``tests/test_torch_moe.py``'s tolerance).
* The ``shard_map`` boundary's transposes on (data 2, model 4): inputs
  and outputs that leave mesh axes unnamed, a held block, and a body
  ``all_gather``, against the same function written without ranks.
* One ``Trainer`` step of a 2-layer MoE LM under the (data 2, model 4)
  mesh against the single-process step: loss, the clipped gradient's
  norm (the whole tree's, over the blocks ``local_params`` recorded in
  ``mesh.held``) and every tensor's first Adam moment,
  the expert blocks against the matching slices, at 2e-4 of each
  tensor's largest value.  The port's form of the reference's
  ``test_lm_train_step_lowers_on_8dev_mesh``.
* ``psum`` / ``pmax`` / ``pmean`` raise while autograd records through
  them; the backward's collectives are counted under ``op.bwd``.
"""

import os
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import dist
from repro_torch.launch.mesh import run_local
from repro_torch.models import moe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-4          # max |err| / max |want| per tensor
E, D, F_, K = 8, 32, 16, 2
B, S = 4, 16        # 64 tokens: 16 per rank on 4, 8 on 8
CASES = (("ample", 8.0), ("overflow", 0.5))
MESHES = {4: ((4,), ("model",)), 8: ((2, 4), ("data", "model"))}
NAMES = ("router", "w_gate", "w_up", "w_down")


def inputs():
    rng = np.random.default_rng(0)
    return {"x": rng.standard_normal((B, S, D), np.float32),
            "cot": rng.standard_normal((B, S, D), np.float32),
            "router": rng.standard_normal((D, E), np.float32)
            / np.float32(np.sqrt(D)),
            "w_gate": 0.2 * rng.standard_normal((E, D, F_), np.float32),
            "w_up": 0.2 * rng.standard_normal((E, D, F_), np.float32),
            "w_down": 0.2 * rng.standard_normal((E, F_, D), np.float32)}


def objective(p, x, cot, cf, impl):
    """sum(y * cot) + aux: the value, aux and gradients of x and ``p``."""
    cfg = moe.MoEConfig(n_experts=E, top_k=K, d_expert=F_,
                        capacity_factor=cf, moe_impl=impl)
    leaves = {k: v.detach().clone().requires_grad_() for k, v in p.items()}
    xt = x.detach().clone().requires_grad_()
    y, aux = moe.moe_block(leaves, xt, cfg)
    grads = torch.autograd.grad(torch.sum(y * cot) + aux,
                                [xt] + [leaves[k] for k in NAMES])
    return {"y": y.detach().numpy(), "aux": float(aux.detach()),
            "grads": dict(zip(("x",) + NAMES,
                              (g.numpy() for g in grads)))}


def grad_ranks(rank, world, a):
    """The a2a objective on this rank's expert blocks, per case, with the
    collective counts of its forward and backward."""
    mesh = dist.make_mesh(*MESHES[world])
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    blocks = moe.expert_block({k: t[k] for k in NAMES}, mesh)
    out = {"lo": mesh.coord("model") * (E // 4)}
    dist.set_mesh(mesh)
    try:
        for label, cf in CASES:
            dist.reset_counts()
            out[label] = objective(blocks, t["x"], t["cot"], cf, "a2a")
            out[label]["sent"] = dict(dist.counts)
        raised = {}
        for name, fn in (("psum", dist.psum), ("pmax", dist.pmax),
                         ("pmean", dist.pmean)):
            body = dist.shard_map(lambda v, f=fn: f(v, "model"), mesh=mesh,
                                  in_specs=(dist.P(),), out_specs=dist.P())
            try:
                body(torch.ones(3, requires_grad=True))
                raised[name] = False
            except RuntimeError as e:
                raised[name] = "no backward" in str(e)
            with torch.no_grad():       # and runs where nothing records
                raised[name + "_no_grad"] = float(body(torch.ones(3))[0])
        out["raised"] = raised
    finally:
        dist.set_mesh(None)
    return out


SX, SW = (16, 3), (4, 3)


def boundary_inputs():
    rng = np.random.default_rng(3)
    return {k: rng.standard_normal(s, np.float32) for k, s in
            (("x", SX), ("w", SW), ("c1", (16, 1)), ("c2", SW),
             ("c3", SX), ("h", (1, 3)))}


def boundary_ranks(rank, world, a):
    """Three shard_maps on (data 2, model 4): x's rows over (data,
    model) and w's over model (unnamed data), a replicated-over-data
    output, a held block of h (unnamed data), and a body all_gather."""
    mesh = dist.make_mesh((2, 4), ("data", "model"))
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    x = t["x"].clone().requires_grad_()
    w = t["w"].clone().requires_grad_()
    h = t["h"].clone().requires_grad_()      # each rank's held (1, 3)
    tok, mod = dist.P(("data", "model")), dist.P("model")
    y = dist.shard_map(lambda xb, wb, hb: xb @ (wb + hb).T, mesh=mesh,
                       in_specs=(tok, mod, dist.Held(dist.P())),
                       out_specs=tok)(x, w, h)
    z = dist.shard_map(lambda wb: 2.0 * wb, mesh=mesh, in_specs=(mod,),
                       out_specs=mod)(w)
    g = dist.shard_map(lambda xb: dist.all_gather(xb, "model").sum(0) * xb,
                       mesh=mesh, in_specs=(tok,), out_specs=tok)(x)
    loss = (torch.sum(y * t["c1"]) + torch.sum(z * t["c2"])
            + torch.sum(g * t["c3"]))
    dist.reset_counts()
    gx, gw, gh = torch.autograd.grad(loss, [x, w, h])
    return {"loss": float(loss.detach()), "gx": gx.numpy(), "gw": gw.numpy(),
            "gh": gh.numpy(), "sent": dict(dist.counts)}


def boundary_plain(a):
    """The same loss written without ranks: rank (d, m) holds rows 2r,
    2r + 1 (r = 4d + m) and w's row m."""
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    x = t["x"].clone().requires_grad_()
    w = t["w"].clone().requires_grad_()
    h = t["h"].clone().requires_grad_()
    m = torch.arange(16) // 2 % 4                      # model coord per row
    d = torch.arange(16) // 8                          # data coord per row
    y = torch.sum(x * (w[m] + h), dim=1, keepdim=True)
    z = 2.0 * w
    group = torch.stack([x[(d == dd) & (torch.arange(16) % 2 == j)].sum(0)
                         for dd in (0, 1) for j in (0, 1)]).reshape(2, 2, 3)
    g = group[d, torch.arange(16) % 2] * x
    loss = (torch.sum(y * t["c1"]) + torch.sum(z * t["c2"])
            + torch.sum(g * t["c3"]))
    gx, gw, gh = torch.autograd.grad(loss, [x, w, h])
    return {"loss": float(loss.detach()), "gx": gx.numpy(), "gw": gw.numpy(),
            "gh": gh.numpy()}


# ------------------------------------------------------------ Trainer step
def lm_cfg(impl: str):
    from repro_torch.models.transformer import LMConfig
    return LMConfig(name="moe-tiny", n_layers=2, d_model=D, n_heads=4,
                    n_kv=2, d_head=8, d_ff=64, vocab=128,
                    moe=moe.MoEConfig(n_experts=E, top_k=K, d_expert=F_,
                                      n_shared=1, capacity_factor=1.0,
                                      moe_impl=impl),
                    dtype="float32", loss_chunks=4)


def lm_batch():
    toks = np.random.default_rng(5).integers(0, 128, (2, 16))
    return {"tokens": toks.astype(np.int32), "labels": toks.astype(np.int32)}


OPT = dict(lr=1e-3, warmup_steps=1, total_steps=4, clip_norm=0.1)


def trainer_step(cfg, mesh, ckpt_dir):
    """One step of ``Trainer.fit`` (an iterator of one batch, so no
    checkpoint): loss, grad norm and the first moments, by name."""
    from repro_torch.models import transformer
    from repro_torch.models.layers import ParamTree
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    params = transformer.init_params(cfg, seed=0, device="cpu")
    model = ParamTree(transformer.local_params(params, cfg, mesh))
    tr = Trainer(lambda mm, b: transformer.lm_loss(mm.tree(), b, cfg),
                 model, AdamWConfig(**OPT),
                 TrainerConfig(total_steps=10, ckpt_dir=ckpt_dir))
    try:
        tr.fit(iter([lm_batch()]))
    except StopIteration:
        pass
    return {"loss": tr.history[-1]["loss"],
            "grad_norm": float(tr.last_metrics["grad_norm"]),
            "mu": {k: v.numpy() for k, v in tr.opt_state.mu.items()},
            "held": sorted(mesh.held) if mesh is not None else []}


def trainer_ranks(rank, world, ckpt_root):
    mesh = dist.make_mesh((2, 4), ("data", "model"))
    dist.set_mesh(mesh)
    try:
        out = trainer_step(lm_cfg("a2a"), mesh,
                           os.path.join(ckpt_root, f"rank{rank}"))
    finally:
        dist.set_mesh(None)
    out["lo"] = mesh.coord("model") * (E // 4)
    return out


# --------------------------------------------------------------- fixtures
JAX_SCRIPT = textwrap.dedent("""
    import sys
    sys.path.insert(0, {src!r})
    import numpy as np
    import jax
    import jax.numpy as jnp
    from repro.models import moe as RM
    a = dict(np.load({inp!r}))
    out = {{}}
    for label, cf in {cases!r}:
        cfg = RM.MoEConfig(n_experts={e}, top_k={k}, d_expert={f},
                           capacity_factor=cf)

        def obj(p, x):
            y, aux = RM.moe_block(p, x, cfg)
            return jnp.sum(y * a["cot"]) + aux

        p = {{k: jnp.asarray(a[k]) for k in {names!r}}}
        gp, gx = jax.jit(jax.grad(obj, argnums=(0, 1)))(p, jnp.asarray(a["x"]))
        out[label + "/x"] = np.asarray(gx)
        for k in {names!r}:
            out[label + "/" + k] = np.asarray(gp[k])
    np.savez({out!r}, **out)
""")


@pytest.fixture(scope="module")
def grads():
    a = inputs()
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    plain = {label: objective({k: t[k] for k in NAMES}, t["x"], t["cot"],
                              cf, "scatter") for label, cf in CASES}
    with tempfile.TemporaryDirectory() as tmp:
        inp, outp = os.path.join(tmp, "in.npz"), os.path.join(tmp, "ref.npz")
        np.savez(inp, **a)
        ref = subprocess.Popen(
            [sys.executable, "-c", JAX_SCRIPT.format(
                src=os.path.join(REPO, "src"), inp=inp, out=outp,
                cases=CASES, e=E, k=K, f=F_, names=NAMES)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=dict(os.environ, JAX_PLATFORMS="cpu"))
        try:
            ranks = {w: run_local(grad_ranks, w, "gloo", args=(a,))
                     for w in MESHES}
        finally:
            _, err = ref.communicate(timeout=300)
        assert ref.returncode == 0, err[-3000:]
        jax_grads = dict(np.load(outp))
    return plain, ranks, jax_grads


def rel(got, want) -> float:
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12))


@pytest.mark.parametrize("world", sorted(MESHES))
@pytest.mark.parametrize("label", [c[0] for c in CASES])
def test_a2a_gradients_match_scatter(grads, world, label):
    plain, ranks, _ = grads
    want = plain[label]
    for out in ranks[world]:
        got = out[label]
        assert rel(got["y"], want["y"]) < TOL
        assert got["aux"] == pytest.approx(want["aux"], rel=1e-6)
        for k in ("x", "router"):
            assert rel(got["grads"][k], want["grads"][k]) < TOL, k
        lo = out["lo"]
        for k in NAMES[1:]:
            # this rank's block against the matching slice
            assert got["grads"][k].shape[0] == E // 4
            assert rel(got["grads"][k],
                       want["grads"][k][lo:lo + E // 4]) < TOL, k


def test_overflow_drops_pairs(grads):
    """The overflow case is a real one: its output and its expert
    gradients differ from the ample case's."""
    plain, _, _ = grads
    assert rel(plain["overflow"]["y"], plain["ample"]["y"]) > 1e-2
    assert rel(plain["overflow"]["grads"]["w_up"],
               plain["ample"]["grads"]["w_up"]) > 1e-2


@pytest.mark.parametrize("label", [c[0] for c in CASES])
def test_scatter_gradients_match_jax(grads, label):
    plain, _, ref = grads
    for k in ("x",) + NAMES:
        want = ref[f"{label}/{k}"]
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(plain[label]["grads"][k], want,
                                   rtol=1e-4, atol=1e-4 * scale, err_msg=k)


def test_backward_counts_its_wire(grads):
    """Per rank on (data 2, model 4), static c_dev: the forward's three
    all-to-alls and two gathers, and in the backward the two activation
    all-to-alls once more, the two whole inputs' gathers (x and the
    router logits) and the held expert blocks' psum over data."""
    _, ranks, _ = grads
    t_loc = B * S // 8
    cap = moe.capacity(B * S, moe.MoEConfig(E, K, F_, capacity_factor=0.5))
    c_dev = min(t_loc * K, E // 4 * cap)
    slab = 4 * c_dev * D * 4
    blocks = 2 * (2 * D * F_ + F_ * D) * 4
    want = {"all_to_all@model": {"calls": 3, "bytes": 2 * slab
                                 + 4 * c_dev * 4},
            "all_gather@data+model": {"calls": 2,
                                      "bytes": E * 4 + t_loc * D * 4},
            "all_to_all.bwd@model": {"calls": 2, "bytes": 2 * slab},
            "all_gather.bwd@data+model": {"calls": 2,
                                          "bytes": t_loc * (D + E) * 4},
            "psum.bwd@data": {"calls": 3, "bytes": blocks}}
    for out in ranks[8]:
        assert out["overflow"]["sent"] == want


def test_psum_family_raises_under_autograd(grads):
    _, ranks, _ = grads
    for out in ranks[4] + ranks[8]:
        for name in ("psum", "pmax", "pmean"):
            assert out["raised"][name], name
        assert out["raised"]["psum_no_grad"] == 4.0
        assert out["raised"]["pmax_no_grad"] == 1.0
        assert out["raised"]["pmean_no_grad"] == 1.0


def test_shard_map_boundary_transposes():
    a = boundary_inputs()
    want = boundary_plain(a)
    ranks = run_local(boundary_ranks, 8, "gloo", args=(a,))
    for out in ranks:
        assert out["loss"] == pytest.approx(want["loss"], rel=1e-6)
        for k in ("gx", "gw", "gh"):
            np.testing.assert_allclose(out[k], want[k], rtol=1e-5,
                                       atol=1e-5, err_msg=k)
        # x's block (2, 3) in two shard_maps; w's row (1, 3) in two,
        # summed over data first; h over every rank; the body gather's
        # (4, 2, 3) cotangent reduced and scattered over model
        assert out["sent"] == {
            "all_gather.bwd@data+model": {"calls": 2, "bytes": 2 * 24},
            "psum.bwd@data": {"calls": 2, "bytes": 2 * 12},
            "all_gather.bwd@model": {"calls": 2, "bytes": 2 * 12},
            "psum.bwd@data+model": {"calls": 1, "bytes": 12},
            "psum_scatter.bwd@model": {"calls": 1, "bytes": 96}}


def test_trainer_step_under_mesh_matches_single_process():
    cfg = lm_cfg("a2a")
    with tempfile.TemporaryDirectory() as tmp:
        want = trainer_step(cfg, None, os.path.join(tmp, "single"))
        ranks = run_local(trainer_ranks, 8, "gloo", args=(tmp,))
    assert want["held"] == []
    assert want["grad_norm"] > OPT["clip_norm"]        # the clip acts
    for out in ranks:
        assert out["held"] == ["layers.moe.w_down", "layers.moe.w_gate",
                               "layers.moe.w_up"]
        assert out["loss"] == pytest.approx(want["loss"], rel=1e-6)
        assert out["grad_norm"] == pytest.approx(want["grad_norm"],
                                                 rel=1e-5)
        assert sorted(out["mu"]) == sorted(want["mu"])
        lo = out["lo"]
        for k, got in out["mu"].items():
            w = want["mu"][k]
            if k.startswith("layers.moe.w_"):
                w = w[:, lo:lo + E // 4]
            assert got.shape == w.shape, k
            assert rel(got, w) < TOL, k
