"""The port's MoE FFN (``repro_torch.models.moe``) == the reference's
scatter path (``repro.models.moe``), with the reference's JAX-initialised
parameters carried across by ``params_from_jax``: ``moe_block``'s output,
aux loss and gradients in fp32 at 1e-5 (gradients 1e-4 of each tensor's
scale), with and without shared experts; the dispatch (keep mask and
slot of every (token, slot) pair) bit for bit, capacity overflow
included; tied router scores broken toward the lower expert as
``jax.lax.top_k`` breaks them; bf16 at 3e-2; and ``prefill`` /
``decode_step`` of the two reduced MoE architectures through both
packages at the dense LM tests' 2e-4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.launch.train import reduced_config as ref_reduced
from repro.models import moe as RM
from repro.models import transformer as RT
from repro_torch.configs import ARCHS, get_arch
from repro_torch.launch.train import reduced_config
from repro_torch.models import moe as PM
from repro_torch.models import transformer as PT

MOE_ARCHS = [a for a, s in ARCHS.items()
             if s.family == "lm" and s.config.moe is not None]
TOL = dict(rtol=1e-5, atol=1e-5)
# the reference's functions jitted: one compile per shape instead of one
# per primitive
ref_moe_block = jax.jit(RM.moe_block, static_argnums=2)
ref_prefill = jax.jit(RT.prefill, static_argnums=(2, 3))
ref_decode_step = jax.jit(RT.decode_step, static_argnums=3)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def setup(cfg, d=32, seed=0, dtype=jnp.float32):
    rp = RM.init_moe(jax.random.PRNGKey(seed), d, cfg, dtype)
    return rp, PT.params_from_jax(np_tree(rp))


def ref_dispatch(idx, e, c):
    """The reference's dispatch lines (``moe_block``, scatter path) on
    top-k indices ``idx`` (T, k): (pos_c, keep)."""
    expert_flat = idx.reshape(-1)
    n = expert_flat.shape[0]
    order = jnp.argsort(expert_flat)
    sorted_ids = expert_flat[order]
    starts = jnp.searchsorted(sorted_ids,
                              jnp.arange(e, dtype=sorted_ids.dtype))
    pos_sorted = jnp.arange(n, dtype=jnp.int32) - starts[sorted_ids]
    pos = jnp.zeros((n,), jnp.int32).at[order].set(pos_sorted)
    keep = pos < c
    return jnp.where(keep, pos, c), keep


def test_moe_archs_and_configs_match_reference():
    assert MOE_ARCHS == ["moonshot-v1-16b-a3b", "qwen3-moe-235b-a22b"]
    for a in MOE_ARCHS:
        assert dataclasses.asdict(get_arch(a).config) == \
            dataclasses.asdict(ref_get_arch(a).config)
        assert dataclasses.asdict(reduced_config(get_arch(a))) == \
            dataclasses.asdict(ref_reduced(ref_get_arch(a)))
        cfg = get_arch(a).config.moe
        for t in (1, 7, 64, 4096):
            assert PM.capacity(t, cfg) == RM.capacity(t, cfg)


@pytest.mark.parametrize("n_shared", [0, 2])
def test_moe_block_value_and_grads_match_reference(n_shared):
    cfg = RM.MoEConfig(n_experts=4, top_k=2, d_expert=16, n_shared=n_shared)
    rp, pp = setup(cfg)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 8, 32)).astype(np.float32)
    r = rng.normal(size=(2, 8, 32)).astype(np.float32)

    def ref_obj(p, xx):
        y, aux = RM.moe_block(p, xx, cfg)
        return jnp.sum(y * r) + 3.0 * aux, (y, aux)

    (_, (y_r, aux_r)), (gp_r, gx_r) = jax.jit(jax.value_and_grad(
        ref_obj, argnums=(0, 1), has_aux=True))(rp, jnp.asarray(x))
    leaves = {k: v.requires_grad_() for k, v in
              PT.params_from_jax(np_tree(rp)).items() if k != "shared"}
    if n_shared:
        leaves["shared"] = {k: v.requires_grad_() for k, v in
                            pp["shared"].items()}
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = PM.moe_block(leaves, xt, PM.MoEConfig(**dataclasses.asdict(cfg)))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_r), **TOL)
    np.testing.assert_allclose(float(aux.detach()), float(aux_r), **TOL)
    (torch.sum(y * torch.from_numpy(r)) + 3.0 * aux).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_r), **TOL)
    flat_r = dict(jax.tree_util.tree_leaves_with_path(np_tree(gp_r)))
    assert ("shared" in leaves) == bool(n_shared)
    for path, want in flat_r.items():
        got = leaves
        for p in path:
            got = got[p.key]
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.grad.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=str(path))


@pytest.mark.parametrize("bias", [0.0, 2.0, 8.0])
def test_dispatch_under_capacity_overflow_matches_reference(bias):
    """A router biased toward expert 0 (the tokens share a direction
    that its column is pushed along by ``bias``) overflows its capacity:
    the same pairs are kept, at the same slots, and the outputs agree."""
    cfg = RM.MoEConfig(n_experts=8, top_k=2, d_expert=8,
                       capacity_factor=1.0)
    rp, pp = setup(cfg, d=16, seed=3)
    router = np.asarray(rp["router"]).copy()
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(4, 16, 16)) + 1.0).astype(np.float32)
    router[:, 0] += 0.1 * bias
    rp = dict(rp, router=jnp.asarray(router))
    pp = dict(pp, router=torch.from_numpy(router))
    t = 4 * 16
    c = RM.capacity(t, cfg)
    probs = jax.nn.softmax(jnp.asarray(x.reshape(t, 16)) @ rp["router"])
    _, idx_r = jax.lax.top_k(probs, cfg.top_k)
    pos_r, keep_r = jax.jit(ref_dispatch, static_argnums=(1, 2))(
        idx_r, cfg.n_experts, c)
    _, idx_p = PM.top_k(torch.softmax(
        torch.from_numpy(x.reshape(t, 16)) @ pp["router"], dim=-1),
        cfg.top_k)
    np.testing.assert_array_equal(idx_p.numpy(), np.asarray(idx_r))
    pos_p, keep_p = PM.dispatch(idx_p.reshape(-1), cfg.n_experts, c)
    np.testing.assert_array_equal(keep_p.numpy(), np.asarray(keep_r))
    np.testing.assert_array_equal(pos_p.numpy(), np.asarray(pos_r))
    if bias >= 2.0:
        assert not keep_r.all()            # the case overflows
    y_r, aux_r = ref_moe_block(rp, jnp.asarray(x), cfg)
    y_p, aux_p = PM.moe_block(pp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_r), **TOL)
    np.testing.assert_allclose(float(aux_p), float(aux_r), **TOL)


def test_tied_router_scores_break_toward_the_lower_expert():
    """Equal router logits (a zero router): every token picks experts
    0..k-1 and the first tokens fill their capacity, as in the
    reference; and top_k over rows full of ties equals jax.lax.top_k."""
    rng = np.random.default_rng(5)
    vals = rng.integers(0, 3, size=(64, 16)).astype(np.float32)
    for k in (1, 3, 16):
        v_r, i_r = jax.lax.top_k(jnp.asarray(vals), k)
        v_p, i_p = PM.top_k(torch.from_numpy(vals), k)
        np.testing.assert_array_equal(i_p.numpy(), np.asarray(i_r))
        np.testing.assert_array_equal(v_p.numpy(), np.asarray(v_r))
    cfg = RM.MoEConfig(n_experts=4, top_k=2, d_expert=8)
    rp, pp = setup(cfg, d=16, seed=6)
    rp = dict(rp, router=jnp.zeros_like(rp["router"]))
    pp = dict(pp, router=torch.zeros_like(pp["router"]))
    x = rng.normal(size=(2, 24, 16)).astype(np.float32)
    y_r, aux_r = ref_moe_block(rp, jnp.asarray(x), cfg)
    y_p, aux_p = PM.moe_block(pp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_r), **TOL)
    np.testing.assert_allclose(float(aux_p), float(aux_r), **TOL)
    c = PM.capacity(48, cfg)
    _, idx = PM.top_k(torch.full((48, 4), 0.25), 2)
    assert idx.tolist() == [[0, 1]] * 48
    _, keep = PM.dispatch(idx.reshape(-1), 4, c)
    assert keep.reshape(48, 2)[:, 0].tolist() == [t < c for t in range(48)]


def test_moe_block_bf16_matches_reference():
    cfg = RM.MoEConfig(n_experts=4, top_k=2, d_expert=16, n_shared=1)
    rp, pp = setup(cfg, seed=7, dtype=jnp.bfloat16)
    assert pp["w_up"].dtype == torch.bfloat16
    x = np.random.default_rng(8).normal(size=(2, 8, 32)).astype(np.float32)
    y_r, _ = ref_moe_block(rp, jnp.asarray(x, jnp.bfloat16), cfg)
    y_p, _ = PM.moe_block(pp, torch.from_numpy(x).bfloat16(), cfg)
    assert y_p.dtype == torch.bfloat16
    np.testing.assert_allclose(y_p.float().numpy(),
                               np.asarray(y_r, np.float32), rtol=3e-2,
                               atol=3e-2)


@pytest.mark.parametrize("arch_id", MOE_ARCHS)
def test_moe_prefill_and_decode_match_reference(arch_id):
    rcfg = ref_reduced(ref_get_arch(arch_id))
    pcfg = reduced_config(get_arch(arch_id))
    rp = RT.init_params(jax.random.PRNGKey(0), rcfg)
    pp = PT.params_from_jax(np_tree(rp))
    toks = np.random.default_rng(1).integers(0, rcfg.vocab, (2, 8))
    rl, rc = ref_prefill(rp, jnp.asarray(toks), rcfg, 12)
    pl, pc = PT.prefill(pp, torch.from_numpy(toks), pcfg, max_len=12)
    np.testing.assert_allclose(pl.numpy(), np.asarray(rl), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(pc["k"].numpy(), np.asarray(rc["k"]),
                               rtol=2e-4, atol=2e-4)
    cur = np.array(jnp.argmax(rl[:, -1], axis=-1))[:, None]
    for _ in range(3):
        rl, rc = ref_decode_step(rp, rc, jnp.asarray(cur), rcfg)
        pl, pc = PT.decode_step(pp, pc, torch.from_numpy(cur), pcfg)
        np.testing.assert_allclose(pl.numpy(), np.asarray(rl), rtol=2e-4,
                                   atol=2e-4)
        cur = np.array(jnp.argmax(rl[:, -1], axis=-1))[:, None]
    assert pc["len"].tolist() == [11, 11]
