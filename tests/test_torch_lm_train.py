"""The port's LM training loss (``repro_torch.models.transformer.lm_loss``
and ``chunked_ce``) == the reference's, with the reference's
JAX-initialised parameters carried across by ``params_from_jax``: the
loss, its parts and every parameter's gradient against
``jax.value_and_grad`` for all five LM architectures at
``reduced_config`` (fp32, MoE included; loss 1e-5, gradients 1e-4 of
each tensor's scale), on the chunked and the full-logits path, with and
without per-layer remat; ``chunked_ce`` against the full logits and
against the reference's, bf16 inputs included (whose fp32 chunk
products must not be rounded to bf16: 1e-5); ``n_params`` /
``n_active_params`` for every registered LM; and ``lm_loss`` running
backward with the kernel seam on (the attention kernel refuses inputs
that require grad, so the loss must take the plain attention while
autograd records, and the kernel under ``torch.no_grad()``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.launch.train import reduced_config as ref_reduced
from repro.models import transformer as R
from repro_torch.configs import ARCHS, get_arch
from repro_torch.data import synth
from repro_torch.launch.train import reduced_config
from repro_torch.models import transformer as P
from repro_torch.models.layers import ParamTree, flatten_tree

LM_ARCHS = [a for a, s in ARCHS.items() if s.family == "lm"]


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def batch(cfg, seed=0, b=2, s=8):
    out = synth.lm_batch(np.random.default_rng(seed), cfg.vocab, b, s)
    out["labels"][0, :2] = -1                      # masked positions
    return out


def check_loss_and_grads(rcfg, pcfg, seed=0):
    rp = R.init_params(jax.random.PRNGKey(seed), rcfg)
    bt = batch(pcfg, seed)
    (lr, mr), gr = jax.jit(jax.value_and_grad(
        lambda p: R.lm_loss(p, {k: jnp.asarray(v) for k, v in bt.items()},
                            rcfg), has_aux=True))(rp)
    model = ParamTree(P.params_from_jax(np_tree(rp)))
    lp, mp = P.lm_loss(model.tree(), {k: torch.from_numpy(v)
                                      for k, v in bt.items()}, pcfg)
    lp.backward()
    np.testing.assert_allclose(float(lp.detach()), float(lr), rtol=1e-5,
                               atol=1e-5)
    for k in ("loss", "aux"):
        np.testing.assert_allclose(float(mp[k].detach()), float(mr[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    want = flatten_tree(np_tree(gr))
    got = {k: p.grad for k, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        scale = max(1e-2, float(np.abs(want[k]).max()))
        np.testing.assert_allclose(g.numpy(), want[k], rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=k)


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_lm_loss_and_grads_match_reference(arch_id):
    check_loss_and_grads(ref_reduced(ref_get_arch(arch_id)),
                         reduced_config(get_arch(arch_id)))


@pytest.mark.parametrize("arch_id,change", [
    ("gemma3-1b", dict(loss_chunks=0)),              # full logits
    ("moonshot-v1-16b-a3b", dict(remat="none")),
    ("gemma3-1b", dict(window_pattern=(3, 0), remat="none")),
])
def test_lm_loss_variants_match_reference(arch_id, change):
    check_loss_and_grads(
        dataclasses.replace(ref_reduced(ref_get_arch(arch_id)), **change),
        dataclasses.replace(reduced_config(get_arch(arch_id)), **change),
        seed=1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_ce_matches_full_logits_and_reference(dtype):
    rng = np.random.default_rng(2)
    t, d, v = 24, 16, 64
    x = rng.normal(size=(t, d)).astype(np.float32)
    table = rng.normal(size=(v, d)).astype(np.float32)
    labels = rng.integers(0, v, t).astype(np.int32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = R.chunked_ce(jnp.asarray(x, jd), jnp.asarray(table, jd),
                        jnp.asarray(labels), 4)
    xt = torch.from_numpy(x).to(td).requires_grad_()
    tt = torch.from_numpy(table).to(td).requires_grad_()
    got = P.chunked_ce(xt, tt, torch.from_numpy(labels), 4)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    # the full (T, V) logits in fp32 from the same (rounded) inputs
    lg = xt.detach().float() @ tt.detach().float().T
    full = torch.logsumexp(lg, -1) - lg[torch.arange(t), labels]
    np.testing.assert_allclose(got.detach().numpy(), full.numpy(),
                               rtol=1e-5, atol=1e-5)
    r = torch.from_numpy(rng.normal(size=t).astype(np.float32))
    torch.sum(got * r).backward()
    gx, gt = jax.grad(lambda a, b: jnp.sum(
        R.chunked_ce(a, b, jnp.asarray(labels), 4) * r.numpy()),
        argnums=(0, 1))(jnp.asarray(x, jd), jnp.asarray(table, jd))
    tol = 1e-5 if dtype == "float32" else 1e-2
    for g, w in ((xt.grad, gx), (tt.grad, gt)):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), rtol=tol,
                                   atol=tol)
    with pytest.raises(ValueError, match="multiple"):
        P.chunked_ce(xt, tt, torch.from_numpy(labels), 5)


def test_n_params_match_reference():
    for a in LM_ARCHS:
        got, want = get_arch(a).config, ref_get_arch(a).config
        assert got.n_params() == want.n_params(), a
        assert got.n_active_params() == want.n_active_params(), a
    moon = get_arch("moonshot-v1-16b-a3b").config
    assert moon.n_active_params() < moon.n_params()


@pytest.mark.parametrize("arch_id", ["gemma3-1b", "moonshot-v1-16b-a3b"])
def test_lm_loss_backward_with_the_kernel_seam_on(arch_id, monkeypatch):
    """The attention kernel's wrapper refuses inputs that require grad
    (as the CUDA wrapper does); with the seam on, lm_loss must still run
    backward, with the gradients of the seam off, and under no_grad must
    go through the kernel once per layer with the seam-off loss."""
    cfg = reduced_config(get_arch(arch_id))
    calls = []
    mha = P.fa_ops.mha

    def refusing(q, k, v, **kw):
        if any(t.requires_grad for t in (q, k, v)):
            raise ValueError("flash_attention has no backward")
        calls.append(q.shape)
        return mha(q, k, v, **kw)

    monkeypatch.setattr(P.fa_ops, "mha", refusing)
    tb = {k: torch.from_numpy(v) for k, v in batch(cfg, 3).items()}
    grads = {}
    for seam in (True, False):
        P.set_use_kernel(seam)
        try:
            model = ParamTree(P.init_params(cfg, seed=4, device="cpu"))
            loss, _ = P.lm_loss(model.tree(), tb, cfg)
            loss.backward()
            grads[seam] = {k: p.grad for k, p in model.named_parameters()}
            with torch.no_grad():
                n = len(calls)
                nograd, _ = P.lm_loss(model.tree(), tb, cfg)
                assert len(calls) - n == (cfg.n_layers if seam else 0)
            np.testing.assert_allclose(float(nograd), float(loss.detach()),
                                       rtol=1e-5)
        finally:
            P.set_use_kernel(True)
    for k, g in grads[True].items():
        torch.testing.assert_close(g, grads[False][k], rtol=0, atol=0)
