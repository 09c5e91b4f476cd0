"""The port's dense LM (``repro_torch.models.transformer``) == the
reference's (``repro.models.transformer``) for each dense architecture at
``launch.train.reduced_config`` (fp32), with the reference's
JAX-initialised parameters carried across by ``params_from_jax``:
``forward``, ``prefill`` (logits and cache) and ``decode_step`` over
several steps, at the reference smoke tests' tolerance of 2e-4
(tests/test_models_smoke.py), on the flash_attention path (the default;
on CPU tensors its plain version) and on the plain twin
(``set_use_kernel(False)``).  Also the prefill -> decode consistency
check and a gemma-like config whose window (4) is shorter than the
prompt, so that the window mask cuts in prefill and decode."""

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
from repro_torch.launch.train import reduced_config
from repro_torch.models import transformer as P

DENSE = [a for a, s in ARCHS.items()
         if s.family == "lm" and s.config.moe is None]
TOL = dict(rtol=2e-4, atol=2e-4)


def setup(arch_id, window_pattern=None, seed=0):
    rcfg = ref_reduced(ref_get_arch(arch_id))
    pcfg = reduced_config(get_arch(arch_id))
    if window_pattern is not None:
        rcfg = dataclasses.replace(rcfg, window_pattern=window_pattern)
        pcfg = dataclasses.replace(pcfg, window_pattern=window_pattern)
    rp = R.init_params(jax.random.PRNGKey(seed), rcfg)
    pp = P.params_from_jax(jax.tree_util.tree_map(np.asarray, rp))
    return rcfg, pcfg, rp, pp


def close(got, want):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               **TOL)


def test_dense_archs_and_reduced_configs_match_reference():
    assert DENSE == ["phi4-mini-3.8b", "gemma3-1b", "chatglm3-6b"]
    for a in DENSE:
        got = dataclasses.asdict(reduced_config(get_arch(a)))
        want = dataclasses.asdict(ref_reduced(ref_get_arch(a)))
        assert got == want, a
        assert dataclasses.asdict(get_arch(a).config) == \
            dataclasses.asdict(ref_get_arch(a).config)


def run_both(rcfg, pcfg, rp, pp, prompt, steps, use_kernel):
    """forward, prefill and ``steps`` greedy decode steps through both
    packages (the port fed the reference's tokens), compared each time."""
    rng = np.random.default_rng(1)
    P.set_use_kernel(use_kernel)
    try:
        toks = rng.integers(0, rcfg.vocab, (2, prompt))
        close(P.forward(pp, torch.from_numpy(toks), pcfg)[0],
              R.forward(rp, jnp.asarray(toks), rcfg)[0])
        max_len = prompt + steps
        rl, rc = R.prefill(rp, jnp.asarray(toks), rcfg, max_len=max_len)
        pl, pc = P.prefill(pp, torch.from_numpy(toks), pcfg, max_len=max_len)
        close(pl, rl)
        close(pc["k"], rc["k"])
        close(pc["v"], rc["v"])
        assert pc["len"].tolist() == np.asarray(rc["len"]).tolist()
        cur = np.array(jnp.argmax(rl[:, -1], axis=-1))[:, None]
        for _ in range(steps):
            rl, rc = R.decode_step(rp, rc, jnp.asarray(cur), rcfg)
            pl, pc = P.decode_step(pp, pc, torch.from_numpy(cur), pcfg)
            close(pl, rl)
            cur = np.array(jnp.argmax(rl[:, -1], axis=-1))[:, None]
        close(pc["k"], rc["k"])
        assert pc["len"].tolist() == np.asarray(rc["len"]).tolist()
    finally:
        P.set_use_kernel(True)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("arch_id", DENSE)
def test_forward_prefill_decode_match_reference(arch_id, use_kernel):
    rcfg, pcfg, rp, pp = setup(arch_id)
    run_both(rcfg, pcfg, rp, pp, prompt=8, steps=3, use_kernel=use_kernel)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_window_shorter_than_prompt(use_kernel):
    """gemma-like: one local layer with window 4 and one global layer, a
    12-token prompt and 6 decode steps, so the window cuts everywhere."""
    rcfg, pcfg, rp, pp = setup("gemma3-1b", window_pattern=(4, 0), seed=2)
    assert pcfg.embed_scale and list(pcfg.layer_windows()) == [4, 0]
    run_both(rcfg, pcfg, rp, pp, prompt=12, steps=6, use_kernel=use_kernel)


@pytest.mark.parametrize("arch_id", DENSE)
def test_prefill_decode_consistent(arch_id):
    """Decode after prefill must match full-sequence forward logits."""
    _, cfg, _, pp = setup(arch_id, seed=1)
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab,
                                                              (2, 8)))
    full, _ = P.forward(pp, toks, cfg)
    pre, cache = P.prefill(pp, toks[:, :-1], cfg, max_len=16)
    step, cache = P.decode_step(pp, cache, toks[:, -1:], cfg)
    np.testing.assert_allclose(pre[:, 0].numpy(), full[:, -2].numpy(), **TOL)
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, -1].numpy(),
                               **TOL)


def test_moe_and_short_cache_are_refused():
    """MoE configs are no longer refused (``models/moe.py`` is ported):
    a reduced MoE config initialises with the reference's tree; a cache
    shorter than the prompt still is."""
    cfg = reduced_config(get_arch("moonshot-v1-16b-a3b"))
    p1 = P.init_params(cfg, device="cpu")
    ref = R.init_params(jax.random.PRNGKey(0),
                        ref_reduced(ref_get_arch("moonshot-v1-16b-a3b")))
    assert jax.tree_util.tree_structure(p1) == \
        jax.tree_util.tree_structure(ref)
    _, cfg, _, pp = setup("phi4-mini-3.8b")
    with pytest.raises(ValueError, match="max_len"):
        P.prefill(pp, torch.zeros((1, 8), dtype=torch.long), cfg, max_len=4)
    p2 = P.init_params(cfg, seed=0, device="cpu")
    assert jax.tree_util.tree_structure(p2) == \
        jax.tree_util.tree_structure(pp)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_decode_past_a_full_cache(use_kernel):
    """Decode with the cache already full (max_len = prompt): the
    reference overwrites the last slot and keeps every slot valid, the
    query at its true position; so does the port on both paths."""
    rcfg, pcfg, rp, pp = setup("gemma3-1b", window_pattern=(3, 0), seed=4)
    toks = np.random.default_rng(5).integers(0, rcfg.vocab, (2, 6))
    P.set_use_kernel(use_kernel)
    try:
        rl, rc = R.prefill(rp, jnp.asarray(toks), rcfg, max_len=6)
        pl, pc = P.prefill(pp, torch.from_numpy(toks), pcfg, max_len=6)
        for t in range(3):
            cur = toks[:, t:t + 1]
            rl, rc = R.decode_step(rp, rc, jnp.asarray(cur), rcfg)
            pl, pc = P.decode_step(pp, pc, torch.from_numpy(cur), pcfg)
            close(pl, rl)
        close(pc["k"], rc["k"])
    finally:
        P.set_use_kernel(True)
