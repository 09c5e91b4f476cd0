"""The port's transformer building blocks (``repro_torch.models.layers``)
== the reference's (``repro.models.layers``) at 1e-5 in fp32, from the
same numpy inputs: RMSNorm (gemma's 1 + scale), LayerNorm, RoPE (full
and ChatGLM's half rotary), GQA attention (causal, window, non-causal),
``attn_qkv`` with and without QKV bias, the self-attention and one-token
decode blocks (decode writes the cache and masks unwritten slots), the
gated SiLU MLP, and embed / unembed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as R
from repro_torch.models import layers as P

TOL = dict(rtol=1e-5, atol=1e-5)
RNG = np.random.default_rng(0)


def n(*shape):
    return RNG.normal(size=shape).astype(np.float32)


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def test_norms():
    x, s, b = n(3, 5, 16), n(16), n(16)
    close(P.rms_norm(torch.from_numpy(x), torch.from_numpy(s)),
          R.rms_norm(jnp.asarray(x), jnp.asarray(s)))
    close(P.layer_norm(torch.from_numpy(x), torch.from_numpy(s),
                       torch.from_numpy(b)),
          R.layer_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b)))


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_rope(fraction):
    x = n(2, 7, 3, 16)
    pos = np.tile(np.arange(7, dtype=np.int32) + 3, (2, 1))
    close(P.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4,
                       fraction),
          R.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4, fraction))
    np.testing.assert_array_equal(P.rope_freqs(8), R.rope_freqs(8))


@pytest.mark.parametrize("causal,window,hq,hkv", [
    (True, None, 4, 2), (True, 3, 4, 1), (False, None, 2, 2),
    (False, 4, 6, 3)])
def test_attention(causal, window, hq, hkv):
    b, sq, sk, d = 2, 6, 9, 8
    q, k, v = n(b, sq, hq, d), n(b, sk, hkv, d), n(b, sk, hkv, d)
    qp = np.tile(np.arange(sq, dtype=np.int32) + sk - sq, (b, 1))
    kp = np.tile(np.arange(sk, dtype=np.int32), (b, 1))
    got = P.attention(*(torch.from_numpy(a) for a in (q, k, v, qp, kp)),
                      causal=causal, window=window)
    want = R.attention(*(jnp.asarray(a) for a in (q, k, v, qp, kp)),
                       causal=causal, window=window)
    close(got, want)


def params(cfg, bias):
    """Attention weights at the reference's init scale, 1/sqrt(d_model)."""
    s = np.float32(1.0 / np.sqrt(cfg.d_model))
    p = {"wq": n(cfg.d_model, cfg.n_heads * cfg.d_head) * s,
         "wk": n(cfg.d_model, cfg.n_kv * cfg.d_head) * s,
         "wv": n(cfg.d_model, cfg.n_kv * cfg.d_head) * s,
         "wo": n(cfg.n_heads * cfg.d_head, cfg.d_model) * s}
    if bias:
        p.update(bq=n(cfg.n_heads * cfg.d_head), bk=n(cfg.n_kv * cfg.d_head),
                 bv=n(cfg.n_kv * cfg.d_head))
    return p


@pytest.mark.parametrize("bias,fraction,window", [(False, 1.0, None),
                                                  (True, 0.5, 3)])
def test_attention_blocks(bias, fraction, window):
    kw = dict(d_model=16, n_heads=4, n_kv=2, d_head=8, rope_fraction=fraction,
              qkv_bias=bias)
    rc, pc = R.AttnConfig(**kw), P.AttnConfig(**kw)
    p = params(rc, bias)
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    x = n(2, 5, 16)
    pos = np.tile(np.arange(5, dtype=np.int32), (2, 1))
    for g, w in zip(P.attn_qkv(pt, torch.from_numpy(x), pc,
                               torch.from_numpy(pos)),
                    R.attn_qkv(pj, jnp.asarray(x), rc, jnp.asarray(pos))):
        close(g, w)
    close(P.self_attention_block(pt, torch.from_numpy(x), pc,
                                 torch.from_numpy(pos), window=window),
          R.self_attention_block(pj, jnp.asarray(x), rc, jnp.asarray(pos),
                                 window=window))
    # one decode step over a cache of 8 slots with rows at lengths 3 and 5
    kc, vc = n(2, 8, 2, 8), n(2, 8, 2, 8)
    lens = np.array([3, 5], np.int32)
    xt = n(2, 1, 16)
    want = R.decode_attention_block(pj, jnp.asarray(xt), rc, jnp.asarray(kc),
                                    jnp.asarray(vc), jnp.asarray(lens),
                                    window=window)
    got = P.decode_attention_block(pt, torch.from_numpy(xt), pc,
                                   torch.from_numpy(kc.copy()),
                                   torch.from_numpy(vc.copy()),
                                   torch.from_numpy(lens), window=window)
    for g, w in zip(got, want):
        close(g, w)


def test_mlp_and_embedding():
    p = {"w_up": n(16, 32), "w_gate": n(16, 32), "w_down": n(32, 16)}
    x = n(2, 3, 16)
    close(P.mlp_block({k: torch.from_numpy(v) for k, v in p.items()},
                      torch.from_numpy(x)),
          R.mlp_block({k: jnp.asarray(v) for k, v in p.items()},
                      jnp.asarray(x)), rtol=1e-5, atol=1e-4)
    ungated = {k: v for k, v in p.items() if k != "w_gate"}
    close(P.mlp_block({k: torch.from_numpy(v) for k, v in ungated.items()},
                      torch.from_numpy(x)),
          R.mlp_block({k: jnp.asarray(v) for k, v in ungated.items()},
                      jnp.asarray(x)), rtol=1e-5, atol=1e-4)
    table = n(50, 16)
    toks = RNG.integers(0, 50, (2, 7))
    close(P.embed({"table": torch.from_numpy(table)}, torch.from_numpy(toks)),
          R.embed({"table": jnp.asarray(table)}, jnp.asarray(toks)))
    close(P.unembed({"table": torch.from_numpy(table)}, torch.from_numpy(x)),
          R.unembed({"table": jnp.asarray(table)}, jnp.asarray(x)))
