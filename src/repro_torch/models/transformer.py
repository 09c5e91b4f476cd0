"""Decoder-only LM (dense) with GQA, RoPE variants, sliding-window/global
mixes and KV-cache decode: the serving side of the reference's
``models/transformer.py`` (``forward``, ``prefill``, ``decode_step``) for
the three dense LM architectures (phi4-mini, gemma3, chatglm3).

Parameters are the reference's pytree as a dict of tensors, layer
parameters stacked on a leading (n_layers,) dim; ``jax.lax.scan`` over
layers becomes a Python loop.  ``dist.constrain`` is the identity
without a mesh and is dropped; ``decode_attn="splitk"`` needs a mesh, so
decode takes ``_decode_attn`` as the reference does without one.  MoE
layers (``models/moe.py``), ``lm_loss`` and ``chunked_ce`` come with the
training slice of the port.

Attention goes through the flash_attention kernel (``kernels/
flash_attention``: CUDA tensors launch it, CPU tensors take its plain
version) while :func:`set_use_kernel` is on, the default.  Off, it runs
the reference's own attention math (``_windowed_attention``,
``_decode_attn``) on any device: the plain twin that tests and
``chip_smoke.py`` hold the kernel path against.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.analytics import check_device
from repro_torch.kernels.flash_attention import ops as fa_ops

from .layers import (NEG_INF, AttnConfig, _repeat_kv, attn_qkv, embed,
                     init_attn, init_embedding, init_mlp, mlp_block,
                     params_from_jax, rms_norm, unembed, write_cache)

Param = dict

__all__ = ["LMConfig", "decode_step", "forward", "forward_features",
           "init_cache", "init_params", "params_from_jax", "prefill",
           "set_use_kernel"]

_USE_KERNEL = True


def set_use_kernel(flag: bool) -> None:
    """Route attention through the flash_attention kernel (the default), or
    through the reference's plain attention math when off."""
    global _USE_KERNEL
    _USE_KERNEL = flag


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_head: int
    d_ff: int
    vocab: int
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0
    qkv_bias: bool = False
    # cycle of per-layer windows; 0 = global attention.  gemma3 uses
    # (512,)*5 + (0,) i.e. 5 local : 1 global.
    window_pattern: Tuple[int, ...] = (0,)
    moe: Optional[Any] = None          # MoE layers: a later slice
    tie_embeddings: bool = True
    embed_scale: bool = False          # gemma multiplies embeddings by sqrt(d)
    aux_loss_weight: float = 0.01
    remat: str = "layer"
    loss_chunks: int = 16
    decode_attn: str = "gather"        # "splitk" needs a mesh (a later slice)
    dtype: str = "bfloat16"

    @property
    def attn(self) -> AttnConfig:
        return AttnConfig(self.d_model, self.n_heads, self.n_kv, self.d_head,
                          self.rope_theta, self.rope_fraction, self.qkv_bias)

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def layer_windows(self) -> np.ndarray:
        pat = self.window_pattern
        return np.asarray([pat[i % len(pat)] for i in range(self.n_layers)],
                          dtype=np.int32)


def _dense_only(cfg: LMConfig) -> None:
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers (models/moe.py) are not ported yet; "
            f"they come with the LM training slice")


# --------------------------------------------------------------------- init
def init_layer(gen: torch.Generator, cfg: LMConfig, device) -> Param:
    dt = cfg.tdtype
    return {
        "attn": init_attn(gen, cfg.attn, dt, device),
        "ln_attn": torch.zeros((cfg.d_model,), dtype=dt, device=device),
        "ln_mlp": torch.zeros((cfg.d_model,), dtype=dt, device=device),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, gated=True, dtype=dt,
                        device=device),
    }


def _stack(trees: list) -> Param:
    return {k: _stack([t[k] for t in trees]) if isinstance(v, dict)
            else torch.stack([t[k] for t in trees])
            for k, v in trees[0].items()}


def init_params(cfg: LMConfig, seed: int = 0, device="cuda") -> Param:
    """Random parameters on ``device`` from a ``torch.Generator`` seeded
    with ``seed`` (the reference's distributions, not its random bits)."""
    _dense_only(cfg)
    check_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    p = {
        "embed": init_embedding(gen, cfg.vocab, cfg.d_model, cfg.tdtype,
                                device),
        "layers": _stack([init_layer(gen, cfg, device)
                          for _ in range(cfg.n_layers)]),
        "ln_f": torch.zeros((cfg.d_model,), dtype=cfg.tdtype, device=device),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = init_embedding(gen, cfg.vocab, cfg.d_model,
                                      cfg.tdtype, device)
    return p


def _layer(params: Param, i: int) -> Param:
    """Layer ``i``'s parameters: views into the stacked tensors."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in params.items()}


# ------------------------------------------------------------------ forward
def _windowed_attention(q, k, v, positions, window: int):
    """Causal attention with a per-layer window (0 = global): the
    reference's plain math."""
    b, sq, hq, d = q.shape
    n_rep = hq // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    scale = 1.0 / np.sqrt(d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    dq = positions[:, :, None]
    dk = positions[:, None, :]
    mask = dk <= dq
    if window > 0:
        mask = mask & (dq - dk < window)
    logits = torch.where(mask[:, None, :, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _attend(q, k, v, positions, window: int):
    """Causal self-attention over one prompt (positions 0..S-1) with the
    layer's window (0 = global)."""
    if _USE_KERNEL:
        return fa_ops.mha(q, k, v, causal=True, window=int(window) or None)
    return _windowed_attention(q, k, v, positions, int(window))


def _embed(params: Param, tokens: torch.Tensor, cfg: LMConfig):
    x = embed(params["embed"], tokens)
    if cfg.embed_scale:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def _layers(params: Param, cfg: LMConfig, x, positions, kv_out=None):
    """Every layer over a whole prompt; with ``kv_out`` = (k_cache,
    v_cache), each layer's K/V also go into its cache slots [0, S)."""
    b, s, _ = x.shape
    for i, window in enumerate(cfg.layer_windows()):
        lp = _layer(params["layers"], i)
        h = rms_norm(x, lp["ln_attn"])
        q, k, v = attn_qkv(lp["attn"], h, cfg.attn, positions)
        o = _attend(q, k, v, positions, window)
        x = x + o.reshape(b, s, -1) @ lp["attn"]["wo"]
        h = rms_norm(x, lp["ln_mlp"])
        x = x + mlp_block(lp["mlp"], h)
        if kv_out is not None:
            kv_out[0][i, :, :s] = k
            kv_out[1][i, :, :s] = v
    return x


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None, :] \
        .expand(b, s)


def forward_features(params: Param, tokens: torch.Tensor, cfg: LMConfig):
    """tokens (B, S) -> final hidden states (B, S, d), plus MoE aux (0)."""
    _dense_only(cfg)
    b, s = tokens.shape
    x = _embed(params, tokens, cfg)
    x = _layers(params, cfg, x, _positions(b, s, x.device))
    x = rms_norm(x, params["ln_f"])
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def forward(params: Param, tokens: torch.Tensor, cfg: LMConfig):
    """tokens (B, S) -> logits (B, S, V) in activation dtype, + MoE aux."""
    x, aux = forward_features(params, tokens, cfg)
    out_emb = params.get("unembed", params["embed"])
    return unembed(out_emb, x), aux


# ------------------------------------------------------------------- decode
def init_cache(cfg: LMConfig, batch: int, max_len: int, device="cuda"):
    """KV cache dict: ``max_len`` slots for every layer."""
    check_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv, cfg.d_head)
    dt = cfg.tdtype
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


@torch.no_grad()
def prefill(params: Param, tokens: torch.Tensor, cfg: LMConfig,
            max_len: Optional[int] = None):
    """Run the prompt, return last-position logits + populated cache."""
    _dense_only(cfg)
    b, s = tokens.shape
    max_len = max_len or s
    if max_len < s:
        raise ValueError(f"max_len {max_len} is shorter than the prompt {s}")
    x = _embed(params, tokens, cfg)
    shape = (cfg.n_layers, b, max_len, cfg.n_kv, cfg.d_head)
    ks = torch.zeros(shape, dtype=x.dtype, device=x.device)
    vs = torch.zeros(shape, dtype=x.dtype, device=x.device)
    x = _layers(params, cfg, x, _positions(b, s, x.device), kv_out=(ks, vs))
    x = rms_norm(x, params["ln_f"])
    out_emb = params.get("unembed", params["embed"])
    logits = unembed(out_emb, x[:, -1:, :])
    cache = {"k": ks, "v": vs,
             "len": torch.full((b,), s, dtype=torch.int32, device=x.device)}
    return logits, cache


@torch.no_grad()
def decode_step(params: Param, cache: dict, tokens: torch.Tensor,
                cfg: LMConfig):
    """One decode step: tokens (B, 1) -> logits (B, 1, V), new cache.

    The new token's K/V are written into ``cache["k"]``/``cache["v"]`` in
    place (the reference returns updated copies); the returned cache
    shares those tensors and has ``len + 1``."""
    _dense_only(cfg)
    x = _embed(params, tokens, cfg)
    lens = cache["len"]
    for i, window in enumerate(cfg.layer_windows()):
        lp = _layer(params["layers"], i)
        h = rms_norm(x, lp["ln_attn"])
        o, _, _ = _decode_attn(lp["attn"], h, cfg, cache["k"][i],
                               cache["v"][i], lens, int(window))
        x = x + o
        h = rms_norm(x, lp["ln_mlp"])
        x = x + mlp_block(lp["mlp"], h)
    x = rms_norm(x, params["ln_f"])
    out_emb = params.get("unembed", params["embed"])
    logits = unembed(out_emb, x)
    return logits, {"k": cache["k"], "v": cache["v"], "len": lens + 1}


def _decode_attn(p, x, cfg: LMConfig, k_cache, v_cache, lens, window: int):
    """Append the token's K/V at ``lens`` (the last slot once the cache is
    full) and attend over the valid prefix, in place."""
    b = x.shape[0]
    positions = lens[:, None]
    q, k_new, v_new = attn_qkv(p, x, cfg.attn, positions)
    s_max = k_cache.shape[1]
    write_idx = torch.clamp(lens, max=s_max - 1)
    write_cache(k_cache, k_new, write_idx)
    write_cache(v_cache, v_new, write_idx)
    if _USE_KERNEL:
        # keys 0..lens valid, the query at position lens
        o = fa_ops.mha(q, k_cache, v_cache, causal=True,
                       window=window or None, kv_len=lens + 1)
    else:
        k_pos = torch.arange(s_max, dtype=torch.int32,
                             device=x.device)[None, :].expand(b, s_max)
        valid = k_pos <= lens[:, None]
        n_rep = cfg.n_heads // cfg.n_kv
        kk = _repeat_kv(k_cache, n_rep)
        vv = _repeat_kv(v_cache, n_rep)
        scale = 1.0 / np.sqrt(cfg.d_head)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float()) \
            * scale
        mask = valid[:, None, :]
        if window > 0:
            mask = mask & (positions[:, :, None] - k_pos[:, None, :]
                           < window)
        logits = torch.where(mask[:, None, :, :], logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", probs, vv)
    out = o.reshape(b, 1, -1) @ p["wo"]
    return out, k_cache, v_cache
