"""Decoder-only LM (dense + MoE) with GQA, RoPE variants,
sliding-window/global mixes, KV-cache decode and the training loss: the
reference's ``models/transformer.py`` (``forward``, ``lm_loss``,
``chunked_ce``, ``prefill``, ``decode_step``) for the five LM
architectures (moonshot, qwen3-moe, phi4-mini, gemma3, chatglm3).

Parameters are the reference's pytree as a dict of tensors, layer
parameters stacked on a leading (n_layers,) dim (``layers.ParamTree``
holds one as a module for the optimizer); ``jax.lax.scan`` over layers
becomes a Python loop and ``jax.checkpoint`` (``remat="layer"``, and
each vocab chunk of ``chunked_ce``) becomes
``torch.utils.checkpoint`` without reentry, applied while autograd
records.  ``dist.constrain`` keeps activations whole (the identity,
with or without a mesh) and is dropped.  Under a mesh with a ``"model"``
axis, ``decode_attn="splitk"`` holds the KV cache as each rank's block
of the sequence (``init_cache`` and ``prefill`` leave it so, the cache
dict carrying its spec under ``"spec"``) and decode takes
``_decode_attn_splitk`` (flash-decoding: per-rank partials combined by a
``pmax`` and two ``psum`` over ``"model"``); otherwise decode takes
``_decode_attn``, as the reference does.  MoE layers with
``moe_impl="a2a"`` under such a mesh hold their rank's block of the
experts (:func:`local_params`).

Attention goes through the flash_attention kernel (``kernels/
flash_attention``: CUDA tensors launch it, CPU tensors take its plain
version) while :func:`set_use_kernel` is on, the default, except where
autograd records through it: the kernel has no backward, so a call with
grad enabled and q, k or v requiring grad takes the reference's plain
math (``_windowed_attention``), as the reference trains.  Off, every
call takes the plain math (``_windowed_attention``, ``_decode_attn``)
on any device: the plain twin that tests and ``chip_smoke.py`` hold the
kernel path against.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import dist
from repro_torch.core.analytics import check_device
from repro_torch.kernels.flash_attention import ops as fa_ops

from .layers import (NEG_INF, AttnConfig, _repeat_kv, attn_qkv, embed,
                     init_attn, init_embedding, init_mlp, mlp_block,
                     params_from_jax, rms_norm, unembed, write_cache)
from .moe import MoEConfig, expert_block, init_moe, moe_block

Param = dict

__all__ = ["LMConfig", "chunked_ce", "decode_step", "forward",
           "forward_features", "init_cache", "init_params", "lm_loss",
           "local_params", "params_from_jax", "prefill", "set_use_kernel"]

_USE_KERNEL = True


def set_use_kernel(flag: bool) -> None:
    """Route attention through the flash_attention kernel (the default,
    off the grad path), or through the reference's plain attention math
    when off."""
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
    moe: Optional[MoEConfig] = None
    tie_embeddings: bool = True
    embed_scale: bool = False          # gemma multiplies embeddings by sqrt(d)
    aux_loss_weight: float = 0.01
    remat: str = "layer"               # layer | none (activation ckpt)
    loss_chunks: int = 16              # vocab chunks for fused CE (0=full)
    decode_attn: str = "gather"        # "splitk": sequence-sharded cache
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

    def _attn_params(self) -> int:
        a = self.attn
        return self.d_model * (a.n_heads + 2 * a.n_kv) * a.d_head \
            + a.n_heads * a.d_head * self.d_model

    def _ffn_params(self, experts: int) -> int:
        m = self.moe
        return experts * 3 * self.d_model * m.d_expert \
            + self.d_model * m.n_experts \
            + (3 * self.d_model * m.n_shared * m.d_expert if m.n_shared
               else 0)

    def _total(self, ffn: int) -> int:
        emb = self.vocab * self.d_model * (1 if self.tie_embeddings else 2)
        return self.n_layers * (self._attn_params() + ffn
                                + 2 * self.d_model) + emb

    def n_params(self) -> int:
        """Total parameter count (for 6ND model-flops accounting)."""
        return self._total(self._ffn_params(self.moe.n_experts) if self.moe
                           else 3 * self.d_model * self.d_ff)

    def n_active_params(self) -> int:
        """Active parameters per token (MoE top-k only)."""
        if not self.moe:
            return self.n_params()
        return self._total(self._ffn_params(self.moe.top_k))


# --------------------------------------------------------------------- init
def init_layer(gen: torch.Generator, cfg: LMConfig, device) -> Param:
    dt = cfg.tdtype
    p = {
        "attn": init_attn(gen, cfg.attn, dt, device),
        "ln_attn": torch.zeros((cfg.d_model,), dtype=dt, device=device),
        "ln_mlp": torch.zeros((cfg.d_model,), dtype=dt, device=device),
    }
    if cfg.moe:
        p["moe"] = init_moe(gen, cfg.d_model, cfg.moe, dt, device)
    else:
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, gated=True, dtype=dt,
                            device=device)
    return p


def _stack(trees: list) -> Param:
    return {k: _stack([t[k] for t in trees]) if isinstance(v, dict)
            else torch.stack([t[k] for t in trees])
            for k, v in trees[0].items()}


def init_params(cfg: LMConfig, seed: int = 0, device="cuda") -> Param:
    """Random parameters on ``device`` from a ``torch.Generator`` seeded
    with ``seed`` (the reference's distributions, not its random bits)."""
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


def _unstack(tree: Param) -> list:
    """Per-layer views of the stacked layer parameters: one ``unbind``
    per tensor, so that autograd stacks each tensor's gradient once."""
    cols = {k: _unstack(v) if isinstance(v, dict) else v.unbind(0)
            for k, v in tree.items()}
    n = len(next(iter(cols.values())))
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


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
    layer's window (0 = global): the kernel unless autograd records
    through q, k or v."""
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)
    if _USE_KERNEL and not grad:
        return fa_ops.mha(q, k, v, causal=True, window=int(window) or None)
    return _windowed_attention(q, k, v, positions, int(window))


def _ffn(cfg: LMConfig, lp: Param, h):
    """The layer's FFN: (y, MoE aux loss, 0 for a dense layer)."""
    if cfg.moe:
        return moe_block(lp["moe"], h, cfg.moe)
    return mlp_block(lp["mlp"], h), torch.zeros((), dtype=torch.float32,
                                                device=h.device)


def _layer_fwd(cfg: LMConfig, x, positions, lp: Param, window: int):
    """One layer over a whole prompt: (x, MoE aux, k, v)."""
    b, s, _ = x.shape
    h = rms_norm(x, lp["ln_attn"])
    q, k, v = attn_qkv(lp["attn"], h, cfg.attn, positions)
    o = _attend(q, k, v, positions, window)
    x = x + o.reshape(b, s, -1) @ lp["attn"]["wo"]
    y, aux = _ffn(cfg, lp, rms_norm(x, lp["ln_mlp"]))
    return x + y, aux, k, v


def _embed(params: Param, tokens: torch.Tensor, cfg: LMConfig):
    x = embed(params["embed"], tokens)
    if cfg.embed_scale:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def _layers(params: Param, cfg: LMConfig, x, positions, kv_out=None):
    """Every layer over a whole prompt -> (x, summed MoE aux); with
    ``kv_out``, ``kv_out(i, k, v)`` takes each layer's K/V (B, S, kv,
    dh).  While autograd records, ``remat="layer"``
    recomputes each layer in the backward pass."""
    s = x.shape[1]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat == "layer" and torch.is_grad_enabled()
    for i, (lp, window) in enumerate(zip(_unstack(params["layers"]),
                                         cfg.layer_windows())):
        args = (cfg, x, positions, lp, int(window))
        x, a, k, v = checkpoint(_layer_fwd, *args, use_reentrant=False) \
            if remat else _layer_fwd(*args)
        aux = aux + a
        if kv_out is not None:
            kv_out(i, k, v)
    return x, aux


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None, :] \
        .expand(b, s)


def forward_features(params: Param, tokens: torch.Tensor, cfg: LMConfig):
    """tokens (B, S) -> final hidden states (B, S, d), plus MoE aux."""
    b, s = tokens.shape
    x = _embed(params, tokens, cfg)
    x, aux = _layers(params, cfg, x, _positions(b, s, x.device))
    return rms_norm(x, params["ln_f"]), aux


def forward(params: Param, tokens: torch.Tensor, cfg: LMConfig):
    """tokens (B, S) -> logits (B, S, V) in activation dtype, + MoE aux."""
    x, aux = forward_features(params, tokens, cfg)
    out_emb = params.get("unembed", params["embed"])
    return unembed(out_emb, x), aux


def _ce_chunk(x, tb, labels, m, s, ll, lo: int):
    """Fold one vocab chunk ``tb`` (rows lo..lo+Vc) into the running
    (max, sumexp, label logit) of every token."""
    # the (T, Vc) logits in fp32 from the products on: never rounded to
    # the activation dtype (the reference's preferred_element_type)
    lg = x.float() @ tb.float().T
    nm = torch.maximum(m, torch.amax(lg, dim=-1))
    s = s * torch.exp(m - nm) + torch.sum(torch.exp(lg - nm[:, None]),
                                          dim=-1)
    vc = tb.shape[0]
    in_chunk = (labels >= lo) & (labels < lo + vc)
    idx = torch.clamp(labels - lo, 0, vc - 1).long()
    lbl = torch.gather(lg, 1, idx[:, None])[:, 0]
    return nm, s, torch.where(in_chunk, lbl, ll)


def chunked_ce(x: torch.Tensor, table: torch.Tensor, labels: torch.Tensor,
               n_chunks: int) -> torch.Tensor:
    """Fused unembed + cross-entropy, streamed over vocab chunks.

    Never materializes the (T, V) logits: each step computes one
    (T, V/n_chunks) block in fp32, folds it into a running (max, sumexp)
    pair and picks out the label logit.  While autograd records, each
    chunk is recomputed in the backward pass, so the backward holds one
    block at a time.  x: (T, d); table: (V, d); labels: (T,) -> per-token
    nll (T,) fp32.
    """
    t = x.shape[0]
    v = table.shape[0]
    vc = v // n_chunks
    if vc * n_chunks != v:
        raise ValueError(f"vocab {v} is not a multiple of {n_chunks} chunks")
    remat = torch.is_grad_enabled()
    m = torch.full((t,), -torch.inf, dtype=torch.float32, device=x.device)
    s = torch.zeros((t,), dtype=torch.float32, device=x.device)
    ll = torch.zeros((t,), dtype=torch.float32, device=x.device)
    for i in range(n_chunks):
        args = (x, table[i * vc:(i + 1) * vc], labels, m, s, ll, i * vc)
        m, s, ll = checkpoint(_ce_chunk, *args, use_reentrant=False) \
            if remat else _ce_chunk(*args)
    return m + torch.log(torch.clamp(s, min=1e-30)) - ll


def lm_loss(params: Param, batch: dict, cfg: LMConfig):
    """batch: tokens (B, S), labels (B, S) (< 0 = masked) -> (loss + the
    weighted MoE aux, {"loss", "aux"})."""
    labels = batch["labels"]
    mask = (labels >= 0).float()
    if cfg.loss_chunks and cfg.vocab % cfg.loss_chunks == 0:
        x, aux = forward_features(params, batch["tokens"], cfg)
        b, s_, d = x.shape
        out_emb = params.get("unembed", params["embed"])
        nll = chunked_ce(x.reshape(b * s_, d), out_emb["table"],
                         labels.reshape(-1), cfg.loss_chunks)
        nll = nll.reshape(b, s_)
    else:
        logits, aux = forward(params, batch["tokens"], cfg)
        lse = torch.logsumexp(logits.float(), dim=-1)
        # a masked label's logit is multiplied by 0 below: any row will do
        ll = torch.gather(logits, -1, labels.clamp(min=0).long()[..., None]
                          )[..., 0].float()
        nll = lse - ll
    loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return loss + cfg.aux_loss_weight * aux, {"loss": loss, "aux": aux}


# ------------------------------------------------------------------- decode
def local_params(params: Param, cfg: LMConfig, mesh) -> Param:
    """The tree this rank holds under ``mesh``: ``params`` with each MoE
    layer's expert weights cut to the rank's block when the layers take
    the all-to-all (``moe_impl="a2a"`` and a ``"model"`` axis); the rest
    is replicated and returned as it is."""
    if not (cfg.moe and cfg.moe.moe_impl == "a2a" and mesh is not None
            and "model" in mesh.axis_names):
        return params
    layers = dict(params["layers"],
                  moe=expert_block(params["layers"]["moe"], mesh,
                                   stacked=True))
    return dict(params, layers=layers)


def _cache_spec(cfg: LMConfig, batch: int, max_len: int):
    """The spec of a cache held as blocks for split-K decode (layer,
    batch over the dp axes when they divide it, sequence over
    ``"model"``), or None when decode gathers: the reference's
    condition for ``_decode_attn_splitk``, read when the cache is made."""
    mesh = dist.get_mesh()
    if not (cfg.decode_attn == "splitk" and mesh is not None
            and "model" in mesh.axis_names
            and max_len % mesh.shape["model"] == 0):
        return None
    dpx = dist.sharding.dp_axes(mesh)
    bax = dpx if batch % max(dist.axis_size(mesh, dpx), 1) == 0 else None
    return dist.Held(dist.P(None, bax, "model", None, None))


def init_cache(cfg: LMConfig, batch: int, max_len: int, device="cuda"):
    """KV cache dict: ``max_len`` slots for every layer (under split-K,
    this rank's block of them, and ``"spec"``)."""
    check_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv, cfg.d_head)
    spec = _cache_spec(cfg, batch, max_len)
    if spec is not None:
        shape = dist.block_shape(shape, spec, dist.get_mesh())
    dt = cfg.tdtype
    cache = {"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device),
             "len": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if spec is not None:
        cache["spec"] = spec
    return cache


@torch.no_grad()
def prefill(params: Param, tokens: torch.Tensor, cfg: LMConfig,
            max_len: Optional[int] = None):
    """Run the prompt, return last-position logits + populated cache.

    Under split-K each rank keeps only its block of the cache (the
    reference's ``constrain(kc, cache_spec)``): the slots of its
    sequence block that the prompt fills."""
    b, s = tokens.shape
    max_len = max_len or s
    if max_len < s:
        raise ValueError(f"max_len {max_len} is shorter than the prompt {s}")
    x = _embed(params, tokens, cfg)
    cache = init_cache(cfg, b, max_len, device=x.device)
    cache["len"].fill_(s)
    spec = cache.get("spec")
    # the block's [lo, hi) of the batch and of the sequence
    (b0, b1), (p0, p1) = ((0, b), (0, max_len)) if spec is None else (
        dist.block_range(n, spec[dim], dist.get_mesh())
        for dim, n in ((1, b), (2, max_len)))
    filled = max(0, min(p1, s) - p0)

    def store(i, k, v):
        if filled:
            cache["k"][i, :, :filled] = k[b0:b1, p0:p0 + filled]
            cache["v"][i, :, :filled] = v[b0:b1, p0:p0 + filled]

    x, _ = _layers(params, cfg, x, _positions(b, s, x.device), kv_out=store)
    x = rms_norm(x, params["ln_f"])
    out_emb = params.get("unembed", params["embed"])
    logits = unembed(out_emb, x[:, -1:, :])
    return logits, cache


@torch.no_grad()
def decode_step(params: Param, cache: dict, tokens: torch.Tensor,
                cfg: LMConfig):
    """One decode step: tokens (B, 1) -> logits (B, 1, V), new cache.

    The new token's K/V are written into ``cache["k"]``/``cache["v"]`` in
    place (the reference returns updated copies); the returned cache
    shares those tensors and has ``len + 1``.  A cache held as split-K
    blocks (``"spec"``) takes ``_decode_attn_splitk`` under the installed
    mesh."""
    x = _embed(params, tokens, cfg)
    lens = cache["len"]
    mesh = dist.get_mesh()
    splitk = "spec" in cache
    if splitk and mesh is None:
        raise RuntimeError("this cache is held as split-K blocks of a mesh; "
                           "install it with dist.set_mesh")
    for i, (lp, window) in enumerate(zip(_unstack(params["layers"]),
                                         cfg.layer_windows())):
        h = rms_norm(x, lp["ln_attn"])
        if splitk:
            o, _, _ = _decode_attn_splitk(lp["attn"], h, cfg, cache["k"][i],
                                          cache["v"][i], lens, int(window),
                                          mesh)
        else:
            o, _, _ = _decode_attn(lp["attn"], h, cfg, cache["k"][i],
                                   cache["v"][i], lens, int(window))
        x = x + o
        y, _ = _ffn(cfg, lp, rms_norm(x, lp["ln_mlp"]))
        x = x + y
    x = rms_norm(x, params["ln_f"])
    out_emb = params.get("unembed", params["embed"])
    logits = unembed(out_emb, x)
    return logits, dict(cache, len=lens + 1)


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


def _decode_attn_splitk(p, x, cfg: LMConfig, k_cache, v_cache, lens,
                        window: int, mesh):
    """Flash-decoding over a sequence-sharded KV cache.

    Gathering the whole K/V cache per layer per token would move
    O(S*kv*dh) bytes per layer.  Here each rank attends over its LOCAL
    cache block (``k_cache``/``v_cache``: (B or B/dp, S/n_model, kv, dh))
    with running (max, sumexp, acc) statistics, and the combine is a
    ``pmax`` and two ``psum`` over (B, H) and (B, H, D): bytes per layer
    drop to O(H*dh), B*H*(dh+2)*4 per step.  The new K/V row is written,
    in place, only on the rank that owns position ``lens`` (no
    cross-rank traffic); past a full cache no rank owns it and nothing
    is written (the reference's behaviour: gather decode overwrites the
    last slot instead).
    """
    b = x.shape[0]
    positions = lens[:, None]
    q, k_new, v_new = attn_qkv(p, x, cfg.attn, positions)   # (B,1,H,dh)...
    n_rep = cfg.n_heads // cfg.n_kv
    s_loc = k_cache.shape[1]
    dpx = dist.sharding.dp_axes(mesh)
    bax = dpx if b % max(dist.axis_size(mesh, dpx), 1) == 0 else None

    def local(q, k_new, v_new, kc, vc, lens_):
        shard = dist.axis_index("model")
        base = shard * s_loc
        idx = lens_ - base                       # (B,)
        own = (idx >= 0) & (idx < s_loc)
        iw = torch.clamp(idx, 0, s_loc - 1).long()
        rows = torch.arange(kc.shape[0], device=kc.device)
        for c, n in ((kc, k_new), (vc, v_new)):
            # write exactly one row: select between the new KV row and
            # the row already there (a whole-block `where` would rewrite
            # the block every layer)
            c[rows, iw] = torch.where(own[:, None, None], n[:, 0].to(c.dtype),
                                      c[rows, iw])
        k_pos = base + torch.arange(s_loc, dtype=torch.int32,
                                    device=kc.device)    # (s_loc,)
        mask = k_pos[None, :] <= lens_[:, None]           # (B, s_loc)
        if window > 0:
            mask = mask & (lens_[:, None] - k_pos[None, :] < window)
        kk = _repeat_kv(kc, n_rep)
        vv = _repeat_kv(vc, n_rep)
        scale = 1.0 / np.sqrt(cfg.d_head)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float()) \
            * scale
        logits = torch.where(mask[:, None, None, :], logits, NEG_INF)
        m_loc = torch.amax(logits, dim=-1)                  # (B,H,1)
        m_glob = dist.pmax(m_loc, "model")
        pexp = torch.exp(logits - m_glob[..., None])
        l_loc = torch.sum(pexp, dim=-1)                     # (B,H,1)
        acc = torch.einsum("bhqk,bkhd->bqhd", pexp.to(vv.dtype), vv)
        l = dist.psum(l_loc, "model")
        acc = dist.psum(acc.float(), "model")
        o = (acc / torch.clamp(l.transpose(1, 2)[..., None], min=1e-30)
             ).to(x.dtype)
        return o, kc, vc

    cache_spec = dist.Held(dist.P(bax, "model", None, None))
    small_spec = dist.P(bax, None, None, None)
    o, nk, nv = dist.shard_map(
        local, mesh=mesh,
        in_specs=(small_spec, small_spec, small_spec, cache_spec,
                  cache_spec, dist.P(bax)),
        out_specs=(small_spec, cache_spec, cache_spec),
    )(q, k_new, v_new, k_cache, v_cache, lens)
    out = o.reshape(b, 1, -1) @ p["wo"]
    return out, nk, nv
