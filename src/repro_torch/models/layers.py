"""Transformer building blocks: norms, RoPE variants, GQA attention
(full / sliding-window / KV-cache decode), gated MLPs.

Layers are functions over parameter dicts of tensors (the reference's
pytrees, carried across by ``transformer.params_from_jax``);
:class:`ParamTree` holds such a tree as one ``nn.Module`` for the
optimizer and the trainer.  The
reference's ``jax.lax.scan`` over stacked layers becomes a Python loop in
``transformer``; ``dist.constrain`` sharding hints keep activations
whole (the identity) and are dropped here.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

Param = dict

NEG_INF = -1e30


def params_from_jax(tree, device="cpu"):
    """A reference parameter pytree (dicts and lists of numpy or JAX
    arrays) as the same structure of tensors on ``device``; bf16 leaves
    stay bf16 (exactly, through fp32)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device, torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)


# ----------------------------------------------------------- parameter trees
class ParamTree(nn.Module):
    """Parameters laid out as a reference pytree: a dict becomes a module
    with one attribute per key, a list an ``nn.ModuleList``, an array a
    parameter.  Parameter names are the tree's paths joined by dots, and
    :meth:`tree` gives the nested dicts back, holding the parameters."""

    def __init__(self, tree: dict):
        super().__init__()
        attach_tree(self, tree)

    def tree(self) -> dict:
        return module_tree(self)


def attach_tree(module: nn.Module, tree: dict) -> None:
    for k, v in tree.items():
        if isinstance(v, dict):
            module.add_module(k, ParamTree(v))
        elif isinstance(v, list):
            module.add_module(k, nn.ModuleList(ParamTree(i) for i in v))
        else:
            t = v if isinstance(v, torch.Tensor) else torch.tensor(
                np.array(v))
            module.register_parameter(k, nn.Parameter(t))


def module_tree(module: nn.Module) -> dict:
    """The tree :func:`attach_tree` laid out on ``module``: nested dicts
    and lists holding the module's own parameters."""
    out = dict(module._parameters)
    for k, child in module._modules.items():
        out[k] = [module_tree(c) for c in child] \
            if isinstance(child, nn.ModuleList) else module_tree(child)
    return out


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def map_tree(fn: Callable, tree, *rest, is_leaf: Optional[Callable] = None,
             path: Tuple[str, ...] = ()):
    """``tree``'s structure with ``fn(path, leaf, *leaves of rest)`` at each
    leaf, as ``jax.tree_util`` walks a pytree: dicts in sorted key order,
    lists, tuples and NamedTuples; ``path`` holds dict keys, sequence
    indices and ``.field`` for a NamedTuple field.  Trees ``rest`` of the
    same structure are zipped in; ``is_leaf(x)`` true stops the walk at
    ``x``."""
    if is_leaf is not None and is_leaf(tree):
        return fn(path, tree, *rest)
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k], *(r[k] for r in rest),
                            is_leaf=is_leaf, path=path + (str(k),))
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(map_tree(fn, getattr(tree, f),
                                     *(getattr(r, f) for r in rest),
                                     is_leaf=is_leaf, path=path + (f".{f}",))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v, *(r[i] for r in rest),
                                   is_leaf=is_leaf, path=path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree, *rest)


def flatten_tree(tree) -> Dict[str, np.ndarray]:
    """``{dotted pytree path: leaf}`` of a tree (:func:`map_tree`'s)."""
    out: Dict[str, np.ndarray] = {}
    map_tree(lambda p, v: out.__setitem__(".".join(p), v), tree)
    return out


def tree_like(tree, flat: dict):
    """``tree``'s structure holding ``flat[dotted path]`` at each leaf (the
    inverse of :func:`flatten_tree`)."""
    return map_tree(lambda p, _: flat[".".join(p)], tree)


# --------------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dtype)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(dtype)


# --------------------------------------------------------------------- RoPE
def rope_freqs(d_rot: int, theta: float = 10000.0) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, d_rot, 2, dtype=np.float64) / d_rot))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               fraction: float = 1.0) -> torch.Tensor:
    """Rotary embedding on the leading ``fraction`` of head dims.

    ``fraction=0.5`` gives the ChatGLM-style "2d" partial rotary where only
    half of each head rotates (the other half stays positional-free).
    x: (..., S, H, D); positions: broadcastable to (..., S).
    """
    d = x.shape[-1]
    d_rot = int(d * fraction)
    d_rot -= d_rot % 2
    if d_rot == 0:
        return x
    freqs = torch.tensor(rope_freqs(d_rot, theta), dtype=torch.float32,
                         device=x.device)
    ang = positions[..., :, None, None].float() * freqs   # (..., S, 1, d/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    xr = x[..., :d_rot].float()
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    rot = torch.stack([r1, r2], dim=-1).reshape(xr.shape)
    return torch.cat([rot.to(x.dtype), x[..., d_rot:]], dim=-1)


# ----------------------------------------------------------------- attention
def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d) \
        .reshape(b, s, h * n_rep, d)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              q_positions: torch.Tensor, k_positions: torch.Tensor,
              causal: bool = True, window: Optional[int] = None,
              softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Grouped-query attention with optional sliding window.

    q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D).  Positions give the absolute
    token index of each query/key (needed for decode and windowing).
    """
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    n_rep = hq // hkv
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    scale = softmax_scale if softmax_scale is not None else 1.0 / np.sqrt(d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    dq = q_positions[:, :, None]          # (B, Sq, 1)
    dk = k_positions[:, None, :]          # (B, 1, Sk)
    if causal:
        mask = dk <= dq
    else:
        mask = torch.ones((b, sq, k.shape[1]), dtype=torch.bool,
                          device=q.device)
    if window is not None:
        mask = mask & (dq - dk < window)
    logits = torch.where(mask[:, None, :, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv: int
    d_head: int
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0
    qkv_bias: bool = False


def _normal(gen: torch.Generator, shape, dtype, device, std: float):
    return (torch.randn(shape, generator=gen, device=device) * std).to(dtype)


def init_attn(gen: torch.Generator, cfg: AttnConfig,
              dtype=torch.bfloat16, device="cpu") -> Param:
    s = float(1.0 / np.sqrt(cfg.d_model))
    dq, dkv = cfg.n_heads * cfg.d_head, cfg.n_kv * cfg.d_head
    p = {
        "wq": _normal(gen, (cfg.d_model, dq), dtype, device, s),
        "wk": _normal(gen, (cfg.d_model, dkv), dtype, device, s),
        "wv": _normal(gen, (cfg.d_model, dkv), dtype, device, s),
        "wo": _normal(gen, (dq, cfg.d_model), dtype, device, s),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((dq,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((dkv,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((dkv,), dtype=dtype, device=device)
    return p


def attn_qkv(p: Param, x: torch.Tensor, cfg: AttnConfig,
             positions: torch.Tensor):
    b, s, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, cfg.n_heads, cfg.d_head)
    k = k.reshape(b, s, cfg.n_kv, cfg.d_head)
    v = v.reshape(b, s, cfg.n_kv, cfg.d_head)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    return q, k, v


def self_attention_block(p: Param, x: torch.Tensor, cfg: AttnConfig,
                         positions: torch.Tensor,
                         window: Optional[int] = None) -> torch.Tensor:
    b, s, _ = x.shape
    q, k, v = attn_qkv(p, x, cfg, positions)
    o = attention(q, k, v, positions, positions, causal=True, window=window)
    return o.reshape(b, s, cfg.n_heads * cfg.d_head) @ p["wo"]


def write_cache(cache: torch.Tensor, new: torch.Tensor,
                idx: torch.Tensor) -> torch.Tensor:
    """``cache[b, idx[b]] = new[b, 0]`` for every batch row b, in place
    (the reference's vmapped ``dynamic_update_slice``, which copies; like
    it, an index past the end writes the last slot).  Returns ``cache``."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    at = idx.long().clamp(0, cache.shape[1] - 1)
    cache[rows, at] = new[:, 0].to(cache.dtype)
    return cache


def decode_attention_block(p: Param, x: torch.Tensor, cfg: AttnConfig,
                           k_cache: torch.Tensor, v_cache: torch.Tensor,
                           cache_len: torch.Tensor,
                           window: Optional[int] = None):
    """One-token decode: append to the KV cache, attend over the prefix.

    x: (B, 1, d_model); k_cache/v_cache: (B, S_max, n_kv, d_head);
    cache_len: (B,) current lengths.  Returns (out, new_k, new_v); the
    caches are updated in place and returned.
    """
    b = x.shape[0]
    positions = cache_len[:, None]                       # (B, 1)
    q, k_new, v_new = attn_qkv(p, x, cfg, positions)
    idx = cache_len                                       # (B,)
    write_cache(k_cache, k_new, idx)
    write_cache(v_cache, v_new, idx)
    s_max = k_cache.shape[1]
    k_pos = torch.arange(s_max, dtype=torch.int32, device=x.device)
    k_pos = k_pos[None, :].expand(b, s_max)
    # mask out unwritten cache slots by pushing their positions past query
    k_pos = torch.where(k_pos <= idx[:, None], k_pos,
                        torch.full_like(k_pos, 2**30))
    o = attention(q, k_cache, v_cache, positions, k_pos, causal=True,
                  window=window)
    out = o.reshape(b, 1, cfg.n_heads * cfg.d_head) @ p["wo"]
    return out, k_cache, v_cache


# ----------------------------------------------------------------------- MLP
def init_mlp(gen: torch.Generator, d_model: int, d_ff: int,
             gated: bool = True, dtype=torch.bfloat16, device="cpu") -> Param:
    s_in = float(1.0 / np.sqrt(d_model))
    s_out = float(1.0 / np.sqrt(d_ff))
    p = {
        "w_up": _normal(gen, (d_model, d_ff), dtype, device, s_in),
        "w_down": _normal(gen, (d_ff, d_model), dtype, device, s_out),
    }
    if gated:
        p["w_gate"] = _normal(gen, (d_model, d_ff), dtype, device, s_in)
    return p


def mlp_block(p: Param, x: torch.Tensor, act=F.silu) -> torch.Tensor:
    up = x @ p["w_up"]
    if "w_gate" in p:
        up = act(x @ p["w_gate"]) * up
    else:
        up = act(up)
    return up @ p["w_down"]


# ----------------------------------------------------------------- embedding
def init_embedding(gen: torch.Generator, vocab: int, d_model: int,
                   dtype=torch.bfloat16, device="cpu") -> Param:
    return {"table": _normal(gen, (vocab, d_model), dtype, device, 0.02)}


def embed(p: Param, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens]


def unembed(p: Param, x: torch.Tensor) -> torch.Tensor:
    # logits stay in the activation dtype, as in the reference
    return torch.einsum("bsd,vd->bsv", x, p["table"])

