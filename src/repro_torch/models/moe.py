"""Mixture-of-Experts FFN (GShard/Switch-style capacity dispatch).

Router: softmax top-k with normalized weights + Switch-style load-balance
auxiliary loss.  Shared experts (DeepSeek/Moonlight style) are a fused
dense MLP applied to every token.

The reference's scatter path, on one card: its sharding constraints on
the (E, C, d) expert buffers are the identity without a mesh and are
dropped, and ``moe_impl="a2a"`` takes the scatter path, as the reference
does without a mesh (the all-to-all comes with the distribution slice).
Which (token, slot) pairs overflow an expert's capacity depends on the
order of equal router scores and of equal expert ids, so both follow the
reference: top-k breaks ties toward the lower expert index (a stable
descending sort, where ``torch.topk`` promises no order) and the
dispatch sort is stable.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .layers import _normal, init_mlp, mlp_block

Param = dict


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    # "scatter": capacity dispatch by one scatter (the path here);
    # "a2a": expert-parallel all-to-all, which needs a mesh (without one
    # the reference, and the port, take the scatter path)
    moe_impl: str = "scatter"
    # a2a overflow semantics ("global" | "local"); read by the a2a path
    a2a_overflow: str = "global"


def init_moe(gen: torch.Generator, d_model: int, cfg: MoEConfig,
             dtype=torch.bfloat16, device="cpu") -> Param:
    """Random parameters from ``gen`` (the reference's distributions)."""
    s_in = float(1.0 / np.sqrt(d_model))
    s_out = float(1.0 / np.sqrt(cfg.d_expert))
    e, d, f = cfg.n_experts, d_model, cfg.d_expert
    p = {
        "router": _normal(gen, (d, e), torch.float32, device, s_in),
        "w_gate": _normal(gen, (e, d, f), dtype, device, s_in),
        "w_up": _normal(gen, (e, d, f), dtype, device, s_in),
        "w_down": _normal(gen, (e, f, d), dtype, device, s_out),
    }
    if cfg.n_shared:
        p["shared"] = init_mlp(gen, d_model, cfg.n_shared * cfg.d_expert,
                               gated=True, dtype=dtype, device=device)
    return p


def capacity(n_tokens: int, cfg: MoEConfig) -> int:
    c = int(np.ceil(n_tokens * cfg.top_k * cfg.capacity_factor
                    / cfg.n_experts))
    return max(8, -(-c // 8) * 8)   # round up to a multiple of 8


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last dim: the k largest values in
    descending order, equal values toward the lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def dispatch(expert_flat: torch.Tensor, n_experts: int, c: int):
    """Each (token, slot)'s position in its expert's buffer, in token
    order (a stable sort by expert), and whether it fits the capacity
    ``c``: (pos_c, keep), overflowing pairs sent to slot ``c``."""
    n = expert_flat.shape[0]
    dev = expert_flat.device
    order = torch.argsort(expert_flat, stable=True)
    sorted_ids = expert_flat[order]
    starts = torch.searchsorted(
        sorted_ids, torch.arange(n_experts, dtype=sorted_ids.dtype,
                                 device=dev))
    pos_sorted = torch.arange(n, device=dev) - starts[sorted_ids]
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    keep = pos < c
    return torch.where(keep, pos, c), keep


def moe_block(p: Param, x: torch.Tensor, cfg: MoEConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss)."""
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    e, k = cfg.n_experts, cfg.top_k
    c = capacity(t, cfg)

    # ---- router ----------------------------------------------------------
    logits = xf.float() @ p["router"]                        # (T, E)
    probs = torch.softmax(logits, dim=-1)
    weights, idx = top_k(probs, k)                           # (T, k)
    weights = weights / torch.clamp(
        torch.sum(weights, dim=-1, keepdim=True), min=1e-9)

    # Switch load-balance loss: E * sum_e f_e * P_e
    me = torch.mean(probs, dim=0)                            # (E,)
    ce = torch.mean(F.one_hot(idx[:, 0], e).float(), dim=0)
    aux = e * torch.sum(me * ce)

    # ---- dispatch: position of each (token, slot) inside its expert -------
    expert_flat = idx.reshape(-1)                            # (N = T*k,)
    pos_c, keep = dispatch(expert_flat, e, c)
    token_idx = torch.arange(t, device=x.device).repeat_interleave(k)
    gathered = xf[token_idx] * keep[:, None].to(x.dtype)     # (T*k, d)
    # every overflowing pair adds its zeroed row into slot c, dropped
    buf = torch.zeros((e, c + 1, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((expert_flat, pos_c), gathered, accumulate=True)
    expert_in = buf[:, :c, :]                                # (E, C, d)

    # ---- expert FFN (SwiGLU), batched over experts -------------------------
    g = torch.bmm(expert_in, p["w_gate"])
    u = torch.bmm(expert_in, p["w_up"])
    h = F.silu(g) * u
    expert_out = torch.bmm(h, p["w_down"])                   # (E, C, d)

    # ---- combine -------------------------------------------------------------
    padded = torch.cat([expert_out, expert_out.new_zeros((e, 1, d))], dim=1)
    back = padded[expert_flat, pos_c]                        # (T*k, d)
    # combine weights cast to the activation dtype BEFORE the big
    # elementwise product, as in the reference
    w_comb = (weights.to(x.dtype).reshape(-1, 1)
              * keep[:, None].to(x.dtype))
    back = back * w_comb
    y = torch.sum(back.reshape(t, k, d), dim=1)

    if "shared" in p:
        y = y + mlp_block(p["shared"], xf)
    return y.reshape(b, s, d), aux
