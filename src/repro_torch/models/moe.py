"""Mixture-of-Experts FFN (GShard/Switch-style capacity dispatch).

Router: softmax top-k with normalized weights + Switch-style load-balance
auxiliary loss.  Shared experts (DeepSeek/Moonlight style) are a fused
dense MLP applied to every token.

Two dispatches, as in the reference.  The scatter path puts each
(token, slot) pair into an ``(E, C, d)`` buffer by one scatter; its
sharding constraints on that buffer (``_ep_spec``) are checked and
otherwise the identity (``dist.constrain``: the port keeps activations
whole on every rank).  ``moe_impl="a2a"`` under a mesh with a ``"model"``
axis takes ``_moe_a2a``: expert parallelism by explicit all-to-all
(``dist.collectives.moe_alltoall_block``), each rank holding its block
of the expert axis (:func:`expert_block`); without such a mesh it takes
the scatter path, as the reference does.  Which (token, slot) pairs
overflow an expert's capacity depends on the order of equal router
scores and of equal expert ids, so both follow the reference: top-k
breaks ties toward the lower expert index (a stable descending sort,
where ``torch.topk`` promises no order) and the dispatch sort is stable.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import dist

from .layers import _normal, init_mlp, mlp_block


def _tok_spec(mesh):
    """(T*k, d) token-major tensors: shard dim0 over every mesh axis."""
    axes = tuple(a for a in ("pod", "data", "model") if a in mesh.axis_names)
    return dist.P(axes, None)


def _ep_spec(mesh):
    # (E, C, d): experts over 'model'
    return dist.P("model", None, None)


Param = dict


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    # "scatter": capacity dispatch by one scatter (baseline);
    # "a2a": expert-parallel all-to-all under a mesh with "model"
    moe_impl: str = "scatter"
    # a2a overflow semantics: "global" matches the scatter path's
    # per-global-expert drops exactly (wire buffer clamped to the
    # no-secondary-drop bound); "local" keeps the smaller per-(source
    # rank, dest shard) buffer but diverges from scatter under overflow.
    # See repro_torch.dist.collectives.moe_alltoall_block.
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


def expert_counts(expert_flat: torch.Tensor, n_experts: int
                  ) -> torch.Tensor:
    """Pairs per expert id (int64, ``n_experts`` long): a bincount whose
    length does not depend on the ids, as a fake-tensor run needs."""
    return torch.zeros((n_experts,), dtype=torch.int64,
                       device=expert_flat.device).index_add_(
        0, expert_flat.long(), torch.ones_like(expert_flat, dtype=torch.int64))


def one_hot_mean(idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """``mean(one_hot(idx, n_experts).float(), 0)`` without one_hot's
    read of the ids' range (shape-static, for fake tensors)."""
    hits = idx[:, None] == torch.arange(n_experts, device=idx.device)
    return torch.mean(hits.float(), dim=0)


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

    mesh = dist.get_mesh()
    if cfg.moe_impl == "a2a" and mesh is not None \
            and "model" in mesh.axis_names:
        return _moe_a2a(p, x, cfg, mesh)

    # ---- router ----------------------------------------------------------
    logits = xf.float() @ p["router"]                        # (T, E)
    probs = torch.softmax(logits, dim=-1)
    weights, idx = top_k(probs, k)                           # (T, k)
    weights = weights / torch.clamp(
        torch.sum(weights, dim=-1, keepdim=True), min=1e-9)

    # Switch load-balance loss: E * sum_e f_e * P_e
    me = torch.mean(probs, dim=0)                            # (E,)
    ce = one_hot_mean(idx[:, 0], e)
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
    expert_in = dist.constrain(expert_in, _ep_spec)

    # ---- expert FFN (SwiGLU), batched over experts -------------------------
    expert_out = _swiglu(expert_in, p["w_gate"], p["w_up"], p["w_down"])
    expert_out = dist.constrain(expert_out, _ep_spec)        # (E, C, d)

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


def _swiglu(expert_in, w_gate, w_up, w_down):
    """The experts' SwiGLU over their (E, C, d) buffers: one batched
    product per weight (the all-to-all path's receiving side runs the
    same over its (e_loc, C, d) buffer)."""
    g = torch.bmm(expert_in, w_gate)
    u = torch.bmm(expert_in, w_up)
    return torch.bmm(F.silu(g) * u, w_down)


def expert_block(p: Param, mesh, stacked: bool = False,
                 name: str = "") -> Param:
    """``p`` with the expert weights replaced by this rank's block of
    the expert axis (``_ep_spec``; ``stacked``: behind a leading layer
    dim), as ``_moe_a2a`` holds them.  Copies, so the whole weights can
    be freed.  With ``name``, the dotted path of ``p`` in a model's
    parameter tree, each cut weight is recorded in ``mesh.held`` under its
    parameter name, so that a norm over the tree sums the other ranks'
    blocks."""
    spec = _ep_spec(mesh)
    if stacked:
        spec = dist.P(None, *spec)
    cut = ("w_gate", "w_up", "w_down")
    if name:
        mesh.held.update({f"{name}.{k}": dist.Held(spec) for k in cut})
    return {k: dist.local_block(v, spec, mesh).clone() if k in cut else v
            for k, v in p.items()}


def _moe_a2a(p: Param, x: torch.Tensor, cfg: MoEConfig, mesh
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert parallelism: explicit all-to-all dispatch instead of the
    scatter over a whole (E, C, d) buffer.  ``x`` is whole on every rank,
    the expert weights are this rank's block, and ``y`` comes back whole
    on every rank."""
    from repro_torch.dist import collectives

    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    xf = dist.constrain(xf, _tok_spec)
    n_model = mesh.shape["model"]
    if p["w_gate"].shape[0] * n_model != cfg.n_experts:
        raise ValueError(
            f"moe_impl='a2a' under a mesh needs this rank's block of the "
            f"{cfg.n_experts} experts ({cfg.n_experts // n_model}), not "
            f"{p['w_gate'].shape[0]}: take it with moe.expert_block or "
            f"transformer.local_params")
    logits = xf.float() @ p["router"]                        # (T, E)
    # aux loss computed on the whole logits (cheap, every rank)
    probs = torch.softmax(logits, dim=-1)
    _, top1 = top_k(probs, 1)
    me = torch.mean(probs, dim=0)
    ce = one_hot_mean(top1[:, 0], cfg.n_experts)
    aux = cfg.n_experts * torch.sum(me * ce)

    dp = 1
    for a in ("pod", "data"):
        if a in mesh.axis_names:
            dp *= mesh.shape[a]
    t_loc = t // (dp * n_model)
    c_dev = max(8, int(-(-t_loc * cfg.top_k * cfg.capacity_factor
                         // n_model) // 8 * 8 + 8))
    # global per-expert capacity == the scatter path's, so the two
    # implementations drop the SAME (token, slot) pairs under overflow
    # (cfg.a2a_overflow="local" opts back into the smaller wire buffer)
    y = collectives.moe_alltoall_block(
        xf, logits, p["w_gate"], p["w_up"], p["w_down"], mesh,
        cfg.top_k, c_dev, capacity=capacity(t, cfg),
        overflow=cfg.a2a_overflow,
        local_capacity_factor=max(2.0, cfg.capacity_factor))
    if "shared" in p:
        y = y + mlp_block(p["shared"], xf)
    return y.reshape(b, s, d), aux
