"""GNN architectures: GIN, PNA, GAT, DimeNet.

All message passing routes through ``repro_torch.models.mp``.  Batched
small graphs use a ``graph_ids`` vector; full-batch graphs use
``n_graphs=1``.  A batch is a dict of tensors (plus the int
``n_graphs``) with the reference's keys and layouts.

A model is one :class:`GNN` module of ``cfg.kind``, called as
``model(batch)``, whose parameter names are the
reference's parameter pytree paths joined by dots (``layers.0.mlp.1.w``,
``blocks.2.bilinear``), so :func:`params_from_jax` carries a reference
pytree across by name.  Initialisation draws from an explicit
``torch.Generator``; it follows the reference's distributions, not its
random bits.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import dist

from . import mp
from .layers import attach_tree


def _node_spec(mesh):
    return dist.P(tuple(mesh.axis_names), None)


def _vec_spec(mesh):
    return dist.P(tuple(mesh.axis_names))


def _edge_heads_spec(mesh):
    return dist.P(tuple(mesh.axis_names), None, None)


def _c(cfg, x, is_node: bool = False):
    """Optionally constrain a node/edge-major activation
    (``GNNConfig.constrain_acts``), through ``dist.constrain``."""
    mode = cfg.constrain_acts
    if not mode or (mode == "nodes" and not is_node):
        return x
    if x.ndim == 1:
        return dist.constrain(x, _vec_spec)
    return dist.constrain(x, _node_spec)


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    kind: str                       # gin | pna | gat | dimenet
    n_layers: int
    d_hidden: int
    d_feat: int
    n_classes: int
    # gin (as in the reference, eps is trained whatever this says)
    eps_learnable: bool = True
    # pna
    aggregators: Tuple[str, ...] = ("mean", "max", "min", "std")
    scalers: Tuple[str, ...] = ("identity", "amplification", "attenuation")
    mean_log_degree: float = 2.0
    # gat
    n_heads: int = 8
    # dimenet
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    cutoff: float = 5.0
    n_species: int = 32
    task: str = "node"              # node | graph | energy
    # sharding constraints on activations ("" | "nodes" | "all"), through
    # dist.constrain (see _c)
    constrain_acts: str = ""
    dtype: str = "float32"

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def _normal(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32).to(dtype)


def _mlp_init(gen, dims, dtype):
    return [{"w": _normal(gen, (a, b), dtype) / math.sqrt(a),
             "b": torch.zeros((b,), dtype=dtype)}
            for a, b in zip(dims[:-1], dims[1:])]


def _mlp_apply(layers, x, act=F.relu, final_act=False):
    for i, lyr in enumerate(layers):
        x = x @ lyr.w + lyr.b
        if i < len(layers) - 1 or final_act:
            x = act(x)
    return x


def _floor(x: torch.Tensor, lo: float) -> torch.Tensor:
    """``jnp.maximum(x, lo)`` (ties split the gradient, as in JAX)."""
    return torch.maximum(x, x.new_tensor(lo))


# ============================================================== GIN =========
def init_gin(gen, cfg: GNNConfig) -> dict:
    dt = cfg.tdtype
    layers = []
    d_in = cfg.d_feat
    for _ in range(cfg.n_layers):
        layers.append({
            "mlp": _mlp_init(gen, [d_in, cfg.d_hidden, cfg.d_hidden], dt),
            "eps": torch.zeros((), dtype=dt),
        })
        d_in = cfg.d_hidden
    return {"layers": layers,
            "readout": _mlp_init(gen, [cfg.d_hidden, cfg.n_classes], dt)}


def gin_forward(p, batch: dict, cfg: GNNConfig) -> torch.Tensor:
    x = batch["x"]
    src, dst = batch["edge_src"], batch["edge_dst"]
    n = x.shape[0]
    for lp in p.layers:
        agg = _c(cfg, mp.scatter_sum(_c(cfg, mp.gather_src(x, src)), dst, n))
        x = _c(cfg, _mlp_apply(lp.mlp, (1.0 + lp.eps) * x + agg,
                               final_act=True), is_node=True)
    if cfg.task == "graph":
        x = mp.scatter_sum(x, batch["graph_ids"], batch["n_graphs"])
    return _mlp_apply(p.readout, x)


# ============================================================== PNA =========
def init_pna(gen, cfg: GNNConfig) -> dict:
    dt = cfg.tdtype
    n_agg = len(cfg.aggregators) * len(cfg.scalers)
    layers = []
    d_in = cfg.d_feat
    for _ in range(cfg.n_layers):
        layers.append({
            "pre": _mlp_init(gen, [2 * d_in, cfg.d_hidden], dt),
            "post": _mlp_init(gen, [d_in + n_agg * cfg.d_hidden,
                                    cfg.d_hidden], dt),
        })
        d_in = cfg.d_hidden
    return {"layers": layers,
            "readout": _mlp_init(gen, [cfg.d_hidden, cfg.n_classes], dt)}


def _finite_or_zero(v: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(v), v, torch.zeros_like(v))


def pna_forward(p, batch: dict, cfg: GNNConfig) -> torch.Tensor:
    x = batch["x"]
    src, dst = batch["edge_src"], batch["edge_dst"]
    n = x.shape[0]
    deg = mp.degree(dst, n)
    logd = torch.log(deg + 1.0)
    delta = cfg.mean_log_degree
    for lp in p.layers:
        m = _c(cfg, _mlp_apply(
            lp.pre, torch.cat([mp.gather_src(x, src), x[dst]], dim=-1),
            final_act=True))
        aggs = []
        mean = mp.scatter_mean(m, dst, n)
        for a in cfg.aggregators:
            if a == "mean":
                aggs.append(mean)
            elif a == "max":
                aggs.append(_finite_or_zero(mp.scatter_max(m, dst, n)))
            elif a == "min":
                aggs.append(_finite_or_zero(mp.scatter_min(m, dst, n)))
            elif a == "std":
                sq = mp.scatter_mean(torch.square(m), dst, n)
                aggs.append(torch.sqrt(_floor(sq - torch.square(mean),
                                              1e-8)))
        agg = torch.cat(aggs, dim=-1)                     # (N, 4H)
        scaled = []
        for s in cfg.scalers:
            if s == "identity":
                scaled.append(agg)
            elif s == "amplification":
                scaled.append(agg * (logd / delta)[:, None])
            elif s == "attenuation":
                scaled.append(agg * (delta / _floor(logd, 1e-6))[:, None])
        h = torch.cat([x] + scaled, dim=-1)
        x = _c(cfg, _mlp_apply(lp.post, h, final_act=True), is_node=True)
    if cfg.task == "graph":
        x = mp.scatter_sum(x, batch["graph_ids"], batch["n_graphs"])
    return _mlp_apply(p.readout, x)


# ============================================================== GAT =========
def init_gat(gen, cfg: GNNConfig) -> dict:
    dt = cfg.tdtype
    layers = []
    d_in = cfg.d_feat
    for i in range(cfg.n_layers):
        last = i == cfg.n_layers - 1
        d_out = cfg.n_classes if last else cfg.d_hidden
        heads = 1 if last else cfg.n_heads
        layers.append({
            "w": _normal(gen, (heads, d_in, d_out), dt) / math.sqrt(d_in),
            "a_src": _normal(gen, (heads, d_out), dt) * 0.1,
            "a_dst": _normal(gen, (heads, d_out), dt) * 0.1,
        })
        d_in = cfg.d_hidden * cfg.n_heads
    return {"layers": layers}


def gat_forward(p, batch: dict, cfg: GNNConfig) -> torch.Tensor:
    x = batch["x"]
    src, dst = batch["edge_src"], batch["edge_dst"]
    n = x.shape[0]
    for i, lp in enumerate(p.layers):
        last = i == len(p.layers) - 1
        h = torch.einsum("nd,hdo->nho", x, lp.w)             # (N, H, O)
        e_src = torch.einsum("nho,ho->nh", h, lp.a_src)
        e_dst = torch.einsum("nho,ho->nh", h, lp.a_dst)
        logits = F.leaky_relu(e_src[src] + e_dst[dst],
                              negative_slope=0.2)            # (E, H)
        alpha = mp.segment_softmax(logits, dst, n)           # per head
        msgs = h[src] * alpha[:, :, None]
        if cfg.constrain_acts == "all":
            msgs = dist.constrain(msgs, _edge_heads_spec)
        out = mp.scatter_sum(msgs, dst, n)                   # (N, H, O)
        if cfg.constrain_acts:
            out = dist.constrain(out, _edge_heads_spec)
        x = out.mean(dim=1) if last else F.elu(out.reshape(n, -1))
    if cfg.task == "graph":
        num = mp.scatter_sum(x, batch["graph_ids"], batch["n_graphs"])
        cnt = mp.scatter_sum(x.new_ones((n,)), batch["graph_ids"],
                             batch["n_graphs"])
        return num / torch.clamp(cnt, min=1.0)[:, None]
    return x


# ============================================================ DimeNet =======
def bessel_rbf(d: torch.Tensor, n_radial: int, cutoff: float) -> torch.Tensor:
    """Radial Bessel basis sin(n pi d/c)/d with cosine cutoff envelope."""
    dd = _floor(d, 1e-6)[:, None]
    n = torch.arange(1, n_radial + 1, dtype=d.dtype, device=d.device)
    env = 0.5 * (torch.cos(math.pi * torch.clamp(d / cutoff, max=1.0)) + 1.0)
    return (math.sqrt(2.0 / cutoff) * torch.sin(n * math.pi * dd / cutoff)
            / dd) * env[:, None]


def angular_sbf(d: torch.Tensor, angle: torch.Tensor, n_spherical: int,
                n_radial: int, cutoff: float) -> torch.Tensor:
    """Spherical-basis surrogate: radial sin-basis x cos(l*angle), the
    reference's separable stand-in for DimeNet's spherical Bessel basis."""
    rb = bessel_rbf(d, n_radial, cutoff)                   # (T, n_radial)
    lvec = torch.arange(n_spherical, dtype=d.dtype, device=d.device)
    ab = torch.cos(lvec[None, :] * angle[:, None])         # (T, n_spherical)
    return (rb[:, None, :] * ab[:, :, None]).reshape(
        d.shape[0], n_spherical * n_radial)


def init_dimenet(gen, cfg: GNNConfig) -> dict:
    dt = cfg.tdtype
    h = cfg.d_hidden
    n_sbf = cfg.n_spherical * cfg.n_radial
    blocks = []
    for _ in range(cfg.n_layers):
        blocks.append({
            "w_sbf": _normal(gen, (n_sbf, cfg.n_bilinear), dt)
            / math.sqrt(n_sbf),
            "w_kj": _normal(gen, (h, h), dt) / math.sqrt(h),
            "bilinear": _normal(gen, (cfg.n_bilinear, h, h), dt)
            / math.sqrt(h * cfg.n_bilinear),
            "mlp": _mlp_init(gen, [h, h, h], dt),
            "out": _mlp_init(gen, [h, h], dt),
        })
    return {
        "species": _normal(gen, (cfg.n_species, h), dt) * 0.1,
        "embed": _mlp_init(gen, [2 * h + cfg.n_radial, h], dt),
        "blocks": blocks,
        "out_rbf": _normal(gen, (cfg.n_radial, h), dt) / math.sqrt(
            cfg.n_radial),
        "energy": _mlp_init(gen, [h, h, 1], dt),
    }


def dimenet_forward(p, batch: dict, cfg: GNNConfig) -> torch.Tensor:
    """batch: species (N,), pos (N,3), edge_src/dst (E,),
    trip_in/trip_out (T,) indices into edges (message k->j feeds j->i),
    graph_ids (N,), n_graphs.  Returns per-graph energy (n_graphs,)."""
    species, pos = batch["species"], batch["pos"]
    src, dst = batch["edge_src"], batch["edge_dst"]
    e = src.shape[0]
    vec = pos[dst] - pos[src]                              # (E, 3)
    dist = torch.linalg.vector_norm(vec + 1e-9, dim=-1)
    rbf = bessel_rbf(dist, cfg.n_radial, cfg.cutoff)       # (E, n_radial)

    z = p.species[species]                                 # (N, h)
    m = _mlp_apply(p.embed, torch.cat([z[src], z[dst], rbf], dim=-1),
                   act=F.silu, final_act=True)             # (E, h)

    ti, to = batch["trip_in"], batch["trip_out"]           # (T,)
    # angle between edge ti (k->j) and edge to (j->i)
    v1 = -vec[ti]
    v2 = vec[to]
    cosang = torch.sum(v1 * v2, dim=-1) / _floor(
        torch.linalg.vector_norm(v1, dim=-1)
        * torch.linalg.vector_norm(v2, dim=-1), 1e-9)
    # at cos = +-1 exactly torch.clamp passes the gradient where
    # jnp.clip splits it; the two agree everywhere else
    angle = torch.arccos(torch.clamp(cosang, -1.0, 1.0))
    sbf = angular_sbf(dist[ti], angle, cfg.n_spherical, cfg.n_radial,
                      cfg.cutoff)                          # (T, n_sbf)

    n = species.shape[0]
    node_out = m.new_zeros((n, cfg.d_hidden))
    for blk in p.blocks:
        # directional message passing over triplets with bilinear layer
        s_proj = sbf @ blk.w_sbf                           # (T, n_bilinear)
        m_kj = (m @ blk.w_kj)[ti]                          # (T, h)
        inter = torch.einsum("tb,th,bho->to", s_proj, m_kj, blk.bilinear)
        agg = mp.scatter_sum(inter, to, e)
        m = m + _mlp_apply(blk.mlp, agg, act=F.silu, final_act=True)
        # per-block output: edges -> atoms
        contrib = (rbf @ p.out_rbf) * _mlp_apply(blk.out, m, act=F.silu)
        node_out = node_out + mp.scatter_sum(contrib, dst, n)
    atom_e = _mlp_apply(p.energy, node_out, act=F.silu)    # (N, 1)
    return mp.scatter_sum(atom_e[:, 0], batch["graph_ids"], batch["n_graphs"])


# ============================================================ dispatch ======
ARCHS = {"gin": (init_gin, gin_forward), "pna": (init_pna, pna_forward),
         "gat": (init_gat, gat_forward),
         "dimenet": (init_dimenet, dimenet_forward)}


class GNN(nn.Module):
    """The architecture ``cfg.kind``, its parameters drawn from
    ``generator`` (seed 0 when None) unless ``tree`` gives them."""

    def __init__(self, cfg: GNNConfig,
                 generator: Optional[torch.Generator] = None,
                 tree: Optional[dict] = None):
        super().__init__()
        self.cfg = cfg
        if tree is None:
            gen = generator if generator is not None \
                else torch.Generator().manual_seed(0)
            tree = ARCHS[cfg.kind][0](gen, cfg)
        attach_tree(self, tree)

    def forward(self, batch: dict) -> torch.Tensor:
        return ARCHS[self.cfg.kind][1](self, batch, self.cfg)


def init_model(cfg: GNNConfig,
               generator: Optional[torch.Generator] = None) -> GNN:
    return GNN(cfg, generator)


def params_from_jax(tree, cfg: GNNConfig) -> GNN:
    """The port's model of ``cfg.kind`` holding the reference's
    parameters ``tree`` (its pytree with numpy leaves)."""
    return GNN(cfg, tree=tree)


def gnn_loss(model: GNN, batch: dict, cfg: GNNConfig):
    out = model(batch)
    if cfg.task == "energy":
        loss = torch.mean(torch.square(out - batch["labels"]))
        return loss, {"loss": loss}
    logp = F.log_softmax(out, dim=-1)
    labels = batch["labels"].long()
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    mask = batch.get("label_mask")
    if mask is not None:
        loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    else:
        loss = torch.mean(nll)
    return loss, {"loss": loss}
