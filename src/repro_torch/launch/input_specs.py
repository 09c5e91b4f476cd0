"""Fake-tensor stand-ins and step functions for every (arch x shape)
cell: the reference's ``launch/input_specs.py`` on the port.

``build(arch_id, shape_name, mesh, variant)`` returns a
:class:`Lowerable`: the step function, its arguments as fake tensors on
the card, or on the CPU where asked (``torch._subclasses.fake_tensor.
FakeTensorMode``: shapes and dtypes, no memory), the port's partition
specs for the record, and the roofline metadata (``meta``, the
reference's formulas).  Nothing here
allocates device memory, and it runs without a card.  Dims that must
divide the mesh are padded as the reference pads them.

What a rank holds is what the port runs on it: every parameter whole
(the port keeps activations and dense parameters whole on every rank;
``in_shardings`` records the specs a placement by the reference's rules
would use), except this rank's block of the experts (``moe_a2a``,
``transformer.local_params``) and of a split-K cache (``decode_splitk``,
``transformer.init_cache`` under the mesh).  The mesh must be installed
(``dist.set_mesh``) before :func:`build` for those two, as the reference
installs it.  The step functions run the plain math: the kernels'
seams are off while they run (``transformer.set_use_kernel``,
``sasrec.set_use_kernel``, ``mp.set_use_kernel``), since a ctypes kernel
cannot take a fake tensor and the plain math has the same products.

Data-dependent reads cannot run on fake tensors, so the cells take the
static paths: the MoE all-to-all sizes its wire buffer statically
(``overflow="global"``, no ``moe_alltoall_exact_c_dev``), and the MoE
counts use ``moe.expert_counts`` / ``moe.one_hot_mean``, whose shapes do
not depend on the ids.

The ``rec_serve`` cells run ``sasrec.topk_catalog``, the serving
path's distributed top-k (the reference's ``_rec_serve``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import dist
from repro_torch.configs import get_arch
from repro_torch.dist import sharding as sh
from repro_torch.models import gnn, moe, mp, sasrec, transformer
from repro_torch.models.layers import ParamTree, map_tree, module_tree
from repro_torch.optim import AdamWConfig, adamw, make_train_step

TOP_K = 100


@dataclasses.dataclass
class Lowerable:
    fn: Callable
    args: tuple
    in_shardings: tuple
    meta: dict


def fake_mode():
    """A fake-tensor mode that raises on any op without a shape rule (no
    fallback runs a real kernel on zeros)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_fallback_kernels=False)


def _device(device) -> torch.device:
    """``"cuda"`` is the first card (a fake tensor's device needs an
    index)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", 0)
    return device


def _to(tree, device):
    """Every tensor of ``tree`` (made on the CPU under the fake mode) as a
    fake tensor on ``device``; other leaves as they are."""
    return map_tree(lambda _, x: x.to(device)
                    if isinstance(x, torch.Tensor) else x, tree)


def _fake(mode, shape, device, dtype=torch.int32):
    """A fake tensor of ``shape`` (int32 unless ``dtype`` says)."""
    with mode:
        return torch.empty(tuple(int(s) for s in shape), dtype=dtype,
                           device=device)


def _pad_to(x: int, m: int) -> int:
    return int(-(-x // m) * m)


def _mesh_total(mesh) -> int:
    return int(np.prod(list(mesh.shape.values())))


def _safe(axes, dim, mesh) -> Optional[object]:
    """Return axes if dim divides the mesh extent of axes, else None."""
    if axes is None:
        return None
    tup = axes if isinstance(axes, tuple) else (axes,)
    ext = int(np.prod([mesh.shape[a] for a in tup]))
    return axes if dim % ext == 0 else None


@contextlib.contextmanager
def plain_math():
    """The kernels' seams off, restored afterwards whatever happens."""
    seams = (transformer, sasrec, mp)
    saved = [m._USE_KERNEL for m in seams]
    for m in seams:
        m.set_use_kernel(False)
    try:
        yield
    finally:
        for m, flag in zip(seams, saved):
            m.set_use_kernel(flag)


def _plain(fn):
    def run(*args):
        with plain_math():
            return fn(*args)
    return run


OPT = AdamWConfig(lr=3e-4, warmup_steps=100, total_steps=10_000)


def _opt_specs(specs):
    return adamw.AdamWState(step=dist.P(), mu=specs, nu=specs)


def _model_and_opt(mode, tree, device):
    """A ``ParamTree`` of fake tensors on ``device`` and its AdamW
    state."""
    with mode:
        model = ParamTree(_to(tree, device))
        return model, adamw.init(dict(model.named_parameters()))


# ------------------------------------------------------------------ LM cells
def _lm_params(mode, cfg, mesh, device):
    with mode:
        params = transformer.init_params(cfg, seed=0, device="cpu")
        return _to(transformer.local_params(params, cfg, mesh), device)


def _lm_train(cfg, dims, mesh, variant, device):
    if variant == "moe_a2a" and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, moe_impl="a2a"))
    if variant == "no_remat":
        cfg = dataclasses.replace(cfg, remat="none")
    batch, seq = dims["batch"], dims["seq"]
    mode = fake_mode()
    with mode:
        params = transformer.init_params(cfg, seed=0, device="cpu")
        params = transformer.local_params(params, cfg, mesh)
    model, opt = _model_and_opt(mode, params, device)
    bspec = {"tokens": _fake(mode, (batch, seq), device),
             "labels": _fake(mode, (batch, seq), device)}
    step = make_train_step(
        lambda m, b: transformer.lm_loss(m.tree(), b, cfg), OPT)

    rule = sh.lm_param_rule(mesh, fsdp=(variant != "no_fsdp"))
    pshard = sh.shardings_for_tree(model.tree(), rule, mesh)
    dp = sh.dp_axes(mesh)
    bshard = {"tokens": dist.P(_safe(dp, batch, mesh), None),
              "labels": dist.P(_safe(dp, batch, mesh), None)}
    tokens = batch * seq
    meta = {
        "model_flops": 6.0 * cfg.n_active_params() * tokens,
        "model_flops_note": "6*N_active*D (train fwd+bwd)",
        "n_params": cfg.n_params(), "n_active_params": cfg.n_active_params(),
        "tokens_per_step": tokens,
    }
    return Lowerable(_plain(step), (model, opt, bspec),
                     (pshard, _opt_specs(pshard), bshard), meta)


def _lm_prefill(cfg, dims, mesh, variant, device):
    batch, seq = dims["batch"], dims["seq"]
    mode = fake_mode()
    params = _lm_params(mode, cfg, mesh, device)
    fn = lambda p, t: transformer.prefill(p, t, cfg)   # noqa: E731
    rule = sh.lm_param_rule(mesh, fsdp=(variant != "no_fsdp"))
    pshard = sh.shardings_for_tree(params, rule, mesh)
    dp = sh.dp_axes(mesh)
    # SP: batch over DP, sequence over 'model'
    tspec = dist.P(_safe(dp, batch, mesh), _safe("model", seq, mesh))
    tokens = batch * seq
    meta = {
        "model_flops": 2.0 * cfg.n_active_params() * tokens,
        "model_flops_note": "2*N_active*D (prefill fwd)",
        "n_params": cfg.n_params(), "n_active_params": cfg.n_active_params(),
        "tokens_per_step": tokens,
    }
    return Lowerable(_plain(fn),
                     (params, _fake(mode, (batch, seq), device)),
                     (pshard, tspec), meta)


def _lm_decode(cfg, dims, mesh, variant, device):
    if variant == "decode_splitk":
        cfg = dataclasses.replace(cfg, decode_attn="splitk")
    batch, seq = dims["batch"], dims["seq"]
    mode = fake_mode()
    params = _lm_params(mode, cfg, mesh, device)
    window_bounded = variant == "window_cache"
    with mode:
        # a split-K cache is this rank's block (the installed mesh)
        cache = _to(transformer.init_cache(
            cfg, batch, seq, device="cpu", window_bounded=window_bounded),
            device)
    fn = lambda p, c, t: transformer.decode_step(p, c, t, cfg)  # noqa: E731
    rule = sh.lm_param_rule(mesh, fsdp=(variant != "no_fsdp"))
    pshard = sh.shardings_for_tree(params, rule, mesh)
    dp = sh.dp_axes(mesh)
    bax = _safe(dp, batch, mesh)
    s_len = transformer.cache_len(cfg, seq, window_bounded)
    sax = _safe("model", s_len, mesh)
    cshard = {"k": dist.P(None, bax, sax, None, None),
              "v": dist.P(None, bax, sax, None, None),
              "len": dist.P(bax)}
    tshard = dist.P(bax, None)
    whole = (cfg.n_layers, batch, s_len, cfg.n_kv, cfg.d_head)
    meta = {
        "model_flops": 2.0 * cfg.n_active_params() * batch,
        "model_flops_note": "2*N_active per token (decode, B tokens)",
        "n_params": cfg.n_params(), "n_active_params": cfg.n_active_params(),
        "tokens_per_step": batch,
        "kv_bytes": float(np.prod(whole)) * 2 * 2,
    }
    return Lowerable(_plain(fn),
                     (params, cache, _fake(mode, (batch, 1), device)),
                     (pshard, cshard, tshard), meta)


# ----------------------------------------------------------------- GNN cells
def _gnn_batch(mode, cfg, dims, mesh, kind, device):
    total = _mesh_total(mesh)
    pad = lambda x: _pad_to(x, 512 if total <= 512 else total)  # noqa: E731
    if kind == "gnn_mol":
        n = pad(dims["batch"] * dims["n_nodes"])
        e = pad(dims["batch"] * dims["n_edges"])
        n_graphs = dims["batch"]
    else:
        n = pad(dims["n_nodes"])
        e = pad(dims["n_edges"])
        n_graphs = 1
    d_feat = dims["d_feat"]
    b = {
        "edge_src": _fake(mode, (e,), device),
        "edge_dst": _fake(mode, (e,), device),
        "graph_ids": _fake(mode, (n,), device),
    }
    if cfg.kind == "dimenet":
        b["species"] = _fake(mode, (n,), device)
        b["pos"] = _fake(mode, (n, 3), device, torch.float32)
        t = pad(e * 8)                        # cutoff-capped triplet fan-in
        b["trip_in"] = _fake(mode, (t,), device)
        b["trip_out"] = _fake(mode, (t,), device)
        b["labels"] = _fake(mode, (n_graphs,), device, torch.float32)
    else:
        b["x"] = _fake(mode, (n, d_feat), device, torch.float32)
        if cfg.task == "graph":
            b["labels"] = _fake(mode, (n_graphs,), device)
        else:
            b["labels"] = _fake(mode, (n,), device)
            b["label_mask"] = _fake(mode, (n,), device, torch.float32)
    return b, n, e, n_graphs


def _gnn_flops(cfg, n, e, t=0):
    """Analytic model flops for the GNN families (fwd+bwd = 3x fwd)."""
    h = cfg.d_hidden
    if cfg.kind == "gin":
        f = cfg.n_layers * (2 * n * h * h * 2 + 2 * e * h)
    elif cfg.kind == "pna":
        f = cfg.n_layers * (2 * e * (2 * h) * h + 4 * e * h
                            + 2 * n * (13 * h) * h)
    elif cfg.kind == "gat":
        f = cfg.n_layers * (2 * n * cfg.n_heads * h * h + 6 * e * h)
    else:  # dimenet
        f = cfg.n_layers * (2 * t * cfg.n_bilinear * h * h + 2 * e * h * h * 3)
    return 3.0 * f


def _gnn_train(cfg, dims, mesh, variant, kind, device):
    cfg = dataclasses.replace(cfg, d_feat=dims["d_feat"],
                              n_classes=dims.get("n_classes",
                                                 cfg.n_classes),
                              constrain_acts={"gnn_constrained": "all",
                                              "gnn_nodes": "nodes"}.get(
                                                  variant, ""))
    if kind == "gnn_mol" and cfg.kind != "dimenet":
        cfg = dataclasses.replace(cfg, task="graph")
    mode = fake_mode()
    batch, n, e, n_graphs = _gnn_batch(mode, cfg, dims, mesh, kind,
                                         device)
    with mode:
        tree = module_tree(gnn.init_model(cfg))
        model = gnn.GNN(cfg, tree=_to(tree, device))
        opt = adamw.init(dict(model.named_parameters()))

    def loss_fn(m, b):
        return gnn.gnn_loss(m, {**b, "n_graphs": n_graphs}, cfg)

    step = make_train_step(loss_fn, OPT)
    rule = sh.gnn_param_rule(mesh)
    pshard = sh.shardings_for_tree(dict(model.named_parameters()), rule,
                                   mesh)
    axes = tuple(mesh.axis_names)
    bspec = sh.gnn_batch_spec(mesh, full_graph=True)
    bshard = {}
    for k, v in batch.items():
        spec_k = bspec.get(k, dist.P(axes))
        if v.shape[0] == n_graphs and n_graphs % _mesh_total(mesh) != 0:
            spec_k = dist.P(*([None] * v.ndim))      # tiny: replicate
        bshard[k] = spec_k
    t = batch.get("trip_in")
    meta = {
        "model_flops": _gnn_flops(cfg, n, e,
                                  t.shape[0] if t is not None else 0),
        "model_flops_note": "analytic per-family (fwd+bwd=3x fwd)",
        "n_nodes": n, "n_edges": e,
    }
    return Lowerable(_plain(step), (model, opt, batch),
                     (pshard, _opt_specs(pshard), bshard), meta)


# -------------------------------------------------------------- recsys cells
def _rec_params(mode, cfg, device):
    with mode:
        return _to(sasrec.init_params(cfg, seed=0, device="cpu"), device)


def _rec_train(cfg, dims, mesh, variant, device):
    batch, seq = dims["batch"], cfg.seq_len
    mode = fake_mode()
    with mode:
        params = sasrec.init_params(cfg, seed=0, device="cpu")
    model, opt = _model_and_opt(mode, params, device)
    bspec = {k: _fake(mode, (batch, seq), device)
             for k in ("hist", "pos", "neg")}
    step = make_train_step(lambda m, b: sasrec.bce_loss(m.tree(), b, cfg),
                           OPT)
    rule = sh.recsys_param_rule(mesh)
    pshard = sh.shardings_for_tree(model.tree(), rule, mesh)
    dp = sh.dp_axes(mesh)
    bshard = {k: dist.P(_safe(dp, batch, mesh), None) for k in bspec}
    d = cfg.d_embed
    attn_f = cfg.n_blocks * (4 * batch * seq * d * d
                             + 2 * batch * seq * seq * d)
    emb_f = 2 * batch * seq * d * 3
    meta = {"model_flops": 3.0 * (attn_f + emb_f),
            "model_flops_note": "analytic fwd+bwd",
            "tokens_per_step": batch * seq}
    return Lowerable(_plain(step), (model, opt, bspec),
                     (pshard, _opt_specs(pshard), bshard), meta)


def _rec_serve(cfg, dims, mesh, variant, device):
    batch, seq = dims["batch"], cfg.seq_len
    mode = fake_mode()
    params = _rec_params(mode, cfg, device)

    def fn(p, hist):
        return sasrec.topk_catalog(p, hist, cfg, mesh, TOP_K)

    rule = sh.recsys_param_rule(mesh)
    pshard = sh.shardings_for_tree(params, rule, mesh)
    dp = sh.dp_axes(mesh)
    hshard = dist.P(_safe(dp, batch, mesh), None)
    rows = sasrec.table_rows(cfg)
    d = cfg.d_embed
    f = (cfg.n_blocks * (4 * batch * seq * d * d + 2 * batch * seq * seq * d)
         + 2 * batch * rows * d)
    meta = {"model_flops": float(f),
            "model_flops_note": "encode + full-catalog dot",
            "catalog_rows": rows}
    return Lowerable(_plain(fn),
                     (params, _fake(mode, (batch, seq), device)),
                     (pshard, hshard), meta)


def _rec_retrieval(cfg, dims, mesh, variant, device):
    batch, seq = dims["batch"], cfg.seq_len
    n_cand = dims["n_candidates"]
    mode = fake_mode()
    params = _rec_params(mode, cfg, device)
    fn = lambda p, h, c: sasrec.score_candidates(p, h, c, cfg)  # noqa: E731
    rule = sh.recsys_param_rule(mesh)
    pshard = sh.shardings_for_tree(params, rule, mesh)
    hshard = dist.P(None, None)
    cshard = dist.P(None, _safe("model", n_cand, mesh))
    d = cfg.d_embed
    f = cfg.n_blocks * (4 * batch * seq * d * d
                        + 2 * batch * seq * seq * d) + 2 * batch * n_cand * d
    meta = {"model_flops": float(f),
            "model_flops_note": "encode + 1M-candidate batched dot"}
    return Lowerable(_plain(fn), (params, _fake(mode, (batch, seq), device),
                                  _fake(mode, (batch, n_cand), device)),
                     (pshard, hshard, cshard), meta)


# ------------------------------------------------------------------ dispatch
_BUILDERS = {"lm_train": _lm_train, "lm_prefill": _lm_prefill,
             "lm_decode": _lm_decode, "rec_train": _rec_train,
             "rec_serve": _rec_serve, "rec_retrieval": _rec_retrieval}


def build_cell(kind: str, cfg, dims: dict, mesh, variant: str = "baseline",
               device="cuda") -> Lowerable:
    """The :class:`Lowerable` of a cell of shape kind ``kind`` for the
    config ``cfg`` at ``dims`` (a shape's dims, or a cut of them)."""
    device = _device(device)
    if kind in ("gnn_full", "gnn_mini", "gnn_mol"):
        return _gnn_train(cfg, dims, mesh, variant, kind, device)
    if kind not in _BUILDERS:
        raise ValueError(f"unknown shape kind {kind}")
    return _BUILDERS[kind](cfg, dims, mesh, variant, device)


def build(arch_id: str, shape_name: str, mesh, variant: str = "baseline",
          device="cuda") -> Lowerable:
    """The cell's :class:`Lowerable`, its arguments fake tensors on
    ``device`` (the card by default; ``"cpu"`` on a build of PyTorch
    without CUDA, whose indexing refuses even a fake CUDA tensor: the
    counts are the same)."""
    spec = get_arch(arch_id)
    shape = spec.shapes[shape_name]
    if shape.skip:
        raise ValueError(f"cell {arch_id}/{shape_name} skipped: {shape.skip}")
    return build_cell(shape.kind, spec.config, shape.dims, mesh, variant,
                      device)


def moe_layer(cfg, batch: int, seq: int, mesh, capacity_factor: float,
              device="cuda") -> Lowerable:
    """One MoE layer of the LM config ``cfg`` (router and experts, no
    shared experts) over ``batch`` x ``seq`` tokens, forward, through the
    all-to-all on this rank's experts under ``mesh``: the cell of
    ``chip_smoke.py``'s phase 7a."""
    device = _device(device)
    m = dataclasses.replace(cfg.moe, n_shared=0, moe_impl="a2a",
                            capacity_factor=capacity_factor)
    mode = fake_mode()
    with mode:
        p = moe.init_moe(torch.Generator().manual_seed(0), cfg.d_model, m,
                         cfg.tdtype)
        p = _to(moe.expert_block(p, mesh), device)
        x = torch.empty((batch, seq, cfg.d_model), dtype=cfg.tdtype,
                        device=device)
    t = batch * seq
    meta = {"model_flops": 2.0 * 3 * cfg.d_model * m.d_expert * m.top_k * t,
            "model_flops_note": "2*N_active*D (one MoE layer's experts)",
            "tokens_per_step": t}
    return Lowerable(_plain(lambda pp, xx: moe.moe_block(pp, xx, m)),
                     (p, x), (dist.P("model", None, None),
                              dist.P(None, None, None)), meta)
