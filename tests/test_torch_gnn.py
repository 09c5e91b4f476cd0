"""The port's GNNs (``repro_torch.models.gnn``) == the reference's at
``test_models_smoke.reduced_gnn`` size (2 layers, d = 16), with the
reference's JAX-initialised parameters carried across by
``params_from_jax``: forward (1e-5), loss and gradients (1e-4), and one
AdamW step (1e-5), for the node task and for the graph task on
``batch_molecules``.  The AdamW step is checked twice: the port's update
fed the reference's gradients matches everywhere; the port's whole train
step (its own gradients) matches wherever the reference gradient exceeds
1e-6 in magnitude.  Below that a first Adam step is ill-conditioned:
``m̂/(sqrt(v̂)+eps)`` with eps = 1e-8 turns a 1e-8 gradient's last-digit
differences (PNA's std aggregator amplifies them through its sqrt
floor) into differences of order lr.

DimeNet's batches here have no degenerate triplets (no self-loops, so no
zero-length edge and no cos = +-1 angle): at cos = +-1 exactly,
``jnp.clip`` splits the arccos gradient at the bound where
``torch.clamp`` passes it, so gradients are compared only where both are
defined the same way.  Batches also have no repeated edge: a segment of
identical PNA messages has a variance that is pure rounding noise, and
the std aggregator's ``sqrt(max(var, 1e-8))`` turns the two frameworks'
different summation orders there into differences of ~1e-4 in its
output, a property of the model and not of the port."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.data import graphs as G
from repro.models import gnn as ref_gnn
from repro.optim import adamw as ref_adamw
from repro_torch.configs import get_arch
from repro_torch.models import gnn
from repro_torch.models.layers import flatten_tree
from repro_torch.optim import adamw

ARCHS = ["gin-tu", "pna", "gat-cora", "dimenet"]
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def reduced(cfg, **kw):
    return dataclasses.replace(cfg, n_layers=2, d_hidden=16, d_feat=8,
                               n_classes=3, **kw)


def no_self_loops(src, dst):
    """Drop self-loops and repeated edges (first occurrence kept)."""
    keep = src != dst
    _, first = np.unique(np.stack([src, dst]), axis=1, return_index=True)
    keep &= np.isin(np.arange(src.size), first)
    return src[keep], dst[keep]


def node_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    n, e = 20, 60
    src, dst = no_self_loops(*G.random_graph(rng, n, e))
    b = {"edge_src": src, "edge_dst": dst,
         "graph_ids": np.zeros((n,), np.int32), "n_graphs": 1}
    if cfg.kind == "dimenet":
        b["species"] = rng.integers(0, 8, n).astype(np.int32)
        b["pos"] = rng.normal(size=(n, 3)).astype(np.float32)
        b["labels"] = np.asarray([1.0], np.float32)
        b["trip_in"], b["trip_out"] = G.build_triplets(src, dst,
                                                       max_per_edge=4)
    else:
        b["x"] = rng.normal(size=(n, cfg.d_feat)).astype(np.float32)
        b["labels"] = rng.integers(0, cfg.n_classes, n).astype(np.int32)
        b["label_mask"] = (rng.random(n) < 0.7).astype(np.float32)
    return b


def mol_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    mb = G.batch_molecules(rng, n_graphs=4, n_nodes=6, n_edges=10,
                           d_feat=cfg.d_feat, with_pos=True)
    mb["edge_src"], mb["edge_dst"] = no_self_loops(mb["edge_src"],
                                                   mb["edge_dst"])
    if cfg.kind == "dimenet":
        mb["trip_in"], mb["trip_out"] = G.build_triplets(
            mb["edge_src"], mb["edge_dst"], max_per_edge=4)
        mb["labels"] = rng.normal(size=(4,)).astype(np.float32)
    else:
        mb["labels"] = rng.integers(0, cfg.n_classes, 4).astype(np.int32)
    return mb


def to_jax(b):
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
            for k, v in b.items()}


def to_torch(b):
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
            for k, v in b.items()}


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def check_arch(arch_id, task, make_batch):
    ref_cfg = reduced(ref_get_arch(arch_id).config)
    cfg = reduced(get_arch(arch_id).config)
    if task is not None and cfg.kind != "dimenet":
        ref_cfg = dataclasses.replace(ref_cfg, task=task)
        cfg = dataclasses.replace(cfg, task=task)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    b = make_batch(cfg, 7)
    params = ref_gnn.init_params(jax.random.PRNGKey(0), ref_cfg)
    model = gnn.params_from_jax(np_tree(params), cfg)
    assert sorted(dict(model.named_parameters())) == sorted(
        flatten_tree(np_tree(params)))

    jb, tb = to_jax(b), to_torch(b)
    want = np.asarray(ref_gnn.forward(params, jb, ref_cfg))
    got = model(tb)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)

    (loss_ref, _), grads_ref = jax.value_and_grad(
        lambda p: ref_gnn.gnn_loss(p, jb, ref_cfg), has_aux=True)(params)
    ref_opt = ref_adamw.AdamWConfig(**OPT)
    new_ref, _, om_ref = ref_adamw.update(
        ref_opt, grads_ref, ref_adamw.init(params), params)

    step = adamw.make_train_step(lambda m, bb: gnn.gnn_loss(m, bb, cfg),
                                 adamw.AdamWConfig(**OPT))
    named = dict(model.named_parameters())
    loss, _ = gnn.gnn_loss(model, tb, cfg)
    grads = torch.autograd.grad(loss, list(named.values()))
    np.testing.assert_allclose(float(loss.detach()), float(loss_ref),
                               rtol=1e-4, atol=1e-4)
    flat_g = flatten_tree(np_tree(grads_ref))
    for name, g in zip(named, grads):
        # 1e-4 relative, and 1e-4 of the tensor's largest entry absolute
        # (the graph task's gradients reach O(100), where an element of
        # 1e-3 carries fp32 rounding from much larger terms)
        scale = max(1.0, float(np.abs(flat_g[name]).max()))
        np.testing.assert_allclose(g.numpy(), flat_g[name], rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)

    flat_new = flatten_tree(np_tree(new_ref))
    same_grads = {k: torch.from_numpy(v) for k, v in flat_g.items()}
    upd, _, _ = adamw.update(adamw.AdamWConfig(**OPT), same_grads,
                             adamw.init(named),
                             {k: p.detach() for k, p in named.items()})
    for name, p in upd.items():
        np.testing.assert_allclose(p.numpy(), flat_new[name], rtol=1e-5,
                                   atol=1e-5, err_msg=name)

    model, _, m = step(model, adamw.init(named), tb)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(om_ref["grad_norm"]), rtol=1e-4)
    for name, p in model.named_parameters():
        sure = np.abs(flat_g[name]) > 1e-6
        np.testing.assert_allclose(p.detach().numpy()[sure],
                                   flat_new[name][sure], rtol=1e-5,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_node_task_matches_reference(arch_id):
    check_arch(arch_id, None, node_batch)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_graph_task_on_molecules_matches_reference(arch_id):
    check_arch(arch_id, "graph", mol_batch)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_torch_init_and_param_names(arch_id):
    """A port-initialised model has the reference's parameter names and
    shapes, is reproducible from its generator, and runs forward."""
    cfg = reduced(get_arch(arch_id).config)
    ref_cfg = reduced(ref_get_arch(arch_id).config)
    ref_shapes = {k: v.shape for k, v in flatten_tree(np_tree(
        ref_gnn.init_params(jax.random.PRNGKey(1), ref_cfg))).items()}
    a = gnn.init_model(cfg, torch.Generator().manual_seed(5))
    b = gnn.init_model(cfg, torch.Generator().manual_seed(5))
    assert {k: tuple(p.shape) for k, p in a.named_parameters()} == ref_shapes
    for (_, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q)
    out = a(to_torch(node_batch(cfg, 3)))
    assert torch.isfinite(out).all()
    # carrying a tree across is name-for-name
    tree = np_tree(ref_gnn.init_params(jax.random.PRNGKey(2), ref_cfg))
    c = gnn.params_from_jax(tree, cfg)
    for name, p in c.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      flatten_tree(tree)[name])


def test_gin_eps_is_trained_whatever_the_flag_says():
    """As in the reference, GIN's eps gets a gradient and an update even
    with eps_learnable=False (the flag is never read)."""
    cfg = dataclasses.replace(reduced(get_arch("gin-tu").config),
                              eps_learnable=False)
    model = gnn.init_model(cfg)
    loss, _ = gnn.gnn_loss(model, to_torch(node_batch(cfg, 1)), cfg)
    loss.backward()
    assert model.layers[0].eps.grad is not None
    assert float(model.layers[0].eps.grad.abs()) > 0
