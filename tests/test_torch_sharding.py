"""The port's parameter partition rules (``repro_torch.dist.sharding``)
give the reference's spec leaf for leaf, on abstract trees at full shape
(the reference's by ``jax.eval_shape``, the port's under
``FakeTensorMode``: no memory), for gemma3-1b, qwen3-moe, moonshot,
sasrec and gin-tu over the (16, 16), (2, 16, 16) and (2, 4) meshes, fsdp
on and off.  Both rules take a duck-typed mesh (``shape``,
``axis_names``): they need no devices.  Then a leaf's blocks by its spec
tile the leaf on every rank of a mesh."""

import itertools

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_arch as ref_get_arch
from repro.dist import sharding as RS
from repro.models import gnn as RG
from repro.models import sasrec as RR
from repro.models import transformer as RT
from repro_torch import dist
from repro_torch.configs import get_arch
from repro_torch.dist import sharding as PS
from repro_torch.models import gnn as PG
from repro_torch.models import sasrec as PR
from repro_torch.models import transformer as PT
from repro_torch.models.layers import flatten_tree, map_tree

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x4": {"data": 2, "model": 4}}
LMS = ["gemma3-1b", "qwen3-moe-235b-a22b", "moonshot-v1-16b-a3b"]


class DuckMesh:
    def __init__(self, shape, coord=None):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self._coord = coord or {}

    def coord(self, axis):
        return self._coord[axis]


def _key(k) -> str:
    return str(k.key if hasattr(k, "key") else k.idx)


def ref_specs(tree, rule) -> dict:
    """{dotted path: spec entries} of the reference's rule."""
    out = {}
    jax.tree_util.tree_map_with_path(
        lambda p, l: out.__setitem__(".".join(_key(k) for k in p),
                                     tuple(rule(p, l))), tree)
    return out


def flat_specs(specs) -> dict:
    """{dotted path: spec} of a tree of specs (a spec is a leaf)."""
    out = {}
    map_tree(lambda p, s: out.__setitem__(".".join(p), tuple(s)), specs,
             is_leaf=lambda x: isinstance(x, dist.Spec))
    return out


def port_specs(tree, rule, mesh) -> dict:
    return flat_specs(PS.shardings_for_tree(tree, rule, mesh))


_TREES = {}


def trees(arch: str):
    """(reference abstract tree, port abstract tree) at full shape."""
    if arch not in _TREES:
        rcfg = ref_get_arch(arch).config
        pcfg = get_arch(arch).config
        key = jax.random.PRNGKey(0)
        if arch in LMS:
            ref = jax.eval_shape(lambda k: RT.init_params(k, rcfg), key)
            with FakeTensorMode():
                port = PT.init_params(pcfg, device="cpu")
        elif arch == "sasrec":
            ref = jax.eval_shape(lambda k: RR.init_params(k, rcfg), key)
            with FakeTensorMode():
                port = PR.init_params(pcfg, device="cpu")
        else:
            ref = jax.eval_shape(lambda k: RG.init_params(k, rcfg), key)
            port = dict(PG.init_model(pcfg).named_parameters())
        _TREES[arch] = (ref, port)
    return _TREES[arch]


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", LMS)
def test_lm_param_rule_matches_reference(arch, mesh, fsdp):
    m = DuckMesh(MESHES[mesh])
    ref, port = trees(arch)
    want = ref_specs(ref, RS.lm_param_rule(m, fsdp=fsdp))
    got = port_specs(port, PS.lm_param_rule(m, fsdp=fsdp), m)
    assert got == want
    # the rules shard something at these widths
    assert any(any(e is not None for e in s) for s in got.values())


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch,ref_rule,port_rule", [
    ("sasrec", RS.recsys_param_rule, PS.recsys_param_rule),
    ("gin-tu", RS.gnn_param_rule, PS.gnn_param_rule)])
def test_recsys_and_gnn_rules_match_reference(arch, ref_rule, port_rule,
                                              mesh):
    m = DuckMesh(MESHES[mesh])
    ref, port = trees(arch)
    assert port_specs(port, port_rule(m), m) == ref_specs(ref, ref_rule(m))


def test_axes_and_batch_spec():
    for shape in MESHES.values():
        m = DuckMesh(shape)
        assert PS.dp_axes(m) == RS.dp_axes(m)
        assert PS.model_axis(m) == RS.model_axis(m)
        assert PS.gnn_batch_spec(m) == RS.gnn_batch_spec(m) == {}
    assert PS.dp_axes(None) == RS.dp_axes(None) == ()
    assert (PS.DP_AXIS_ORDER, PS.MIN_SHARD_DIM) == (RS.DP_AXIS_ORDER,
                                                     RS.MIN_SHARD_DIM)


def test_local_blocks_tile_each_leaf():
    """On every rank of a (pod 2, data 2, model 4) mesh, each leaf's block
    by the fsdp rule has ``block_shape``; the blocks of all ranks,
    placed by ``block_range``, cover the leaf once per rank of the axes
    its spec leaves out (replicas)."""
    shape = {"pod": 2, "data": 2, "model": 4}
    gen = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn((256, 8), generator=gen),
            "b": [torch.randn((4, 384), generator=gen)],
            "c": torch.randn((512, 1024), generator=gen)}
    specs = PS.shardings_for_tree(tree, PS.lm_param_rule(DuckMesh(shape)),
                                  DuckMesh(shape))
    assert flat_specs(specs)["c"] == (("pod", "data"), "model")
    cover = {k: torch.zeros(v.shape) for k, v in flatten_tree(tree).items()}
    for coord in itertools.product(*(range(n) for n in shape.values())):
        m = DuckMesh(shape, dict(zip(shape, coord)))
        blocks = flatten_tree(PS.local_blocks(tree, specs, m))
        for k, blk in blocks.items():
            leaf, spec = flatten_tree(tree)[k], flat_specs(specs)[k]
            assert tuple(blk.shape) == dist.block_shape(leaf.shape, spec, m)
            idx = tuple(slice(*dist.block_range(n, spec[d], m))
                        if d < len(spec) else slice(None)
                        for d, n in enumerate(leaf.shape))
            assert torch.equal(leaf[idx], blk)
            cover[k][idx] += 1
    for k, c in cover.items():
        used = {a for e in flat_specs(specs)[k] if e
                for a in ((e,) if isinstance(e, str) else e)}
        copies = int(np.prod([n for a, n in shape.items() if a not in used]))
        assert torch.equal(c, torch.full_like(c, copies)), k


def test_constrain_checks_the_spec_under_a_mesh():
    """Under a mesh a plain tensor comes back as it is, but a spec naming
    an axis the mesh lacks, or more dims than the tensor's, raises."""
    x = torch.zeros((4, 2))
    dist.set_mesh(DuckMesh({"data": 2, "model": 2}))
    try:
        assert dist.constrain(x, lambda m: dist.P(("data", "model"))) is x
        with pytest.raises(ValueError, match="pod"):
            dist.constrain(x, lambda m: dist.P("pod"))
        with pytest.raises(ValueError, match="dims"):
            dist.constrain(x, lambda m: dist.P(None, None, "model"))
    finally:
        dist.set_mesh(None)
    assert np.array_equal(dist.constrain(x, lambda m: dist.P("pod")), x)
