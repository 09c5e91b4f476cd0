"""Mesh-axis naming conventions and name-based parameter partition
rules shared by the models and launchers.

Axis vocabulary (see ``launch.mesh``): ``model`` is tensor parallelism;
``data`` and (multi-pod) ``pod`` are pure data parallelism.

Parameter rules are *conservative shape heuristics*: any returned spec
is a valid placement, so correctness never depends on them.  A spec is
a ``dist.P`` tuple per leaf, in the reference's ``PartitionSpec`` order.
The port's models run their dense parts replicated and shard explicitly
(``dist.shard_map``), so these specs place nothing on the path; they are
what a placement by the reference's rules would hold per rank
(:func:`local_blocks`).
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

from repro_torch import dist

#: data-parallel axis names, outermost first
DP_AXIS_ORDER = ("pod", "data")

#: don't bother sharding axes smaller than this
MIN_SHARD_DIM = 128


def dp_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel axes present in ``mesh`` (outermost first)."""
    if mesh is None:
        return ()
    return tuple(a for a in DP_AXIS_ORDER if a in mesh.axis_names)


def model_axis(mesh) -> str:
    return "model"


def _heuristic_rule(mesh, fsdp: bool) -> Callable:
    dp = dp_axes(mesh)
    n_model = int(mesh.shape["model"]) if "model" in mesh.axis_names else 1
    n_dp = int(math.prod(int(mesh.shape[a]) for a in dp)) if dp else 1

    def rule(path, leaf) -> dist.Spec:
        shape = getattr(leaf, "shape", ())
        spec = [None] * len(shape)
        if n_model > 1:
            # tensor parallelism: last large divisible axis over 'model'
            for ax in reversed(range(len(shape))):
                if shape[ax] >= MIN_SHARD_DIM and shape[ax] % n_model == 0:
                    spec[ax] = "model"
                    break
        if fsdp and n_dp > 1:
            # fully-sharded storage: first remaining divisible axis
            for ax in range(len(shape)):
                if (spec[ax] is None and shape[ax] >= MIN_SHARD_DIM
                        and shape[ax] % n_dp == 0):
                    spec[ax] = dp if len(dp) > 1 else dp[0]
                    break
        return dist.P(*spec)

    return rule


def lm_param_rule(mesh, fsdp: bool = True) -> Callable:
    return _heuristic_rule(mesh, fsdp)


def gnn_param_rule(mesh) -> Callable:
    return _heuristic_rule(mesh, fsdp=False)


def recsys_param_rule(mesh) -> Callable:
    return _heuristic_rule(mesh, fsdp=False)


def shardings_for_tree(tree, rule: Callable, mesh):
    """Apply a (path, leaf) -> spec rule over a parameter tree (walked by
    ``layers.map_tree``): the tree of specs."""
    from repro_torch.models.layers import map_tree
    return map_tree(rule, tree)


def local_blocks(tree, specs, mesh):
    """Each leaf's block on this rank by its spec (``specs``: the tree
    :func:`shardings_for_tree` gives)."""
    from repro_torch.models.layers import map_tree
    return map_tree(lambda _, x, s: dist.local_block(x, s, mesh), tree,
                    specs)


def gnn_batch_spec(mesh, full_graph: bool = False) -> dict:
    """Per-key overrides for GNN batch arrays; callers default any key
    not listed here to first-dim sharding over all mesh axes."""
    return {}
