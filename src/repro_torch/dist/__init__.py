"""Distributed utilities on ``torch.distributed``: the mesh registry,
sharding-constraint helpers and the port's form of ``shard_map``.

The models reference a process-global mesh so the same forward functions
run unmodified in one process (mesh unset -> every helper is an identity
/ trivial answer) and in one process per rank of a mesh (:func:`set_mesh`
installs it).  A mesh is a :class:`Mesh`: a
``torch.distributed.device_mesh.DeviceMesh`` whose dims are named
``"pod"``, ``"data"`` and ``"model"``, read as the reference reads a jax
mesh (``mesh.shape[axis]``, ``mesh.axis_names``).

The reference's models see global arrays and GSPMD shards them; the port
has no partitioner and shards explicitly:

* activations the reference's models see whole are whole on every rank,
  and the dense parts run replicated;
* a tensor that a :func:`shard_map` consumes by a sharded spec is either
  whole on every rank (the body gets this rank's block, and a sharded
  output is reassembled whole by an all-gather) or held by each rank as
  its own block, which the spec says with :class:`Held` (the expert
  weights, the split-K KV cache);
* inside a body, :func:`axis_index`, :func:`all_gather`,
  :func:`all_to_all`, :func:`psum`, :func:`pmax` and :func:`pmean` act
  over the named dims' process groups, a tuple of axes taken row-major as
  one group, like their ``jax.lax`` namesakes.

Every collective records (op, axes, bytes this rank hands it) in
:data:`counts` (reset by :func:`reset_counts`), as the kernels count
their launches.  Tensors go to the backend where they lie: NCCL moves
CUDA memory, and gloo takes CUDA tensors too (through a host copy of
its own), so ranks that share one card run on gloo.

Spec arguments to :func:`constrain` are FUNCTIONS of the mesh (e.g.
``lambda m: P(dp_axes(m), "model")``) so model code never has to know
which axes exist in the current deployment.
"""

from __future__ import annotations

import itertools
import math
from typing import Callable, Dict, Sequence, Tuple, Union

import torch
import torch.distributed as tdist

_MESH = None
_BODY = None          # the mesh of the shard_map body being run

#: "op@axis+axis" -> {"calls": n, "bytes": b} for every collective call
counts: Dict[str, Dict[str, int]] = {}


class Spec(tuple):
    """A partition spec: one entry per leading dim (None, an axis name or
    a tuple of axis names), in the reference's ``PartitionSpec`` order;
    dims past its length are unsharded."""

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def P(*dims) -> Spec:
    return Spec(dims)


class Held(Spec):
    """A spec whose tensor each rank already holds as its own block (an
    input), or keeps as its block (an output): not sliced, not
    reassembled."""


class Mesh:
    """A ``DeviceMesh`` read as the reference reads a jax ``Mesh``:
    ``shape`` maps each axis name to its size, ``axis_names`` lists them
    outermost first.  Built by :func:`make_mesh` on every rank (it makes
    the process group of every tuple of two or more axes, row-major, so
    all ranks must build it together).  ``backend`` is the process
    group's; tensors stay on the device of the tensors passed in."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        sizes = tuple(int(s) for s in device_mesh.mesh.shape)
        self.shape = dict(zip(self.axis_names, sizes))
        self.backend = tdist.get_backend()
        self._coord = dict(zip(self.axis_names,
                               device_mesh.get_coordinate()))
        self._groups = {(a,): device_mesh.get_group(a)
                        for a in self.axis_names}
        ranks = device_mesh.mesh
        for n in range(2, len(sizes) + 1):
            for axes in itertools.combinations(range(len(sizes)), n):
                rest = [i for i in range(len(sizes)) if i not in axes]
                lists = ranks.permute(*rest, *axes).reshape(
                    -1, math.prod(sizes[i] for i in axes)).tolist()
                mine, _ = tdist.new_subgroups_by_enumeration(lists)
                self._groups[tuple(self.axis_names[i] for i in axes)] = mine

    def group(self, axes: Tuple[str, ...]):
        """The process group over ``axes`` (in mesh order)."""
        try:
            return self._groups[axes]
        except KeyError:
            raise ValueError(f"axes {axes} are not a tuple of the mesh's "
                             f"axes {self.axis_names} in mesh order")

    def coord(self, axis: str) -> int:
        return self._coord[axis]


def make_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    """A :class:`Mesh` of ``shape`` over every rank of the initialised
    process group (its size must be the product of ``shape``), ranks laid
    out row-major; run by every rank."""
    if not tdist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    world = tdist.get_world_size()
    if math.prod(shape) != world:
        raise RuntimeError(f"mesh {tuple(shape)} needs a world of "
                           f"{math.prod(shape)} ranks; the process group "
                           f"has {world}")
    from torch.distributed.device_mesh import init_device_mesh
    kind = "cuda" if tdist.get_backend() == "nccl" else "cpu"
    return Mesh(init_device_mesh(kind, tuple(shape),
                                 mesh_dim_names=tuple(axes)))


def set_mesh(mesh) -> None:
    """Install the process-global mesh (None to clear)."""
    global _MESH
    _MESH = mesh


def get_mesh():
    """The installed mesh, or None (single-process mode)."""
    return _MESH


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def axis_size(mesh, axes: Union[None, str, Sequence[str]]) -> int:
    """Product of the named mesh axis sizes (1 when unset/empty)."""
    if mesh is None or axes is None:
        return 1
    size = 1
    for a in _axes(axes):
        size *= int(mesh.shape[a])
    return size


def _index(mesh, axes: Tuple[str, ...]) -> int:
    """This rank's row-major coordinate over ``axes``."""
    i = 0
    for a in axes:
        i = i * int(mesh.shape[a]) + mesh.coord(a)
    return i


def _check_spec(spec, ndim: int, mesh) -> None:
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the tensor's "
                         f"{ndim} dims")
    for entry in spec:
        for a in _axes(entry):
            if a not in mesh.axis_names:
                raise ValueError(f"spec {spec} names axis {a!r}, not one "
                                 f"of the mesh's {mesh.axis_names}")


def constrain(x, spec_fn: Callable):
    """The reference's ``with_sharding_constraint(x, spec_fn(mesh))``
    under the global mesh; identity when no mesh is installed.

    With a mesh, a plain tensor is returned as it is: the port keeps the
    activations the reference's models see whole on every rank, so a
    constraint names a placement that only an explicit :func:`shard_map`
    acts on.  The spec is still evaluated and checked against ``x`` (no
    more entries than dims, only the mesh's axis names), so a wrong spec
    raises as the reference's would."""
    mesh = _MESH
    if mesh is None:
        return x
    _check_spec(spec_fn(mesh), x.ndim, mesh)
    return x


def block_range(size: int, entry, mesh) -> Tuple[int, int]:
    """[lo, hi) of this rank's block of a dim of ``size`` sharded by the
    spec entry ``entry``."""
    axes = _axes(entry)
    n = axis_size(mesh, axes)
    if size % n:
        raise ValueError(f"a dim of {size} does not divide over {axes} "
                         f"of {n} ranks")
    step = size // n
    i = _index(mesh, axes)
    return i * step, (i + 1) * step


def block_shape(shape: Sequence[int], spec, mesh) -> Tuple[int, ...]:
    """The shape of each rank's block of a tensor of ``shape``."""
    return tuple(s // axis_size(mesh, spec[d]) if d < len(spec) else s
                 for d, s in enumerate(shape))


def local_block(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block (a view) of the whole tensor ``x`` by ``spec``."""
    _check_spec(spec, x.ndim, mesh)
    for dim, entry in enumerate(spec):
        if _axes(entry):
            lo, hi = block_range(x.shape[dim], entry, mesh)
            x = x.narrow(dim, lo, hi - lo)
    return x


def reassemble(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole tensor from every rank's block ``x`` by ``spec``: one
    all-gather per sharded dim (the identity for a replicated spec)."""
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        if axes:
            parts = _all_gather(mesh, x, axes)
            x = torch.cat(parts.unbind(0), dim=dim)
    return x


def _map(fn, tree, spec):
    """``fn(leaf, spec)`` over a tree under one spec (a prefix spec, as
    the reference's ``P()`` over a gradient pytree)."""
    from repro_torch.models.layers import map_tree
    return map_tree(lambda _, x: fn(x, spec), tree)


def shard_map(f, *, mesh, in_specs, out_specs):
    """The port's ``jax.shard_map``: ``shard_map(f, mesh=, in_specs=,
    out_specs=)(*args)`` runs ``f`` on this rank's blocks and returns the
    outputs whole, except where a spec is :class:`Held` (module
    docstring).  A spec applies to every leaf of a tree argument;
    ``out_specs`` is one spec or a tuple of them, one per output."""

    def run(*args):
        global _BODY
        local = [_map(lambda x, s: x if isinstance(s, Held)
                      else local_block(x, s, mesh), a, s)
                 for a, s in zip(args, in_specs)]
        outer, _BODY = _BODY, mesh
        try:
            out = f(*local)
        finally:
            _BODY = outer

        def whole(x, s):
            return x if isinstance(s, Held) else reassemble(x, s, mesh)
        if isinstance(out_specs, Spec):
            return _map(whole, out, out_specs)
        return tuple(_map(whole, o, s) for o, s in zip(out, out_specs))

    return run


# ------------------------------------------------------- body vocabulary
def reset_counts() -> None:
    counts.clear()


def _record(op: str, axes: Tuple[str, ...], nbytes: int) -> None:
    key = f"{op}@{'+'.join(axes)}"
    c = counts.get(key, {"calls": 0, "bytes": 0})
    # a new dict each time: a copy of ``counts`` stays as it was
    counts[key] = {"calls": c["calls"] + 1, "bytes": c["bytes"] + nbytes}


def _body() -> Mesh:
    if _BODY is None:
        raise RuntimeError("collectives run inside dist.shard_map, as "
                           "jax.lax's collectives run inside jax.shard_map")
    return _BODY


def _all_gather(mesh: Mesh, x: torch.Tensor, axes) -> torch.Tensor:
    axes = _axes(axes)
    _record("all_gather", axes, x.numel() * x.element_size())
    group = mesh.group(axes)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(tdist.get_world_size(group))]
    tdist.all_gather(parts, x, group=group)
    return torch.stack(parts)


def axis_index(axes) -> int:
    """This rank's row-major coordinate over ``axes`` (a Python int where
    ``jax.lax.axis_index`` gives a traced one)."""
    return _index(_body(), _axes(axes))


def all_gather(x: torch.Tensor, axes) -> torch.Tensor:
    """Every rank's ``x`` over ``axes``, stacked on a new leading dim in
    row-major rank order."""
    return _all_gather(_body(), x, axes)


def all_to_all(x: torch.Tensor, axes, split_axis: int = 0,
               concat_axis: int = 0) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axes, 0, 0)``: chunk j of dim 0 goes to
    rank j of the group, and chunk j of the result came from rank j."""
    if split_axis != 0 or concat_axis != 0:
        raise ValueError("all_to_all splits and concatenates dim 0 only")
    mesh, axes = _body(), _axes(axes)
    _record("all_to_all", axes, x.numel() * x.element_size())
    x = x.contiguous()
    out = torch.empty_like(x)
    tdist.all_to_all_single(out, x, group=mesh.group(axes))
    return out


def _reduce(op: str, x: torch.Tensor, axes, how) -> torch.Tensor:
    mesh, axes = _body(), _axes(axes)
    _record(op, axes, x.numel() * x.element_size())
    out = x.clone(memory_format=torch.contiguous_format)
    tdist.all_reduce(out, op=how, group=mesh.group(axes))
    return out


def psum(x: torch.Tensor, axes) -> torch.Tensor:
    return _reduce("psum", x, axes, tdist.ReduceOp.SUM)


def pmax(x: torch.Tensor, axes) -> torch.Tensor:
    return _reduce("pmax", x, axes, tdist.ReduceOp.MAX)


def pmean(x: torch.Tensor, axes) -> torch.Tensor:
    return psum(x, axes) / axis_size(_body(), axes)


from . import collectives, sharding  # noqa: E402,F401
