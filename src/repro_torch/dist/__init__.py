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
their launches; one run in a backward pass records under ``op.bwd``.

Autograd sees the collectives that carry float data, with JAX's
transposes (where autograd records through a tensor that needs a
gradient):

* a body's :func:`all_to_all` (equal splits over dim 0): the same
  all-to-all of the cotangent;
* a body's :func:`all_gather`: a reduce-scatter of the cotangent
  (``psum_scatter``);
* the :func:`shard_map` boundary, whose gathers are the port's own (the
  reference sees global arrays): a sharded output that every rank reads
  whole keeps this rank's block of the cotangent (every rank's loss is
  the same copy), scaled by 1 / the ranks over the mesh axes its spec
  does not name (those ranks hold the same output); a whole input,
  sliced to this rank's block, gets the whole cotangent back: a ``psum``
  over the axes its spec does not name, then one all-gather per
  sharded dim; a :class:`Held` input gets the ``psum`` over the axes its
  spec does not name (its ranks hold the same block), a :class:`Held`
  output the identity;
* :func:`psum`, :func:`pmax` and :func:`pmean` raise instead: no
  training path differentiates through them (``grad_sync`` works on
  gradients, split-K decode under ``no_grad``).

Tensors go to the backend where they lie: NCCL moves CUDA memory, and
gloo takes CUDA tensors too (through a host copy of its own), so ranks
that share one card run on gloo.

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
    group's; tensors stay on the device of the tensors passed in.
    ``held`` maps the name of each parameter that a model's
    ``local_params`` cut to this rank's block to its :class:`Held` spec
    (``optim.adamw.global_norm`` reads it under the installed mesh)."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.held: Dict[str, "Held"] = {}
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


def reassemble(x: torch.Tensor, spec, mesh,
               op: str = "all_gather") -> torch.Tensor:
    """The whole tensor from every rank's block ``x`` by ``spec``: one
    all-gather per sharded dim (the identity for a replicated spec)."""
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        if axes:
            parts = _gather(mesh, x, axes, op)
            x = torch.cat(parts.unbind(0), dim=dim)
    return x


def _unnamed(spec, mesh) -> Tuple[str, ...]:
    """The mesh axes of more than one rank that ``spec`` does not name
    (in mesh order): its tensor is the same on each of their ranks."""
    named = {a for entry in spec for a in _axes(entry)}
    return tuple(a for a in mesh.axis_names
                 if a not in named and int(mesh.shape[a]) > 1)


def _records(x) -> bool:
    return isinstance(x, torch.Tensor) and torch.is_grad_enabled() \
        and x.requires_grad


def _psum_unnamed(g, spec, mesh):
    axes = _unnamed(spec, mesh)
    return _reduce_raw(mesh, g, axes, tdist.ReduceOp.SUM, "psum.bwd") \
        if axes else g


class _BlockIn(torch.autograd.Function):
    """A whole input sliced to this rank's block; backward: the whole
    cotangent (``psum`` over the unnamed axes, then the gathers)."""

    @staticmethod
    def forward(ctx, x, spec, mesh):
        ctx.spec, ctx.mesh = spec, mesh
        return local_block(x, spec, mesh).clone()

    @staticmethod
    def backward(ctx, g):
        g = _psum_unnamed(g, ctx.spec, ctx.mesh)
        return reassemble(g, ctx.spec, ctx.mesh, "all_gather.bwd"), None, \
            None


class _HeldIn(torch.autograd.Function):
    """A held block, the same on the ranks of the axes its spec does not
    name; backward: the ``psum`` of the cotangent over them."""

    @staticmethod
    def forward(ctx, x, spec, mesh):
        ctx.spec, ctx.mesh = spec, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _psum_unnamed(g, ctx.spec, ctx.mesh), None, None


class _WholeOut(torch.autograd.Function):
    """A sharded output reassembled whole; backward: this rank's block
    of the cotangent over the ranks that hold the same block."""

    @staticmethod
    def forward(ctx, x, spec, mesh):
        ctx.spec, ctx.mesh = spec, mesh
        return reassemble(x, spec, mesh)

    @staticmethod
    def backward(ctx, g):
        blk = local_block(g, ctx.spec, ctx.mesh)
        n = axis_size(ctx.mesh, _unnamed(ctx.spec, ctx.mesh))
        return (blk / n if n > 1 else blk.clone()), None, None


def _enter(x, spec, mesh):
    """A ``shard_map`` input as its body sees it (module docstring)."""
    if isinstance(spec, Held):
        if _records(x) and _unnamed(spec, mesh):
            return _HeldIn.apply(x, spec, mesh)
        return x
    if _records(x):
        return _BlockIn.apply(x, spec, mesh)
    return local_block(x, spec, mesh)


def _leave(x, spec, mesh):
    """A ``shard_map`` output as its caller sees it."""
    if isinstance(spec, Held):
        return x
    if _records(x):
        return _WholeOut.apply(x, spec, mesh)
    return reassemble(x, spec, mesh)


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
        local = [_map(lambda x, s: _enter(x, s, mesh), a, s)
                 for a, s in zip(args, in_specs)]
        outer, _BODY = _BODY, mesh
        try:
            out = f(*local)
        finally:
            _BODY = outer

        def whole(x, s):
            return _leave(x, s, mesh)
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


def _gather(mesh: Mesh, x: torch.Tensor, axes, op: str) -> torch.Tensor:
    axes = _axes(axes)
    _record(op, axes, x.numel() * x.element_size())
    group = mesh.group(axes)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(tdist.get_world_size(group))]
    tdist.all_gather(parts, x, group=group)
    return torch.stack(parts)


def _a2a(mesh: Mesh, x: torch.Tensor, axes, op: str) -> torch.Tensor:
    _record(op, axes, x.numel() * x.element_size())
    x = x.contiguous()
    out = torch.empty_like(x)
    tdist.all_to_all_single(out, x, group=mesh.group(axes))
    return out


def _reduce_raw(mesh: Mesh, x: torch.Tensor, axes, how,
                op: str) -> torch.Tensor:
    _record(op, axes, x.numel() * x.element_size())
    out = x.clone(memory_format=torch.contiguous_format)
    tdist.all_reduce(out, op=how, group=mesh.group(axes))
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _gather(mesh, x, axes, "all_gather")

    @staticmethod
    def backward(ctx, g):
        # JAX's transpose, psum_scatter: the sum over the group of every
        # rank's cotangent, this rank's row of it (an all-reduce, then
        # the row: gloo has no reduce-scatter)
        mesh, axes = ctx.mesh, ctx.axes
        total = _reduce_raw(mesh, g, axes, tdist.ReduceOp.SUM,
                            "psum_scatter.bwd")
        return total[_index(mesh, axes)], None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _a2a(mesh, x, axes, "all_to_all")

    @staticmethod
    def backward(ctx, g):
        # equal splits over dim 0: the all-to-all is its own transpose
        return _a2a(ctx.mesh, g, ctx.axes, "all_to_all.bwd"), None, None


def axis_index(axes) -> int:
    """This rank's row-major coordinate over ``axes`` (a Python int where
    ``jax.lax.axis_index`` gives a traced one)."""
    return _index(_body(), _axes(axes))


def all_gather(x: torch.Tensor, axes) -> torch.Tensor:
    """Every rank's ``x`` over ``axes``, stacked on a new leading dim in
    row-major rank order."""
    mesh, axes = _body(), _axes(axes)
    if _records(x):
        return _AllGather.apply(x, mesh, axes)
    return _gather(mesh, x, axes, "all_gather")


def all_to_all(x: torch.Tensor, axes, split_axis: int = 0,
               concat_axis: int = 0) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axes, 0, 0)``: chunk j of dim 0 goes to
    rank j of the group, and chunk j of the result came from rank j."""
    if split_axis != 0 or concat_axis != 0:
        raise ValueError("all_to_all splits and concatenates dim 0 only")
    mesh, axes = _body(), _axes(axes)
    if _records(x):
        return _AllToAll.apply(x, mesh, axes)
    return _a2a(mesh, x, axes, "all_to_all")


def _reduce(op: str, x: torch.Tensor, axes, how) -> torch.Tensor:
    if _records(x):
        raise RuntimeError(
            f"dist.{op} has no backward: no training path differentiates "
            f"through it; run it under torch.no_grad() or on a tensor "
            f"that needs no gradient")
    mesh, axes = _body(), _axes(axes)
    return _reduce_raw(mesh, x, axes, how, op)


def psum(x: torch.Tensor, axes) -> torch.Tensor:
    return _reduce("psum", x, axes, tdist.ReduceOp.SUM)


def pmax(x: torch.Tensor, axes) -> torch.Tensor:
    return _reduce("pmax", x, axes, tdist.ReduceOp.MAX)


def pmean(x: torch.Tensor, axes) -> torch.Tensor:
    return psum(x, axes) / axis_size(_body(), axes)


def held_sum(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The sum of ``x``, a value this rank computed from its block of a
    tensor held by ``spec``, over the ranks that hold the other blocks:
    a ``psum`` over the axes ``spec`` names (outside a body; no
    backward)."""
    named = {a for entry in spec for a in _axes(entry)}
    axes = tuple(a for a in mesh.axis_names if a in named)
    if not axes:
        return x
    if _records(x):
        raise RuntimeError("dist.held_sum has no backward")
    return _reduce_raw(mesh, x, axes, tdist.ReduceOp.SUM, "psum")


from . import collectives, sharding  # noqa: E402,F401
