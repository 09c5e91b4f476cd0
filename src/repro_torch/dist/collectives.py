"""Explicit shard_map collectives (MoE all-to-all, hierarchical grad
sync, cross-pod allreduce) on ``torch.distributed``.

Overflow semantics of the MoE all-to-all (parity with the scatter path)
-----------------------------------------------------------------------
The scatter path (``models/moe.moe_block``) drops (token, slot) pairs
per **global expert** once the expert's capacity ``C`` is full, in
global flattened ``(T, k)`` order.  The all-to-all dispatch only sees
rank-local tokens, so a naive local capacity check drops a *different*
set of pairs under overflow.  ``moe_alltoall_block`` reproduces the
scatter semantics exactly (``overflow="global"``, the default): each
rank computes its tokens' **global** position inside their expert with
one extra all-gather of the per-expert local counts (an
``(n_ranks, E)`` int32 exchange — negligible next to the activation
all-to-alls) and applies the same ``pos < capacity`` cut.  The wire
buffer ``c_dev`` is then clamped to the static bound
``min(t_loc*k, e_loc*capacity)`` so no kept pair can secondarily
overflow a (source rank, destination shard) slab.  The legacy
per-(source rank, destination shard) drop rule survives behind
``overflow="local"`` for callers that prefer a smaller wire buffer over
drop parity; any other value, or ``overflow="global"`` without a
``capacity``, is an explicit config error (``ValueError``).

Two-phase exact sizing
----------------------
The static bound is safe but often far larger than what any (source
rank, destination shard) slab actually carries — the all-to-all then
ships mostly zeros.  :func:`moe_alltoall_exact_c_dev` is a cheap
phase-1 counting pass over the *logits only* (same routing math, same
keep mask — factored into ``_route_keep`` so the two cannot drift) that
returns the exact max kept-pairs-per-slab, rounded up to a multiple of
8.  Passing its result with ``exact_c_dev=True`` skips the static clamp;
outputs are elementwise identical for ANY ``c_dev`` >= the true max.
(The reference also refuses to size under jit, where the count would be
a tracer; the port has no tracers, so that check has no counterpart.)

The expert FFN over the received rows runs grouped by local expert: the
rows go into an ``(e_loc, m, d)`` buffer, as the scatter path's
``(E, C, d)`` one, and one batched product per weight runs over it
(``moe._swiglu``), never one weight matrix gathered per row.
"""

from __future__ import annotations

import math

import torch

from repro_torch import dist


def _route_keep(logits_l, k, e, e_loc, n_model, tok_axes, mesh,
                n_tok_dev, capacity, overflow):
    """Per-rank routing shared by the dispatch body and the phase-1
    sizing pass: normalized router weights, flat expert ids, destination
    shards, per-expert positions, and the ``overflow="global"`` keep
    mask (all-ones for ``"local"`` — its cut is per-destination and
    applied by the caller)."""
    from repro_torch.models import moe

    probs = torch.softmax(logits_l.float(), dim=-1)
    weights, idx = moe.top_k(probs, k)                  # (t_loc, k)
    weights = weights / torch.clamp(
        torch.sum(weights, dim=-1, keepdim=True), min=1e-9)
    flat_e = idx.reshape(-1)                            # (N = t_loc*k,)
    n = flat_e.shape[0]
    dest = flat_e // e_loc
    # local position of each pair inside its expert (stable sort: ties
    # keep local flattened (token, slot) order); no cut here
    pos_e, _ = moe.dispatch(flat_e, e, n)

    if overflow == "global":
        # exclusive prefix of per-expert counts over all ranks in global
        # token order: rank = row-major index over the token sharding
        # axes, matching the (dp..., model) layout of the global tokens
        counts = moe.expert_counts(flat_e, e).to(torch.int32)
        all_counts = dist.all_gather(counts, tok_axes)
        all_counts = all_counts.reshape(n_tok_dev, e)
        my = 0
        for a in tok_axes:
            my = my * int(mesh.shape[a]) + dist.axis_index(a)
        mask = (torch.arange(n_tok_dev, device=flat_e.device)
                < my)[:, None].to(torch.int32)
        prefix = torch.sum(all_counts * mask, dim=0)    # (e,)
        keep = prefix[flat_e] + pos_e < capacity        # == scatter path
    else:
        keep = torch.ones((n,), dtype=torch.bool, device=flat_e.device)
    return weights, flat_e, dest, pos_e, keep


def _expert_ffn(rx, re, wg, wu, wd, m: int):
    """SwiGLU of each received row through its local expert ``re`` (-1:
    an empty slot, whose output is zero), grouped by expert: rows go
    into an ``(e_loc, m, d)`` buffer in arrival order, and one batched
    product per weight runs over it, as the scatter path's."""
    from repro_torch.models import moe

    e_loc, d = wg.shape[0], rx.shape[1]
    ids = torch.where(re >= 0, re, e_loc)           # empties: one more id
    pos_c, _ = moe.dispatch(ids, e_loc + 1, m)
    buf = rx.new_zeros((e_loc + 1, m + 1, d))
    buf[ids, pos_c] = rx
    out = moe._swiglu(buf[:e_loc, :m], wg, wu, wd)  # (e_loc, m, d)
    padded = torch.nn.functional.pad(out, (0, 0, 0, 1, 0, 1))
    return padded[ids, pos_c]


def moe_alltoall_block(xf, logits, w_gate, w_up, w_down, mesh, top_k,
                       c_dev, local_capacity_factor=2.0, capacity=None,
                       overflow="global", exact_c_dev=False):
    """Expert-parallel MoE dispatch via explicit all-to-all.

    Tokens are sharded over (dp axes, 'model'); the expert axis of the
    weight tensors is sharded over 'model' (replicated across dp).  Each
    rank routes its local (token, slot) pairs to the model shard that
    owns the chosen expert with a sort-based dispatch (same MegaBlocks
    trick as the scatter path), exchanges (n_model, c_dev, d) buffers
    with ONE all_to_all each way, and combines locally with its own
    router weights — so only token activations cross the wire.

    ``xf`` (T, d) and ``logits`` (T, E) are whole on every rank;
    ``w_gate``, ``w_up`` and ``w_down`` are this rank's block of the
    expert axis (``P("model", None, None)``, ``moe.expert_block``).  The
    result is whole on every rank (one all-gather of the token blocks).

    Capacity semantics (see module docstring): ``overflow="global"``
    (default) drops per global expert at ``capacity`` exactly like the
    scatter path — elementwise-equal outputs in and out of the overflow
    regime; ``overflow="local"`` keeps the legacy per-(source rank,
    destination shard) drop at ``max(c_dev, ceil(t_loc*k*
    local_capacity_factor/n_model))``, which agrees with the scatter
    path only when capacity is ample.

    ``exact_c_dev=True`` trusts the caller's ``c_dev`` instead of
    clamping it up to the static bound — pass the result of the
    phase-1 :func:`moe_alltoall_exact_c_dev` counting pass, which
    guarantees every kept pair fits its slab.
    """
    from repro_torch.models import moe

    from .sharding import dp_axes

    n_model = int(mesh.shape["model"])
    e_loc = int(w_gate.shape[0])
    e = e_loc * n_model
    dp_names = dp_axes(mesh)
    tok_axes = tuple(dp_names) + ("model",)
    n_dp = int(math.prod(int(mesh.shape[a]) for a in dp_names)) \
        if dp_names else 1
    t_loc = int(xf.shape[0]) // (n_dp * n_model)
    if overflow == "global":
        if capacity is None:
            raise ValueError(
                "moe_alltoall_block(overflow='global') needs the global "
                "per-expert `capacity` used by the scatter path; pass it, "
                "or opt into the divergent overflow='local' semantics")
        if exact_c_dev:
            # phase-1 counted the true max kept per slab; a larger
            # buffer only ships more zeros, never changes the output
            c_dev = min(int(c_dev),
                        min(t_loc * int(top_k), e_loc * int(capacity)))
        else:
            # every kept pair must fit its (source rank, dest shard)
            # slab: a rank keeps at most min(its local pairs,
            # e_loc*capacity) pairs for one destination shard — a STATIC
            # bound, so parity needs no runtime assertion
            c_dev = max(int(c_dev),
                        min(t_loc * int(top_k), e_loc * int(capacity)))
    elif overflow == "local":
        c_dev = max(int(c_dev),
                    math.ceil(t_loc * int(top_k)
                              * float(local_capacity_factor) / n_model))
    else:
        raise ValueError(f"unknown overflow mode {overflow!r} "
                         "(expected 'global' or 'local')")
    if logits.shape[-1] != e:
        raise ValueError(f"{logits.shape[-1]} router logits per token but "
                         f"{e_loc} experts x {n_model} model shards: the "
                         f"expert weights must be this rank's block "
                         f"(moe.expert_block)")
    n_tok_dev = n_dp * n_model

    def body(xf_l, logits_l, wg, wu, wd):
        t_loc, d = xf_l.shape
        k = top_k
        dev = xf_l.device
        weights, flat_e, dest, pos_e, keep = _route_keep(
            logits_l, k, e, e_loc, n_model, tok_axes, mesh, n_tok_dev,
            capacity, overflow)
        n = flat_e.shape[0]

        # position among the KEPT pairs of each destination shard
        d2 = torch.where(keep, dest, n_model)           # dropped -> tail
        pos, _ = moe.dispatch(d2, n_model + 1, n)
        if overflow == "local":
            keep = pos < c_dev
        pos_c = torch.where(keep, pos, c_dev)           # overflow slot
        token_of = torch.arange(t_loc, device=dev).repeat_interleave(k)

        send_x = xf_l.new_zeros((n_model, c_dev + 1, d))
        send_x[dest, pos_c] = xf_l[token_of] * keep[:, None].to(xf_l.dtype)
        # empty slots carry expert -1 (the reference sends 0 with a zero
        # row): the receiver skips them instead of computing expert 0
        send_e = torch.full((n_model, c_dev + 1), -1, dtype=torch.int32,
                            device=dev)
        send_e[dest, pos_c] = (flat_e % e_loc).to(torch.int32)

        recv_x = dist.all_to_all(send_x[:, :c_dev], "model", 0, 0)
        recv_e = dist.all_to_all(send_e[:, :c_dev], "model", 0, 0)

        rx = recv_x.reshape(n_model * c_dev, d)
        re = recv_e.reshape(n_model * c_dev).long()
        # rows per local expert: at most the global capacity, else (the
        # local rule) the most any expert received, read on the host
        m = int(capacity) if overflow == "global" else \
            max(1, int(moe.expert_counts(re + 1, e_loc + 1)[1:].max()))
        out = _expert_ffn(rx, re, wg, wu, wd, m)

        back = dist.all_to_all(out.reshape(n_model, c_dev, d), "model", 0,
                               0)
        back_flat = torch.cat([back.reshape(n_model * c_dev, d),
                               back.new_zeros((1, d))], dim=0)
        slot = torch.where(keep, dest * c_dev + pos_c, n_model * c_dev)
        per_slot = back_flat[slot]                      # (N, d)
        w_comb = (weights.reshape(-1).to(xf_l.dtype)
                  * keep.to(xf_l.dtype))
        return torch.sum((per_slot * w_comb[:, None]).reshape(t_loc, k, d),
                         dim=1)

    spec_tok = dist.P(tok_axes, None)
    spec_w = dist.Held(dist.P("model", None, None))
    return dist.shard_map(body, mesh=mesh,
                          in_specs=(spec_tok, spec_tok, spec_w, spec_w,
                                    spec_w),
                          out_specs=spec_tok)(
        xf, logits, w_gate, w_up, w_down)


def moe_alltoall_exact_c_dev(logits, mesh, top_k, capacity=None,
                             overflow="global",
                             local_capacity_factor=2.0):
    """Phase-1 of two-phase wire-buffer sizing: the exact max number of
    kept (token, slot) pairs any (source rank, destination shard) slab
    carries, rounded up to a multiple of 8 with a floor of 8, never
    above the static safety bound.

    Runs the SAME routing + keep math as :func:`moe_alltoall_block`
    (``_route_keep``) over the logits only — no activations move — and
    reduces the per-(rank, dest) kept counts to one host integer (the
    same on every rank).  Pass the result as ``c_dev`` with
    ``exact_c_dev=True``.  Outputs are elementwise identical for any
    ``c_dev`` >= the true max, so resizing between steps never changes
    numerics.

    ``overflow="local"`` already sizes its buffer from its own drop
    rule — the legacy formula IS exact there and is returned directly.
    """
    from .sharding import dp_axes

    n_model = int(mesh.shape["model"])
    e = int(logits.shape[-1])
    if e % n_model:
        raise ValueError(f"{e} experts do not divide over {n_model} model "
                         f"shards")
    e_loc = e // n_model
    dp_names = dp_axes(mesh)
    tok_axes = tuple(dp_names) + ("model",)
    n_dp = int(math.prod(int(mesh.shape[a]) for a in dp_names)) \
        if dp_names else 1
    n_tok_dev = n_dp * n_model
    t_loc = int(logits.shape[0]) // n_tok_dev
    k = int(top_k)
    if overflow == "local":
        return math.ceil(t_loc * k * float(local_capacity_factor) / n_model)
    if overflow != "global":
        raise ValueError(f"unknown overflow mode {overflow!r} "
                         "(expected 'global' or 'local')")
    if capacity is None:
        raise ValueError(
            "moe_alltoall_exact_c_dev(overflow='global') needs the "
            "global per-expert `capacity` used by the scatter path")
    bound = min(t_loc * k, e_loc * int(capacity))

    def count(logits_l):
        _, _, dest, _, keep = _route_keep(
            logits_l, k, e, e_loc, n_model, tok_axes, mesh, n_tok_dev,
            capacity, "global")
        kept = torch.zeros((n_model,), dtype=torch.int32,
                           device=dest.device)
        kept.index_add_(0, dest, keep.to(torch.int32))
        return kept[None, :]                 # (1, n_model) per rank

    spec_tok = dist.P(tok_axes, None)
    counts = dist.shard_map(count, mesh=mesh, in_specs=(spec_tok,),
                            out_specs=spec_tok)(logits)
    max_kept = int(counts.max())
    return min(bound, max(8, -(-max_kept // 8) * 8))


def _pod_mean(x32, compress: bool):
    """fp32 mean over the 'pod' axis, optionally int8-compressed for the
    slow cross-pod link — the shared cross-pod hop of ``grad_sync`` and
    ``cross_pod_allreduce``."""
    if compress:
        from repro_torch.optim.compress import dequantize_int8, quantize_int8
        q, s = quantize_int8(x32)
        return dist.pmean(dequantize_int8(q, s), "pod")
    return dist.pmean(x32, "pod")


def grad_sync(mesh, grads, int8_cross_pod: bool = False):
    """Hierarchical gradient mean over the data-parallel axes.

    In-pod (``data``) reduction runs in fp32; the cross-pod hop (the slow
    link) optionally quantizes its summand to int8 with per-tensor
    scales (``optim.compress``) before reducing — via the same
    :func:`_pod_mean` body that backs :func:`cross_pod_allreduce`.
    Tensor-parallel (``model``) gradients are already replicated and
    untouched.  ``grads`` is this rank's tree (``P()``: each rank passes
    its own); every rank gets the mean back.
    """
    if mesh is None or all(int(s) == 1 for s in mesh.shape.values()):
        return grads
    from repro_torch.models.layers import map_tree

    from .sharding import dp_axes

    dp = dp_axes(mesh)
    if not dp:
        return grads
    in_pod = tuple(a for a in dp if a != "pod")

    def body(g):
        def one(_, x):
            x32 = x.to(torch.float32)
            if in_pod:
                x32 = dist.pmean(x32, in_pod)
            if "pod" in dp:
                x32 = _pod_mean(x32, int8_cross_pod)
            return x32.to(x.dtype)

        return map_tree(one, g)

    return dist.shard_map(body, mesh=mesh, in_specs=(dist.P(),),
                          out_specs=dist.P())(grads)


def cross_pod_allreduce(mesh, x, compress: bool = False, in_spec=None):
    """Mean-allreduce of one tensor over the 'pod' axis.

    The standalone form of ``grad_sync``'s cross-pod hop (same
    :func:`_pod_mean` body, so the two cannot drift): use it to average
    metrics, EMA shadows, or other per-pod state that does not ride the
    gradient pytree.  ``in_spec`` is the tensor's spec (default
    replicated: each rank passes its own value); ``x`` is whole on every
    rank, and the output is whole too, averaged across pods.  Identity on
    meshes without a 'pod' axis (or pod=1).
    """
    if mesh is None or "pod" not in mesh.axis_names \
            or int(mesh.shape["pod"]) == 1:
        return x
    spec = in_spec if in_spec is not None else dist.P()

    def body(xl):
        return _pod_mean(xl.to(torch.float32), compress).to(x.dtype)

    return dist.shard_map(body, mesh=mesh, in_specs=(spec,),
                          out_specs=spec)(x)
