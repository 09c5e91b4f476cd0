"""Node programs (paper §2.3, Fig. 3) — traversal-style read-only queries.

A node program is a function ``prog(node, params, ctx)`` executed at a
vertex against the snapshot at the program's stamp ``T_prog``:

* ``node``   — :class:`NodeView` (vertex id, visible out-edges, visible
  properties, and the per-query persistent ``prog_state`` dict);
* ``params`` — the prog_params propagated from the previous hop;
* ``ctx``    — :class:`ProgContext`: ``ctx.emit(dst_vid, params)`` to
  scatter to the next hop and ``ctx.output(value)`` to contribute to the
  query's final result (reduced by the program's ``reduce`` function at
  the coordinator).

Programs are registered in :data:`REGISTRY` so shards can execute by name
(the C++ Weaver ships program code to servers; we ship a name).

Frontier plan / fallback contract
---------------------------------
A program may additionally register a **vectorized** implementation:

* ``@frontier_impl(name)`` — ``frontier_step(plan, frontier, state,
  ctx)`` executes a whole per-shard frontier in one batched step against
  the columnar snapshot slice (:class:`repro_torch.core.frontier.ShardPlan`);
* ``@frontier_root(name)`` — packs the root ``[(vid, params), ...]``
  entries into a :class:`repro_torch.core.frontier.Frontier` (returning None
  rejects the batch, e.g. heterogeneous per-entry params);
* ``frontier_ok(params)`` — a pure predicate on the root params; False
  forces the scalar path (e.g. an unhashable edge-filter constant).

The shard picks the path per query: batched iff a ``frontier_step``
exists AND the root packs cleanly — a deterministic function of
``(name, root entries)``, so all shards of one query agree.  EVERY
built-in program now has a vectorized form ("no scalar programs left"):
``get_edges`` returns ragged per-entry edge lists as one
:class:`~repro_torch.core.frontier.RaggedReply` per step, and ``clustering``
runs a 3-phase wedge-closing protocol with packed neighbour lists in a
:class:`~repro_torch.core.frontier.Ragged` side table.  Deliveries that do
not pack (heterogeneous per-entry params, unhashable filter constants)
transparently fall back to the scalar interpreter
(:func:`run_entries_scalar`), which is also the equivalence oracle:
both paths must produce identical reduced results at the same stamp.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .frontier import (Frontier, Ragged, RaggedReply, ensure_state,
                       ragged_offsets)


@dataclass
class EdgeView:
    eid: int
    dst: str
    _props: Dict[str, object]

    def prop(self, key: str, default=None):
        return self._props.get(key, default)


class NodeView:
    def __init__(self, vid: str, out_edges, props: Dict[str, object],
                 prog_state: dict):
        self.id = vid
        # ``out_edges`` may be a list or a zero-arg loader (lazy: the
        # shard charges adjacency-scan cost only on first access)
        self._edges = out_edges
        self._props = props
        self.prog_state = prog_state

    @property
    def out_edges(self) -> List[EdgeView]:
        if callable(self._edges):
            self._edges = self._edges()
        return self._edges

    def prop(self, key: str, default=None):
        return self._props.get(key, default)


class ProgContext:
    def __init__(self, at):
        self.at = at                      # snapshot stamp T_prog
        self.emits: List[Tuple[str, object]] = []
        self.outputs: List[object] = []

    def emit(self, dst_vid: str, params=None) -> None:
        self.emits.append((dst_vid, params))

    def output(self, value) -> None:
        self.outputs.append(value)


@dataclass
class NodeProgram:
    name: str
    fn: Callable[[NodeView, object, ProgContext], None]
    reduce: Callable[[List[object]], object] = lambda xs: xs
    # vectorized path (see module docstring): step over a ShardPlan,
    # root packer, and params-acceptance predicate
    frontier_step: Optional[Callable] = None
    pack_root: Optional[Callable] = None
    frontier_ok: Callable[[object], bool] = lambda params: True
    #: Whether a shard may MERGE several pending same-(prog, stamp,
    #: depth) Frontier deliveries into one ``frontier_step`` execution.
    #: Legal iff the step is invariant under entry concatenation: one
    #: step over the concatenated frontier must equal running the step
    #: once per delivery against the same state.  True for every
    #: built-in — visited-set programs (traverse/reachable) dedup
    #: internally, label-correcting sssp folds offers with a segment
    #: min, and per-entry programs (get_node/count_edges/block_render)
    #: emit one output per delivered entry either way.  A program whose
    #: step is order- or boundary-sensitive must set this False.
    coalesce_ok: bool = True


REGISTRY: Dict[str, NodeProgram] = {}


def register(name: str, reduce: Optional[Callable] = None):
    def deco(fn):
        REGISTRY[name] = NodeProgram(name, fn, reduce or (lambda xs: xs))
        return fn
    return deco


def frontier_impl(name: str):
    """Attach a vectorized ``frontier_step(plan, frontier, state, ctx)``
    to an already-registered program."""
    def deco(fn):
        REGISTRY[name].frontier_step = fn
        return fn
    return deco


def frontier_root(name: str):
    """Attach the root packer ``pack_root(entries, intern) -> Frontier|None``."""
    def deco(fn):
        REGISTRY[name].pack_root = fn
        return fn
    return deco


def _uniform_params(entries) -> Optional[dict]:
    """The shared root params dict, or None if entries disagree (the
    batched path needs ONE meta per frontier)."""
    if not entries:
        return None
    p0 = entries[0][1]
    if p0 is not None and not isinstance(p0, dict):
        return None
    for _, p in entries[1:]:
        try:
            same = bool(p == p0)
        except (TypeError, ValueError):   # e.g. ndarray values: ambiguous
            return None
        if not same:
            return None
    return {} if p0 is None else p0


def _pack_simple(entries, intern, meta: Optional[dict] = None,
                 vals=None) -> Optional[Frontier]:
    params = _uniform_params(entries)
    if params is None:
        return None
    gids = np.asarray([intern.intern(vid) for vid, _ in entries], np.int64)
    m = dict(params)
    if meta:
        m.update(meta)
    return Frontier(gids=gids, vals=vals, depth=params.get("depth", 0),
                    meta=m)


def run_entries_scalar(partition, prog: NodeProgram, entries, stamp,
                       refine, states: Dict[str, dict], cost):
    """The per-vertex interpreter (seed semantics), shared by the shard
    event loop and the synchronous drivers.

    Returns ``(emits, outputs, service)``; ``service`` charges
    ``prog_vertex``/``prog_revisit`` per entry plus ``prog_edge`` per
    adjacency slot iff the program actually reads ``node.out_edges``.
    """
    service = 0.0
    emits: List[Tuple[str, object]] = []
    outputs: List[object] = []
    for vid, params in entries:
        v = partition.vertex_at(vid, stamp, refine)
        # re-deliveries to an already-visited vertex are a hash-map
        # probe, not a full visit (the C++ system dispatches straight
        # into the per-query state)
        revisit = vid in states
        service += cost.prog_revisit if revisit else cost.prog_vertex
        if v is None:
            continue

        # LAZY edge materialization: edges are scanned (and charged)
        # only if the program actually reads node.out_edges — a
        # visited-check that returns early touches no adjacency.
        charge = {"edges": 0.0}

        def load_edges(v=v, charge=charge):
            edges = partition.out_edges_at(v.vid, stamp, refine)
            charge["edges"] = cost.prog_edge * len(v.out_edges)
            eviews = []
            for e in edges:
                eprops = {k: partition.prop_at(vs, stamp, refine)
                          for k, vs in e.props.items()}
                eviews.append(EdgeView(e.eid, e.dst, eprops))
            return eviews

        vprops = {k: partition.prop_at(vs, stamp, refine)
                  for k, vs in v.props.items()}
        node = NodeView(vid, load_edges, vprops,
                        states.setdefault(vid, {}))
        ctx = ProgContext(stamp)
        prog.fn(node, params, ctx)
        service += charge["edges"]
        emits.extend(ctx.emits)
        outputs.extend(ctx.outputs)
    return emits, outputs, service


# ---------------------------------------------------------------------------
# Built-in programs used by the paper's workloads.
# ---------------------------------------------------------------------------

@register("get_node", reduce=lambda xs: xs[0] if xs else None)
def get_node(node: NodeView, params, ctx: ProgContext) -> None:
    """TAO-workload vertex read: id + properties + edge count (§5.2/§5.4)."""
    ctx.output({"id": node.id, "n_edges": len(node.out_edges)})


def _edge_lists(xs: List[object]) -> List[list]:
    """Expand ``get_edges`` outputs to per-entry edge lists: the scalar
    path ships one Python list per visited entry, the batched path one
    :class:`~repro_torch.core.frontier.RaggedReply` per ``frontier_step``."""
    out: List[list] = []
    for x in xs:
        if isinstance(x, RaggedReply):
            out.extend(x.lists())
        else:
            out.append(x)
    return out


@register("get_edges", reduce=lambda xs: (_edge_lists(xs) or [[]])[0])
def get_edges(node: NodeView, params, ctx: ProgContext) -> None:
    """TAO-workload edge-list read: the visited vertex's full out-edge
    list in canonical eid-ascending order (both execution paths agree on
    it).  ``params={"props": (key, ...)}`` additionally returns each
    edge's value for the named property keys."""
    want = params.get("props") if isinstance(params, dict) else None
    edges = sorted(node.out_edges, key=lambda e: e.eid)
    if want:
        ctx.output([(e.eid, e.dst, {k: e.prop(k) for k in want})
                    for e in edges])
    else:
        ctx.output([(e.eid, e.dst) for e in edges])


@register("count_edges", reduce=lambda xs: sum(xs))
def count_edges(node: NodeView, params, ctx: ProgContext) -> None:
    ctx.output(len(node.out_edges))


@register("traverse", reduce=lambda xs: sorted(set(xs)))
def traverse(node: NodeView, params, ctx: ProgContext) -> None:
    """BFS traversal along edges carrying ``edge_property`` (paper Fig. 3).

    params = {"edge_property": (key, value) | None, "max_depth": int|None,
              "depth": int}
    """
    if node.prog_state.get("visited"):
        return
    node.prog_state["visited"] = True
    ctx.output(node.id)
    depth = params.get("depth", 0)
    maxd = params.get("max_depth")
    if maxd is not None and depth >= maxd:
        return
    want = params.get("edge_property")
    for e in node.out_edges:
        if want is None or e.prop(want[0]) == want[1]:
            ctx.emit(e.dst, dict(params, depth=depth + 1))


@register("reachable", reduce=lambda xs: any(xs))
def reachable(node: NodeView, params, ctx: ProgContext) -> None:
    """Reachability query (paper §5.3 benchmark)."""
    if node.id == params["target"]:
        ctx.output(True)
        return
    if node.prog_state.get("visited"):
        return
    node.prog_state["visited"] = True
    for e in node.out_edges:
        ctx.emit(e.dst, params)


@register("block_render", reduce=lambda xs: xs)
def block_render(node: NodeView, params, ctx: ProgContext) -> None:
    """CoinGraph block query (§5.1): read the block vertex, then fetch
    every Bitcoin-transaction vertex it points to (1-hop fan-out)."""
    if params.get("hop", 0) == 0:
        for e in node.out_edges:
            if e.prop("type") == "contains":
                ctx.emit(e.dst, {"hop": 1})
    else:
        ctx.output({"tx": node.id,
                    "value": node.prop("value"),
                    "n_out": len(node.out_edges)})


@register("clustering", reduce=lambda xs: xs[0] if xs else 0.0)
def clustering(node: NodeView, params, ctx: ProgContext) -> None:
    """Local clustering coefficient (§5.4): fan out one hop to collect
    neighbour adjacency, return to origin to close wedges."""
    phase = params.get("phase", 0)
    if phase == 0:
        nbrs = sorted({e.dst for e in node.out_edges})
        node.prog_state["nbrs"] = nbrs
        node.prog_state["replies"] = 0
        node.prog_state["links"] = 0
        node.prog_state["origin"] = True
        if len(nbrs) < 2:
            ctx.output(0.0)
            return
        for v in nbrs:
            ctx.emit(v, {"phase": 1, "origin": node.id, "nbrs": nbrs})
    elif phase == 1:
        mine = {e.dst for e in node.out_edges}
        hits = sum(1 for v in params["nbrs"] if v != node.id and v in mine)
        ctx.emit(params["origin"], {"phase": 2, "hits": hits})
    else:  # phase == 2 — back at the origin, accumulate
        st = node.prog_state
        st["links"] = st.get("links", 0) + params["hits"]
        st["replies"] = st.get("replies", 0) + 1
        k = len(st.get("nbrs", []))
        if st["replies"] == k and k >= 2:
            ctx.output(st["links"] / (k * (k - 1)))


@register("sssp", reduce=lambda xs: min(xs) if xs else None)
def sssp(node: NodeView, params, ctx: ProgContext) -> None:
    """Hop-bounded shortest path by weight property (label-correcting)."""
    dist = params.get("dist", 0.0)
    best = node.prog_state.get("dist")
    if best is not None and best <= dist:
        return
    node.prog_state["dist"] = dist
    if node.id == params["target"]:
        ctx.output(dist)
        return
    if params.get("depth", 0) >= params.get("max_depth", 16):
        return
    for e in node.out_edges:
        w = e.prop("weight", 1.0)
        ctx.emit(e.dst, dict(params, dist=dist + w,
                             depth=params.get("depth", 0) + 1))


# ---------------------------------------------------------------------------
# Vectorized frontier implementations (repro_torch.core.frontier executes
# these over per-shard columnar snapshot slices; results are identical
# to the scalar forms above at the same stamp).
# ---------------------------------------------------------------------------

def _segment_min(values: np.ndarray, keys: np.ndarray):
    """Per-destination min via the sorted-segment kernel ops."""
    from ..kernels.segment_mp import ops as smp
    order = np.argsort(keys, kind="stable")
    return smp.segment_reduce_sorted(values[order], keys[order], "min")


@frontier_root("get_node")
@frontier_root("count_edges")
def _degree_root(entries, intern):
    return _pack_simple(entries, intern)


@frontier_impl("get_node")
def _get_node_step(plan, fr, state, ctx) -> None:
    vis = plan.vertex_visible(fr.gids)
    g = fr.gids[vis]
    deg = plan.out_degree(g)
    ctx.charge(n_visit=len(fr), n_edges=int(deg.sum()))
    for gid, d in zip(g.tolist(), deg.tolist()):
        ctx.output({"id": ctx.vid(gid), "n_edges": int(d)})


@frontier_impl("count_edges")
def _count_edges_step(plan, fr, state, ctx) -> None:
    vis = plan.vertex_visible(fr.gids)
    deg = plan.out_degree(fr.gids[vis])
    ctx.charge(n_visit=len(fr), n_edges=int(deg.sum()))
    for d in deg.tolist():
        ctx.output(int(d))


def _traverse_ok(params) -> bool:
    if not (params is None or isinstance(params, dict)):
        return False
    want = (params or {}).get("edge_property")
    if want is None:
        return True
    try:
        hash(want[1])
    except (TypeError, IndexError, KeyError):
        return False
    return True


REGISTRY["traverse"].frontier_ok = _traverse_ok


@frontier_root("traverse")
def _traverse_root(entries, intern):
    params = _uniform_params(entries)
    if params is None or not _traverse_ok(params):
        return None
    return _pack_simple(entries, intern)


def _edge_filter(plan, pos: np.ndarray, want) -> np.ndarray:
    """Positions whose edge satisfies ``prop(key) == value`` at T_prog."""
    key, val = want[0], want[1]
    ids, _ = plan.edge_prop(key)
    sel = ids[pos]
    if val is None:             # absent property reads as None
        m = sel == -1
        wid = plan.value_id(None)
        if wid >= 0:
            m |= sel == wid
        return m
    wid = plan.value_id(val)
    if wid < 0:                 # value never stored here: nothing matches
        return np.zeros(sel.shape, bool)
    return sel == wid


@frontier_impl("traverse")
def _traverse_step(plan, fr, state, ctx) -> None:
    visited = ensure_state(state, "visited", len(ctx.intern.vids),
                           False, bool)
    seen = visited[fr.gids]
    ctx.charge(n_visit=int((~seen).sum()), n_revisit=int(seen.sum()))
    g = np.unique(fr.gids[plan.vertex_visible(fr.gids)])
    new = g[~visited[g]]
    if new.size == 0:
        return
    visited[new] = True
    for vid in ctx.vids_of(new):
        ctx.output(vid)
    maxd = fr.meta.get("max_depth")
    if maxd is not None and fr.depth >= maxd:
        return
    pos, _, ln = plan.gather_edges(new)
    ctx.charge(n_edges=int(ln.sum()))
    want = fr.meta.get("edge_property")
    if want is not None:
        pos = pos[_edge_filter(plan, pos, want)]
    dst = plan.edst[pos]
    if dst.size:
        ctx.emit(np.unique(dst))


@frontier_root("reachable")
def _reachable_root(entries, intern):
    params = _uniform_params(entries)
    if not params or "target" not in params:
        return None
    return _pack_simple(entries, intern)


@frontier_impl("reachable")
def _reachable_step(plan, fr, state, ctx) -> None:
    visited = ensure_state(state, "visited", len(ctx.intern.vids),
                           False, bool)
    seen = visited[fr.gids]
    ctx.charge(n_visit=int((~seen).sum()), n_revisit=int(seen.sum()))
    g = np.unique(fr.gids[plan.vertex_visible(fr.gids)])
    tgid = ctx.intern.ids.get(fr.meta["target"], -2)
    if np.any(g == tgid):       # target check precedes the visited check
        ctx.output(True)
        g = g[g != tgid]        # ... and the target never expands
    new = g[~visited[g]]
    if new.size == 0:
        return
    visited[new] = True
    pos, _, ln = plan.gather_edges(new)
    ctx.charge(n_edges=int(ln.sum()))
    if pos.size:
        ctx.emit(np.unique(plan.edst[pos]))


@frontier_root("sssp")
def _sssp_root(entries, intern):
    params = _uniform_params(entries)
    if not params or "target" not in params:
        return None
    fr = _pack_simple(entries, intern)
    if fr is not None:
        fr.vals = np.full(len(fr), float(params.get("dist", 0.0)))
    return fr


@frontier_impl("sssp")
def _sssp_step(plan, fr, state, ctx) -> None:
    dist = ensure_state(state, "dist", len(ctx.intern.vids),
                        np.inf, np.float64)
    vis = plan.vertex_visible(fr.gids)
    ctx.charge(n_visit=len(fr))
    g, d = fr.gids[vis], fr.vals[vis]
    uniq, dmin = _segment_min(d, g)           # best offer per vertex
    imp = dmin < dist[uniq]                   # strict: `best <= dist` prunes
    g2, d2 = uniq[imp], dmin[imp]
    if g2.size == 0:
        return
    dist[g2] = d2
    tgid = ctx.intern.ids.get(fr.meta["target"], -2)
    at_t = g2 == tgid
    for dv in d2[at_t].tolist():
        ctx.output(dv)
    if fr.depth >= fr.meta.get("max_depth", 16):
        return
    exp, de = g2[~at_t], d2[~at_t]
    pos, src_idx, ln = plan.gather_edges(exp)
    ctx.charge(n_edges=int(ln.sum()))
    if pos.size == 0:
        return
    ids, num = plan.edge_prop("weight")
    w = np.where(ids[pos] >= 0, num[pos], 1.0)
    nd, nv = _segment_min(de[src_idx] + w, plan.edst[pos])
    ctx.emit(nd, nv)


@frontier_root("block_render")
def _block_render_root(entries, intern):
    params = _uniform_params(entries)
    if params is None:
        return None
    return _pack_simple(entries, intern, meta={"hop": params.get("hop", 0)})


def _get_edges_ok(params) -> bool:
    if params is None:
        return True
    if not isinstance(params, dict):
        return False
    want = params.get("props")
    if want is None:
        return True
    return (isinstance(want, (list, tuple))
            and all(isinstance(k, str) for k in want))


REGISTRY["get_edges"].frontier_ok = _get_edges_ok


@frontier_root("get_edges")
def _get_edges_root(entries, intern):
    params = _uniform_params(entries)
    if params is None or not _get_edges_ok(params):
        return None
    return _pack_simple(entries, intern)


@frontier_impl("get_edges")
def _get_edges_step(plan, fr, state, ctx) -> None:
    """Ragged per-entry output: every delivered entry's full edge list
    (eids + endpoints + requested property columns) in ONE batched
    gather over the plan's sorted-CSR slice, shipped as a single
    :class:`~repro_torch.core.frontier.RaggedReply` payload."""
    vis = plan.vertex_visible(fr.gids)
    g = fr.gids[vis]                 # duplicates preserved: the scalar
    ctx.charge(n_visit=len(fr))      # path outputs once per delivery
    pos, src_idx, ln = plan.gather_edges(g)
    ctx.charge(n_edges=int(ln.sum()))
    eids = plan.edge_eids(pos).astype(np.int64)
    order = np.lexsort((eids, src_idx))   # canonical: eid asc per entry
    pos, eids = pos[order], eids[order]
    props = None
    vals = None
    want = fr.meta.get("props")
    if want:
        props = {}
        # deployment-wide value intern (Weaver shares one table across
        # partitions): ship the packed id columns and let the client
        # decode lazily; a per-partition table forces eager decode here
        # because its ids are meaningless off-shard
        shared = getattr(plan.cols, "vals_shared", False)
        for key in want:
            ids, _ = plan.edge_prop(key)
            if shared:
                props[key] = ids[pos].astype(np.int64)
            else:
                props[key] = [plan.value_of(int(i))
                              for i in ids[pos].tolist()]
        if shared:
            vals = plan.cols.vals
    ctx.output(RaggedReply(ctx.intern, g, ragged_offsets(ln), eids,
                           plan.edst[pos], props, vals=vals))


def _clustering_ok(params) -> bool:
    return params is None or (isinstance(params, dict)
                              and params.get("phase", 0) == 0)


REGISTRY["clustering"].frontier_ok = _clustering_ok


@frontier_root("clustering")
def _clustering_root(entries, intern):
    params = _uniform_params(entries)
    if params is None or params.get("phase", 0) != 0:
        return None
    return _pack_simple(entries, intern, meta={"cl_phase": 0})


@frontier_impl("clustering")
def _clustering_step(plan, fr, state, ctx) -> None:
    """3-phase wedge-closing protocol, the batched mirror of the scalar
    program's fan-out/fan-in:

    * phase 0 (roots) — compute each visible root's sorted-unique
      neighbour list from the CSR slice and emit ONE entry per
      ``(neighbour, origin)`` pair; the origins' packed lists travel
      once per destination shard as the frontier's ragged side table
      (entry ``tags`` = origin row).
    * phase 1 (neighbours) — close wedges with ONE vectorized
      min-degree-side sorted intersection per pair
      (``analytics.intersect_counts``) between the shipped neighbour
      lists and the local dedup'd CSR; replies are pre-reduced per
      origin per shard (summed hits + reply count in ``vals``/``tags``).
      An invisible neighbour never replies — exactly the scalar path,
      whose origin then never completes (reduce falls back to 0.0).
    * phase 2 (back at the origins) — accumulate ``links``/``replies``
      per-origin state; an origin whose reply count reaches its
      neighbour count outputs ``links / (k (k-1))``.

    Root entries are deduplicated (duplicate roots make the scalar
    protocol's reply counting self-interfere; roots are unique in every
    workload)."""
    ph = fr.meta.get("cl_phase", 0)
    if ph == 0:
        _cl_collect(plan, fr, state, ctx)
    elif ph == 1:
        _cl_close(plan, fr, state, ctx)
    else:
        _cl_reduce(plan, fr, state, ctx)


def _cl_state(state, n):
    return (ensure_state(state, "cl_k", n, 0, np.int64),
            ensure_state(state, "cl_links", n, 0, np.int64),
            ensure_state(state, "cl_replies", n, 0, np.int64))


def _cl_collect(plan, fr, state, ctx) -> None:
    ctx.charge(n_visit=len(fr))
    g = np.unique(fr.gids[plan.vertex_visible(fr.gids)])
    if g.size == 0:
        return
    pos, src_idx, ln = plan.gather_edges(g)
    ctx.charge(n_edges=int(ln.sum()))
    # sorted-unique neighbour list per root (set semantics: parallel
    # edges collapse; a self-loop dst stays, matching the scalar nbrs)
    ukey = np.unique((src_idx << 32) | plan.edst[pos])
    offs = np.searchsorted(ukey >> 32,
                           np.arange(g.size + 1, dtype=np.int64))
    k = np.diff(offs)
    for _ in range(int((k < 2).sum())):
        ctx.output(0.0)
    big = np.nonzero(k >= 2)[0]
    if big.size == 0:
        return
    karr, links, replies = _cl_state(state, len(ctx.intern.vids))
    gb = g[big]
    karr[gb] = k[big]
    links[gb] = 0
    replies[gb] = 0
    origins = Ragged(offsets=offs, values=ukey & np.int64(0xFFFFFFFF),
                     keys=g).take(big)
    tags = np.repeat(np.arange(big.size, dtype=np.int64), k[big])
    ctx.emit(origins.values, tags=tags, ragged=origins,
             meta={"cl_phase": 1})


def _cl_close(plan, fr, state, ctx) -> None:
    from . import analytics
    visited = ensure_state(state, "cl_seen", len(ctx.intern.vids),
                           False, bool)
    seen = visited[fr.gids]
    ctx.charge(n_visit=int((~seen).sum()), n_revisit=int(seen.sum()))
    visited[fr.gids] = True
    vis = plan.vertex_visible(fr.gids)
    if not bool(vis.any()):
        return
    v = fr.gids[vis]
    tag = fr.tags[vis]
    rg = fr.ragged
    ukey, usrc, udst = plan.unique_adj()
    b_lo = np.searchsorted(usrc, v, side="left")
    b_hi = np.searchsorted(usrc, v, side="right")
    a_lo = rg.offsets[tag]
    a_hi = rg.offsets[tag + 1]
    row_of_pos = np.repeat(np.arange(len(rg), dtype=np.int64), rg.lens())
    a_keys = (row_of_pos << 32) | rg.values
    counts = analytics.intersect_counts(a_lo, a_hi, rg.values, a_keys, tag,
                                        b_lo, b_hi, udst, ukey, v)
    ctx.charge(n_edges=int(np.minimum(a_hi - a_lo, b_hi - b_lo).sum()))
    # the w != v exclusion: v ∈ nbrs(origin) by construction, so the
    # intersection counted it iff v has a local self-loop — subtract it
    if ukey.size:
        sl = (v << 32) | v
        loc = np.minimum(np.searchsorted(ukey, sl), ukey.size - 1)
        counts = counts - (ukey[loc] == sl).astype(np.int64)
    # ONE packed reply per origin per shard: summed hits + reply count
    og = rg.keys[tag]
    order = np.argsort(og, kind="stable")
    og_s, hits_s = og[order], counts[order]
    uniq, start = np.unique(og_s, return_index=True)
    sums = np.add.reduceat(hits_s, start)
    cnts = np.diff(np.r_[start, og_s.size])
    ctx.emit(uniq, vals=sums.astype(np.float64),
             tags=cnts.astype(np.int64), meta={"cl_phase": 2})


def _cl_reduce(plan, fr, state, ctx) -> None:
    ctx.charge(n_revisit=len(fr))    # origins were visited in phase 0
    karr, links, replies = _cl_state(state, len(ctx.intern.vids))
    g = fr.gids
    np.add.at(links, g, fr.vals.astype(np.int64))
    np.add.at(replies, g, fr.tags)
    uniq = np.unique(g)
    done = uniq[(replies[uniq] == karr[uniq]) & (karr[uniq] >= 2)]
    for o in done.tolist():
        k = int(karr[o])
        ctx.output(float(links[o]) / (k * (k - 1)))


@frontier_impl("block_render")
def _block_render_step(plan, fr, state, ctx) -> None:
    vis = plan.vertex_visible(fr.gids)
    g = fr.gids[vis]                 # duplicates preserved: the scalar
    ctx.charge(n_visit=len(fr))      # path outputs once per delivery
    if fr.meta.get("hop", 0) == 0:
        pos, _, ln = plan.gather_edges(g)
        ctx.charge(n_edges=int(ln.sum()))
        if pos.size:
            m = _edge_filter(plan, pos, ("type", "contains"))
            dst = plan.edst[pos][m]
            if dst.size:
                ctx.emit(dst, meta={"hop": 1})
    else:
        deg = plan.out_degree(g)
        ctx.charge(n_edges=int(deg.sum()))
        vids_arr, _ = plan.vertex_prop_of(g, "value")
        for gid, d, vi in zip(g.tolist(), deg.tolist(), vids_arr.tolist()):
            ctx.output({"tx": ctx.vid(gid),
                        "value": plan.value_of(int(vi)),
                        "n_out": int(d)})
