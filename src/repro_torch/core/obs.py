"""Deployment-wide observability: causal tracing, metrics, attribution.

The paper's evaluation (Figs. 9-14) is entirely about *where time goes*
— admission vs. oracle refinement vs. shard apply.  This module is the
layer that can answer that for a single request: a :class:`Tracer`
records causally-linked spans on *simulated* time as requests flow
through gatekeepers, the store, shards and the timeline oracle; a
:class:`MetricsRegistry` keeps counters / gauges / histograms plus a
periodic time series; analysis helpers export Chrome trace-event JSON
(loadable in Perfetto / chrome://tracing), attribute a request's
end-to-end latency to pipeline stages via a critical-path walk over its
span tree, and check trace-level invariants (exactly-once apply, stamp
monotonicity) over traces produced under fault injection.

Design constraints
------------------
* **Pure observation.**  Recording a span must not draw from any RNG,
  send any message, or change any timing — traced and untraced runs
  must produce bit-identical results and counters (minus the obs
  counters listed in :data:`OBS_COUNTER_FIELDS`; tests assert this).
  Head-based sampling is therefore a deterministic counter stride, not
  a random draw.
* **Retrospective spans.**  Actors already carry the timestamps they
  need (submit time, window join time, queue arrival time), so spans
  are recorded *closed* — ``span(stage, t0, t1, ...)`` at the moment
  the work completes — instead of via open/close handles that would
  have to survive crashes and retries.
* **Context flows with events.**  ``Simulator.send``/``schedule``
  carry the ambient ``(trace_id, span_id)`` context on each heap entry
  and restore it around the callback, so child spans recorded inside a
  delivery parent correctly without any per-message plumbing.  Where
  batching merges many requests into one event (group-commit windows,
  shard batches), contexts ride explicitly: the tracer keeps
  ``stamp_ctx`` (timestamp key -> context) and ``prog_ctx``
  (program id -> context) registries so downstream actors can recover
  the owning request's context from data they already carry.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "Span", "Tracer", "MetricsRegistry", "OBS_COUNTER_FIELDS",
    "to_chrome_trace", "validate_trace_events", "span_tree",
    "critical_path", "attribution_table", "format_stage_table",
    "check_exactly_once", "check_stamp_monotonic", "check_completeness",
    "run_invariant_checks",
]

# Counters fields written by the observability layer itself; equivalence
# tests compare Counters snapshots with these removed.
OBS_COUNTER_FIELDS = ("spans_recorded", "metrics_samples")


def stamp_attr(stamp) -> list:
    """Span-attr encoding of a refinable timestamp: ``[epoch, *clock]``
    (what :func:`check_stamp_monotonic` compares as a vector clock)."""
    return [int(stamp.epoch), *(int(c) for c in stamp.clock)]


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

@dataclass
class Span:
    """One closed span on simulated time.

    ``trace`` groups spans of one sampled request; ``sid`` is unique
    within the trace; ``parent`` is the ``sid`` of the causal parent
    (``None`` for the root).  ``attrs`` carries stage-specific detail
    (stamp key, shard id, plan kind, window id, ...).
    """

    trace: int
    sid: int
    parent: Optional[int]
    stage: str
    actor: str
    t0: float
    t1: float
    attrs: dict = field(default_factory=dict)

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


class Tracer:
    """Head-sampled causal span recorder.

    ``sample_rate`` in (0, 1]: request *k* is sampled iff
    ``k % round(1/rate) == 0`` — deterministic, no RNG.  A deployment
    with tracing disabled simply has no Tracer installed
    (``sim.tracer is None``); every hook site guards on that, so the
    disabled cost is one attribute check.
    """

    def __init__(self, sim, sample_rate: float = 1.0):
        self.sim = sim
        self.sample_rate = float(sample_rate)
        self._stride = max(1, int(round(1.0 / self.sample_rate))) \
            if self.sample_rate > 0 else 0
        self._req_count = 0
        self._next_trace = 1
        self._next_sid = 1
        self.spans: List[Span] = []
        # ambient context for the event being executed: (trace, sid)
        self.current: Optional[Tuple[int, int]] = None
        # explicit-context registries for batched paths
        self.stamp_ctx: Dict[tuple, Tuple[int, int]] = {}
        self.prog_ctx: Dict[int, Tuple[int, int]] = {}
        sim.register(self)  # participates in actor-id space for debug

    # -- root / sampling -------------------------------------------------

    def maybe_start(self) -> Optional[Tuple[int, int]]:
        """Sampling decision for a new client request.  Returns a fresh
        root context (trace_id, 0) if sampled, else None.  The root
        span itself is recorded later, retrospectively, by the client
        session when the request finishes (stage ``request``)."""
        k = self._req_count
        self._req_count += 1
        if self._stride == 0 or (k % self._stride) != 0:
            return None
        tid = self._next_trace
        self._next_trace += 1
        return (tid, 0)

    # -- recording -------------------------------------------------------

    def span(self, stage: str, t0: float, t1: float, actor: str = "",
             ctx: Optional[Tuple[int, int]] = None,
             **attrs) -> Optional[Tuple[int, int]]:
        """Record a closed span under ``ctx`` (default: ambient context).

        Returns the new span's context ``(trace, sid)`` so callers can
        parent further children under it, or None if there is no
        context (request not sampled)."""
        if ctx is None:
            ctx = self.current
        if ctx is None:
            return None
        trace, parent = ctx
        sid = self._next_sid
        self._next_sid += 1
        self.spans.append(Span(trace, sid, parent, stage, actor,
                               float(t0), float(t1), attrs))
        self.sim.counters.spans_recorded += 1
        return (trace, sid)

    def root_span(self, ctx: Tuple[int, int], stage: str, t0: float,
                  t1: float, actor: str = "", **attrs) -> None:
        """Record the trace's root span (parent None).  ``ctx`` must be
        a root context from :meth:`maybe_start` (sid == 0 means 'the
        root slot'); children recorded under ``ctx`` parent to sid 0,
        and the root span claims sid 0 here."""
        trace, sid = ctx
        self.spans.append(Span(trace, sid, None, stage, actor,
                               float(t0), float(t1), attrs))
        self.sim.counters.spans_recorded += 1

    # -- registries ------------------------------------------------------

    def bind_stamp(self, stamp, ctx: Optional[Tuple[int, int]]) -> None:
        if ctx is not None:
            self.stamp_ctx[stamp.key()] = ctx

    def ctx_for_stamp(self, stamp) -> Optional[Tuple[int, int]]:
        return self.stamp_ctx.get(stamp.key())

    def bind_prog(self, prog_id: int,
                  ctx: Optional[Tuple[int, int]]) -> None:
        if ctx is not None:
            self.prog_ctx[prog_id] = ctx

    def ctx_for_prog(self, prog_id: int) -> Optional[Tuple[int, int]]:
        return self.prog_ctx.get(prog_id)

    # -- views -----------------------------------------------------------

    def traces(self) -> Dict[int, List[Span]]:
        out: Dict[int, List[Span]] = {}
        for s in self.spans:
            out.setdefault(s.trace, []).append(s)
        return out


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _bucket(v: float) -> int:
    """Power-of-two bucket (>=1) for histogram keys."""
    b = 1
    while b < v:
        b *= 2
    return b


class MetricsRegistry:
    """Counters / gauges / histograms on simulated time + a sampled
    timeline.

    * ``count(name, n)`` — monotone counter.
    * ``gauge(name, value, t)`` — last-write-wins sample with its
      simulated timestamp; ``recent(name, horizon, now)`` reads it back
      but returns 0.0 for samples older than ``horizon`` (a stale
      saturated-peer gauge must not keep windows open forever).
    * ``observe(name, value)`` — power-of-two bucketed histogram
      (replaces the ad-hoc ``Counters.admission_*_hist`` dicts).
    * ``sample(t, extra)`` — append one timeline row: every gauge's
      current value plus caller-provided extras (queue depths etc.).
    """

    def __init__(self):
        self.counters: Dict[str, int] = {}
        self.gauges: Dict[str, Tuple[float, float]] = {}   # name -> (t, v)
        self.hists: Dict[str, Dict[int, int]] = {}
        self.timeline: List[dict] = []

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def gauge(self, name: str, value: float, t: float) -> None:
        self.gauges[name] = (float(t), float(value))

    def recent(self, name: str, horizon: float, now: float) -> float:
        tv = self.gauges.get(name)
        if tv is None or now - tv[0] > horizon:
            return 0.0
        return tv[1]

    def gauge_values(self, prefix: str, horizon: float,
                     now: float) -> Dict[str, float]:
        """All non-stale gauges whose name starts with ``prefix``."""
        out = {}
        for name, (t, v) in self.gauges.items():
            if name.startswith(prefix) and now - t <= horizon:
                out[name] = v
        return out

    def observe(self, name: str, value: float) -> None:
        h = self.hists.setdefault(name, {})
        b = _bucket(value)
        h[b] = h.get(b, 0) + 1

    def sample(self, t: float, extra: Optional[dict] = None) -> None:
        row = {"t": float(t)}
        for name, (_, v) in sorted(self.gauges.items()):
            row[name] = v
        if extra:
            row.update(extra)
        self.timeline.append(row)

    def export(self) -> dict:
        return {"counters": dict(sorted(self.counters.items())),
                "gauges": {k: v for k, (_, v)
                           in sorted(self.gauges.items())},
                "histograms": {k: {str(b): n for b, n in sorted(v.items())}
                               for k, v in sorted(self.hists.items())},
                "timeline": self.timeline}

    def hist_snapshot(self, name: str, key_suffix: str = "") -> dict:
        """Histogram as a plain dict with string bucket keys, e.g.
        ``{"r:64us": 3}`` for (name="admission_window", suffix="us")."""
        return {f"{k}{key_suffix}": n
                for k, n in sorted(self.hists.get(name, {}).items())}


# ---------------------------------------------------------------------------
# Chrome trace-event export
# ---------------------------------------------------------------------------

def to_chrome_trace(spans: List[Span]) -> dict:
    """Spans -> Chrome trace-event JSON (``{"traceEvents": [...]}``).

    Complete ``"ph": "X"`` events on microsecond timestamps; ``pid`` is
    the trace id (one request per Perfetto process track), ``tid`` the
    recording actor (hashed to a small int), so a request's fan-out
    across shards reads as parallel tracks.
    """
    events = []
    actors = {}
    for s in spans:
        tid = actors.setdefault(s.actor or "root", len(actors) + 1)
        args = {"span_id": s.sid}
        if s.parent is not None:
            args["parent_id"] = s.parent
        for k, v in s.attrs.items():
            args[k] = v if isinstance(v, (int, float, str, bool)) else str(v)
        events.append({
            "name": s.stage,
            "cat": "weaver",
            "ph": "X",
            "ts": s.t0 * 1e6,
            "dur": max(s.dur, 0.0) * 1e6,
            "pid": int(s.trace),
            "tid": int(tid),
            "args": args,
        })
    meta = [{"name": "thread_name", "ph": "M", "pid": int(pid),
             "tid": int(tid), "args": {"name": actor}}
            for actor, tid in actors.items()
            for pid in sorted({s.trace for s in spans})]
    return {"traceEvents": events + meta,
            "displayTimeUnit": "ms"}


def validate_trace_events(doc: dict) -> List[str]:
    """Schema check for Chrome trace-event JSON.  Returns a list of
    problems (empty == valid)."""
    errs: List[str] = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["missing traceEvents array"]
    evs = doc["traceEvents"]
    if not isinstance(evs, list):
        return ["traceEvents is not a list"]
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            errs.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "M", "B", "E", "i"):
            errs.append(f"event {i}: bad ph {ph!r}")
            continue
        for k in ("name", "pid", "tid"):
            if k not in ev:
                errs.append(f"event {i}: missing {k}")
        if ph == "X":
            if not isinstance(ev.get("ts"), (int, float)):
                errs.append(f"event {i}: missing/bad ts")
            if not isinstance(ev.get("dur"), (int, float)) \
                    or ev.get("dur", -1) < 0:
                errs.append(f"event {i}: missing/negative dur")
    return errs


# ---------------------------------------------------------------------------
# critical-path attribution
# ---------------------------------------------------------------------------

def span_tree(spans: List[Span]):
    """(root, children-map sid -> [Span]) for one trace's span list.

    Raises ValueError if there is no root or a span references a
    missing parent (the completeness checker reports these as orphan
    findings instead)."""
    by_sid = {s.sid: s for s in spans}
    root = None
    children: Dict[int, List[Span]] = {}
    for s in spans:
        if s.parent is None:
            if root is not None:
                raise ValueError("trace has multiple roots")
            root = s
        else:
            if s.parent not in by_sid:
                raise ValueError(f"span {s.sid} has missing parent "
                                 f"{s.parent}")
            children.setdefault(s.parent, []).append(s)
    if root is None:
        raise ValueError("trace has no root span")
    return root, children


def critical_path(spans: List[Span],
                  network_stage: str = "network") -> Dict[str, float]:
    """Attribute a request's end-to-end latency to stages.

    Backward sweep: within a parent interval, walk from the end toward
    the start; time covered by a child is attributed (recursively) to
    that child's stages, gaps between children — and the remainder
    before the earliest child — to the *parent's* stage.  The root's
    own stage is reported as ``network_stage`` (un-instrumented time on
    the wire / in replies).  By construction the attribution tiles the
    root interval exactly, so ``sum(values) == root.dur`` up to float
    rounding — asserted by callers within epsilon.
    """
    root, children = span_tree(spans)
    out: Dict[str, float] = {}

    def _add(stage: str, dt: float) -> None:
        if dt > 0:
            out[stage] = out.get(stage, 0.0) + dt

    def _walk(s: Span, lo: float, hi: float, stage: str) -> None:
        kids = [k for k in children.get(s.sid, [])
                if k.t1 > lo and k.t0 < hi]
        kids.sort(key=lambda k: k.t1, reverse=True)
        cursor = hi
        for k in kids:
            k1 = min(k.t1, cursor)
            k0 = max(k.t0, lo)
            if k1 <= k0:
                continue  # fully shadowed by a later child
            _add(stage, cursor - k1)
            _walk(k, k0, k1, k.stage)
            cursor = k0
        _add(stage, cursor - lo)

    _walk(root, root.t0, root.t1, network_stage)
    return out


def attribution_table(tracer: Tracer,
                      network_stage: str = "network") -> dict:
    """Per-trace critical paths + aggregate stage totals.

    Returns ``{"requests": [{trace, e2e, stages, err}], "stages":
    {stage: total}, "max_rel_err": float}`` where ``err`` is the
    relative difference between the stage sum and the measured e2e
    (must be ~0; the CI stage asserts < 1%)."""
    requests = []
    totals: Dict[str, float] = {}
    max_err = 0.0
    for trace, spans in sorted(tracer.traces().items()):
        roots = [s for s in spans if s.parent is None]
        if not roots or any(s.attrs.get("infra") for s in roots):
            continue  # infra traces (window spans) have no request root
        try:
            stages = critical_path(spans, network_stage)
        except ValueError as e:
            requests.append({"trace": trace, "error": str(e)})
            continue
        e2e = roots[0].dur
        ssum = sum(stages.values())
        err = abs(ssum - e2e) / max(e2e, 1e-12)
        max_err = max(max_err, err)
        for k, v in stages.items():
            totals[k] = totals.get(k, 0.0) + v
        requests.append({"trace": trace, "e2e": e2e,
                         "stages": stages, "err": err})
    return {"requests": requests,
            "stages": dict(sorted(totals.items(),
                                  key=lambda kv: -kv[1])),
            "max_rel_err": max_err}


def format_stage_table(attr: dict, title: str = "stage") -> str:
    """Human-readable aggregate stage table (benchmark output)."""
    total = sum(attr["stages"].values()) or 1.0
    lines = [f"{'stage':<22} {'total_ms':>10} {'share':>7}"]
    for stage, v in attr["stages"].items():
        lines.append(f"{stage:<22} {v*1e3:>10.3f} {v/total:>6.1%}")
    lines.append(f"{'TOTAL':<22} {total*1e3:>10.3f} "
                 f"(max rel err {attr['max_rel_err']:.2e})")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# invariant checkers (run over fault-injected traces)
# ---------------------------------------------------------------------------

def check_completeness(tracer: Tracer) -> List[str]:
    """Every span's parent exists within its trace; exactly one root
    per trace.  Returns findings (empty == pass)."""
    errs = []
    for trace, spans in tracer.traces().items():
        sids = {s.sid for s in spans}
        roots = [s for s in spans if s.parent is None]
        if len(roots) != 1:
            errs.append(f"trace {trace}: {len(roots)} roots")
        for s in spans:
            if s.parent is not None and s.parent not in sids \
                    and s.parent != 0:
                errs.append(f"trace {trace}: span {s.sid} "
                            f"({s.stage}) orphaned, parent {s.parent}")
            if s.parent == 0 and 0 not in sids:
                errs.append(f"trace {trace}: span {s.sid} parented to "
                            f"missing root slot")
            if s.t1 < s.t0:
                errs.append(f"trace {trace}: span {s.sid} ({s.stage}) "
                            f"negative duration")
    return errs


def check_exactly_once(tracer: Tracer) -> List[str]:
    """Every *acked* tx trace has, per owning shard, >= 1 apply span
    overall and <= 1 per shard incarnation (recovery may legitimately
    re-apply into a *new* incarnation; duplicates within one
    incarnation would be a double-apply bug).  Apply spans carry attrs
    ``shard``/``incarnation``; shed/given-up requests are skipped."""
    errs = []
    for trace, spans in tracer.traces().items():
        roots = [s for s in spans if s.parent is None]
        if not roots:
            continue
        root = roots[0]
        if root.stage != "request" or root.attrs.get("kind") != "tx" \
                or not root.attrs.get("ok"):
            continue
        applies: Dict[Tuple[int, int], int] = {}
        shards = set()
        owning = None
        for s in spans:
            if s.stage == "shard_apply":
                shards.add(s.attrs.get("shard"))
                if not s.attrs.get("recovered"):
                    key = (s.attrs.get("shard"),
                           s.attrs.get("incarnation", 0))
                    applies[key] = applies.get(key, 0) + 1
            elif s.stage == "store_commit" and s.attrs.get("committed"):
                # the latest successful commit attempt knows the fan-out
                n = s.attrs.get("n_shards")
                if n is not None:
                    owning = n
        if owning is not None and len(shards) < owning:
            errs.append(f"trace {trace}: acked tx applied on "
                        f"{len(shards)}/{owning} owning shards")
        for (shard, inc), n in applies.items():
            if n > 1:
                errs.append(f"trace {trace}: {n} apply spans on shard "
                            f"{shard} incarnation {inc} (double apply)")
    return errs


def check_stamp_monotonic(tracer: Tracer) -> List[str]:
    """Along every root->leaf path, a span's stamp must never be
    strictly BEFORE an ancestor's stamp (concurrent is fine: retries
    through different gatekeepers are vector-clock-concurrent).  Spans
    carry the stamp as ``attrs["stamp"]`` = the clock tuple."""
    errs = []
    for trace, spans in tracer.traces().items():
        try:
            root, children = span_tree(spans)
        except ValueError:
            continue  # completeness checker reports structure problems

        def _desc(s, anc_stamp):
            st = s.attrs.get("stamp")
            if st is not None:
                if anc_stamp is not None and _strictly_before(st, anc_stamp):
                    errs.append(f"trace {trace}: span {s.sid} "
                                f"({s.stage}) stamp {st} precedes "
                                f"ancestor stamp {anc_stamp}")
                anc_stamp = st
            for k in children.get(s.sid, []):
                _desc(k, anc_stamp)

        _desc(root, None)
    return errs


def _strictly_before(a, b) -> bool:
    """Vector-clock strictly-before on (epoch, clocks...) tuples."""
    a, b = tuple(a), tuple(b)
    if a[0] != b[0]:
        return a[0] < b[0]
    av, bv = a[1:], b[1:]
    n = max(len(av), len(bv))
    av = av + (0,) * (n - len(av))
    bv = bv + (0,) * (n - len(bv))
    return all(x <= y for x, y in zip(av, bv)) and av != bv


def check_replica_staleness(tracer: Tracer) -> List[str]:
    """No read may be served by a replica at a stamp beyond the
    replica's applied frontier.  Every ``replica_read`` span records the
    stamp's settlement token (``settle_pos``, the primary feed position
    that covers the stamp's visible writes) and the serving replica's
    ``applied_pos`` at execution time; a read served with a missing
    token or with ``applied_pos < settle_pos`` would be reading a state
    older than the stamp requires — a staleness violation the
    frontier-gating protocol exists to prevent."""
    errs = []
    for s in tracer.spans:
        if s.stage != "replica_read":
            continue
        settle = s.attrs.get("settle_pos", -1)
        applied = s.attrs.get("applied_pos", -1)
        if settle is None or settle < 0:
            errs.append(f"replica_read span {s.sid} on {s.actor}: "
                        f"served without a settlement token "
                        f"(stamp {s.attrs.get('stamp')})")
        elif applied is None or applied < settle:
            errs.append(f"replica_read span {s.sid} on {s.actor}: "
                        f"applied_pos {applied} behind settle_pos "
                        f"{settle} (stamp {s.attrs.get('stamp')})")
    return errs


def run_invariant_checks(tracer: Tracer) -> Dict[str, List[str]]:
    return {"completeness": check_completeness(tracer),
            "exactly_once": check_exactly_once(tracer),
            "stamp_monotonic": check_stamp_monotonic(tracer),
            "replica_staleness": check_replica_staleness(tracer)}


# ---------------------------------------------------------------------------
# file export
# ---------------------------------------------------------------------------

def export_trace(tracer: Tracer, path: str) -> dict:
    """Write Chrome trace-event JSON for all recorded spans; returns
    the document (already schema-validated — raises on violations,
    which would mean a recorder bug)."""
    doc = to_chrome_trace(tracer.spans)
    errs = validate_trace_events(doc)
    if errs:
        raise ValueError("invalid trace export: " + "; ".join(errs[:5]))
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc
