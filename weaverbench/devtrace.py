"""The traced window: a ``torch.profiler`` trace of it, read into what ran
on the device, what the queries launched, and where the device sat idle.

The harness marks the window and each query with ``record_function``
ranges (``WINDOW``, ``QUERY``).  A device operation belongs to a query
when the host call that launched it (same ``correlation``) lies inside
that query's range; the write windows and the harness's own counting run
outside those ranges.
"""

from __future__ import annotations

import bisect
import json
import os
import shutil
import sys
import tempfile
from collections import defaultdict
from dataclasses import dataclass
from typing import List, Optional, Tuple

WINDOW = "weaverbench.window"
QUERY = "weaverbench.query"

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
NAME_CHARS = 120
TOP = 10


@dataclass
class Summary:
    window_s: float
    busy_s: float               # union of device operations in the window
    query_launches: int         # kernels the queries launched
    query_device_s: float       # device time of the queries' operations
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]


def _cat(e: dict) -> str:
    return str(e.get("cat", "")).lower()


def summarize(trace: dict) -> Optional[Summary]:
    """Summary of a Chrome trace as ``export_chrome_trace`` writes it;
    None where the window holds no device operation."""
    evs = [e for e in trace.get("traceEvents", [])
           if e.get("ph") == "X" and "dur" in e]
    win = [e for e in evs if _cat(e) == "user_annotation"
           and e.get("name") == WINDOW]
    if not win:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    tid = win[0].get("tid")
    queries = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                     for e in evs if _cat(e) == "user_annotation"
                     and e.get("name") == QUERY)
    q_starts = [q[0] for q in queries]
    launched = {e["args"]["correlation"]: float(e["ts"]) for e in evs
                if _cat(e) in LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    dev = [e for e in evs if _cat(e) in DEVICE_CATS
           and float(e["ts"]) < w1 and float(e["ts"]) + float(e["dur"]) > w0]
    if not dev:
        return None

    def in_query(t: Optional[float]) -> bool:
        if t is None:
            return False
        i = bisect.bisect_right(q_starts, t) - 1
        return i >= 0 and t <= queries[i][1]

    launches, q_dev = 0, 0.0
    by_name = defaultdict(float)
    spans = []
    for e in dev:
        ts, dur = float(e["ts"]), float(e["dur"])
        by_name[e.get("name", "?")[:NAME_CHARS]] += dur
        spans.append((max(ts, w0), min(ts + dur, w1)))
        if in_query(launched.get(e.get("args", {}).get("correlation"))):
            q_dev += dur
            launches += _cat(e) == "kernel"
    spans.sort()
    merged = [list(spans[0])]
    for s, t in spans[1:]:
        if s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]

    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e.get("name", "?")) for e in evs
                  if _cat(e) in HOST_CATS and e.get("tid") == tid
                  and e.get("name") != WINDOW)
    h_starts = [h[0] for h in host]
    by_host = defaultdict(float)
    for a, b in gaps:
        mid = (a + b) / 2
        outer = QUERY if in_query(mid) else "the harness, between queries"
        by_host[_innermost(host, h_starts, mid, outer)] += b - a
    top = lambda d: [[k, v * 1e-6] for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return Summary((w1 - w0) * 1e-6, busy * 1e-6, launches, q_dev * 1e-6,
                   top(by_name), top(by_host))


def _innermost(host, starts, t: float, outer: str, scan: int = 256) -> str:
    """Name of the innermost host range open at ``t``: ranges on one
    thread nest, so it is the latest-starting one that still covers
    ``t``; ``outer`` where none of the last ``scan`` to start does."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - scan, -1), -1):
        if host[j][1] >= t:
            return "host in " + host[j][2][:NAME_CHARS]
    return "host in " + outer


def read(prof) -> Optional[Summary]:
    """Export ``prof``'s trace to a scratch directory under ``TMPDIR``,
    summarize it and delete it."""
    tmp = tempfile.mkdtemp(prefix="weaverbench-trace-")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        print(f"trace: {os.path.getsize(path)} bytes", file=sys.stderr,
              flush=True)
        with open(path) as f:
            return summarize(json.load(f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
