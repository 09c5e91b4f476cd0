"""The program's own ranges in a ``torch.profiler`` trace: what each
launched on the device, and the device idle time that fell inside each.

    python3 -m weaverbench.spans <trace.json>

prints one line a range name for a trace that ``export_chrome_trace``
wrote.  The program marks its own steps with ranges whose names start
with ``analytics.`` (``repro_torch.core.obs.device_span``: a traversal's
call and its ``.prepare``).  A device-to-host read of one value directly
inside such a range (the profiler's own ``aten::item`` range) counts as
that range's ``.sync``.  Where the trace holds the harness's window
(``devtrace.WINDOW``) only the window is read, on its thread; else the
whole trace, on the thread of the first program range.

Unlike ``devtrace``'s breakdown, which names each idle gap after the
range open at its midpoint, every idle microsecond here goes to the
innermost program range open at that moment: a gap from a read's return
to the next launch is split between the read and the loop around it.
"""

from __future__ import annotations

import bisect
import json
import math
import sys
from dataclasses import dataclass
from typing import Dict, List, Tuple

from weaverbench import devtrace

PROGRAM = "analytics."           # prefix of the program's own ranges
# the profiler's ranges around a device-to-host read of one value
# (``.item()``); one directly inside a program range is named after it
# + SYNC
READS = ("aten::item", "aten::_local_scalar_dense")
SYNC = ".sync"


@dataclass
class SpanTotals:
    """One program range name's totals."""
    count: int = 0
    host_s: float = 0.0         # the ranges' own host durations
    device_s: float = 0.0       # device time of operations launched inside
    idle_s: float = 0.0         # device idle while it was the innermost


def split(trace: dict) -> Dict[str, SpanTotals]:
    """Totals by name of the program's ranges (``PROGRAM``, and their
    reads as ``SYNC``).  ``device_s``: operations whose launch lies
    inside a range count for it and for every range around it.
    ``idle_s``: each idle interval split by intersection, each piece
    going to the innermost range open over it."""
    evs = [e for e in trace.get("traceEvents", [])
           if e.get("ph") == "X" and "dur" in e]
    win = [e for e in evs if devtrace._cat(e) == "user_annotation"
           and e.get("name") == devtrace.WINDOW]
    if win:
        w0 = float(win[0]["ts"])
        w1 = w0 + float(win[0]["dur"])
        tid = win[0].get("tid")
    else:
        first = min((e for e in evs if _is_program(e)),
                    key=lambda e: float(e["ts"]), default=None)
        if first is None:
            return {}
        w0 = min(float(e["ts"]) for e in evs)
        w1 = max(float(e["ts"]) + float(e["dur"]) for e in evs)
        tid = first.get("tid")
    spans = _name_reads(sorted(
        ((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
         for e in evs if e.get("tid") == tid
         and (_is_program(e)
              or devtrace._cat(e) == "cpu_op" and e.get("name") in READS)
         and float(e["ts"]) >= w0
         and float(e["ts"]) + float(e["dur"]) <= w1),
        key=lambda r: (r[0], -r[1])))
    out: Dict[str, SpanTotals] = {}
    if not spans:
        return out
    launched = {e["args"]["correlation"]: float(e["ts"]) for e in evs
                if devtrace._cat(e) in devtrace.LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    # (start, end) clipped to the window, and the launch's host time
    dev = sorted(((max(float(e["ts"]), w0),
                   min(float(e["ts"]) + float(e["dur"]), w1),
                   launched.get(e.get("args", {}).get("correlation")))
                  for e in evs if devtrace._cat(e) in devtrace.DEVICE_CATS
                  and float(e["ts"]) < w1
                  and float(e["ts"]) + float(e["dur"]) > w0),
                 key=lambda d: d[:2])

    ops = sorted((at, t - s) for s, t, at in dev if at is not None)
    starts = [at for at, _ in ops]
    total = [0.0]
    for _, d in ops:
        total.append(total[-1] + d)
    for a, b, name in spans:
        t = out.setdefault(name, SpanTotals())
        t.count += 1
        t.host_s += (b - a) * 1e-6
        t.device_s += (total[bisect.bisect_right(starts, b)]
                       - total[bisect.bisect_left(starts, a)]) * 1e-6

    gaps, busy_to = [], w0          # the window less the union of ops
    for s, t, _ in dev:
        if s > busy_to:
            gaps.append((busy_to, s))
        busy_to = max(busy_to, t)
    if w1 > busy_to:
        gaps.append((busy_to, w1))
    i = 0
    for s, e, name in _innermost_pieces(spans):
        while i < len(gaps) and gaps[i][1] <= s:
            i += 1
        j = i
        while j < len(gaps) and gaps[j][0] < e:
            out[name].idle_s += (min(e, gaps[j][1])
                                 - max(s, gaps[j][0])) * 1e-6
            j += 1
    return out


def _is_program(e: dict) -> bool:
    return (devtrace._cat(e) == "user_annotation"
            and str(e.get("name", "")).startswith(PROGRAM))


def _name_reads(ranges) -> List[Tuple[float, float, str]]:
    """``ranges`` (start, end, name), parents first, with each read
    (``READS``) that lies directly in a program range renamed to that
    range's name + ``SYNC``; a read inside a read, or outside every
    program range (the harness's own), left out."""
    out, stack = [], []             # stack: (end, is a read, name)
    for a, b, name in ranges:
        while stack and stack[-1][0] <= a:
            stack.pop()
        read = name in READS
        if read:
            if not stack or stack[-1][1]:
                continue
            name = stack[-1][2] + SYNC
        out.append((a, b, name))
        stack.append((b, read, name))
    return out


def _innermost_pieces(spans) -> List[Tuple[float, float, str]]:
    """``spans`` (start, end, name), sorted, nesting as ranges on one
    thread do, cut into disjoint pieces in time order, each named by the
    innermost range open over it; time outside every range left out."""
    pieces, stack = [], []
    cur = 0.0

    def close_to(t: float) -> None:
        nonlocal cur
        while stack and stack[-1][0] <= t:
            end, name = stack.pop()
            pieces.append((cur, end, name))
            cur = end

    for a, b, name in spans:
        close_to(a)
        if stack:
            pieces.append((cur, a, stack[-1][1]))
            b = min(b, stack[-1][0])    # a child ends with its parent
        stack.append((b, name))
        cur = a
    close_to(math.inf)
    return [p for p in pieces if p[1] > p[0]]


def table(spans: Dict[str, SpanTotals]) -> List[str]:
    """``split``'s totals as lines of text: name, count, host ms, device
    ms launched inside, idle ms while innermost."""
    lines = [f"{'span':<32} {'count':>7} {'host_ms':>11} {'device_ms':>11} "
             f"{'idle_ms':>9}"]
    for name, t in sorted(spans.items()):
        lines.append(f"{name:<32} {t.count:>7} {t.host_s * 1e3:>11.3f} "
                     f"{t.device_s * 1e3:>11.3f} {t.idle_s * 1e3:>9.3f}")
    return lines


def main(argv: List[str]) -> int:
    if len(argv) != 1:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    with open(argv[0]) as f:
        print("\n".join(table(split(json.load(f)))))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
