"""One run of one cell: set-up, the measured window, the check and the
result line.

The cell, its configuration, its traffic mix and its metrics are found
by name: ``BENCHMARK.json`` at ``root``, ``weaverbench/configs/<config>.json``,
``weaverbench/traffic/<traffic>.json`` and ``weaverbench/metrics/<name>.py``;
the configuration's generator at ``weaverbench/generators/<generator>.py``
and the traffic's query kind at ``weaverbench/kinds/<query>.py``.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np
import torch

from . import devtrace, graphs

HERE = Path(__file__).resolve().parent


@dataclass
class Cell:
    chips: int
    config: dict
    traffic: dict
    metrics: List[dict]         # end-to-end, then per-layer, as listed


def load_cell(root: Path, workload: str) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    here = root / HERE.name
    config = json.loads((here / "configs" / f"{w['config']}.json").read_text())
    traffic = json.loads((here / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    metrics = [dict(m, kind=kind) for kind in ("end_to_end", "per_layer")
               for m in bench[kind] if workload in m.get("workloads",
                                                         [workload])]
    return Cell(w["chips"], config, traffic, metrics)


def load(root: Path, folder: str, name: str):
    """The module ``weaverbench/<folder>/<name>.py`` under ``root``."""
    path = root / HERE.name / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"weaverbench_{folder}_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(root: Path, name: str) -> Callable:
    return load(root, "metrics", name).read


@dataclass
class RunRecord:
    """What a metric reader reads."""
    device_name: str
    setup_s: float
    window_s: float
    latencies_s: List[float]
    work: List[dict]            # per query: rounds and work counts
    trace: Optional[devtrace.Summary]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _profiler(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _number(v):
    return v if math.isfinite(v) else str(v)


def _worst(v):
    return math.inf if math.isnan(v) else v


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool,
        device, setup_clock: Callable[[], float], impl: str = "program",
        max_queries: Optional[int] = None) -> dict:
    """One run; returns the result line as a dict.  ``setup_clock()``
    gives the seconds since the process started.  ``impl`` is
    ``"program"`` (the port) or ``"control"`` (the control in its
    place)."""
    clock = time.perf_counter()

    def phase(what: str) -> None:
        nonlocal clock
        now = time.perf_counter()
        print(f"{what}: {now - clock:.3f} s", file=sys.stderr, flush=True)
        clock = now

    cell = load_cell(root, workload)
    wanted = [m for m in cell.metrics
              if m["kind"] == ("per_layer" if trace else "end_to_end")]
    readers = {m["name"]: load_reader(root, m["name"]) for m in wanted}
    traffic = cell.traffic

    gen = load(root, "generators", cell.config["generator"])
    graph = gen.build(cell.config, seed, device)
    print(f"graph {cell.config['name']}: {graph.n} vertices, "
          f"{graph.src.numel()} directed edge slots, "
          f"{graph.self_loops_redrawn} self-loops drawn again", flush=True)
    live = getattr(gen, "LiveGraph", graphs.LiveGraph)(
        graph, traffic["write_fraction"])
    del graph
    _sync(device)
    phase("graph")
    query = load(root, "kinds", traffic["query"]).Query(traffic, live, seed)
    call = getattr(query, impl)
    print(f"write window: up to {live.count} edge slots before each query",
          flush=True)

    # warm-up: every shape the window uses, then the copy the check
    # replays the window's snapshots from
    live.write_window("warmup")
    query.work(call(live, query.args(0)), live)
    base = live.clone()
    prof = _profiler(device) if trace else None
    if prof is not None:
        prof.start()
    _sync(device)
    phase("warm-up")

    m = traffic["check_queries"]
    pick = np.random.default_rng(graphs.sub_seed(seed, "sample"))
    samples = {}                # query index -> (args, answer)
    latencies, counts = [], []
    setup_s = setup_clock()
    start = time.perf_counter()
    with torch.profiler.record_function(devtrace.WINDOW):
        k = 0
        while True:
            live.write_window(k)
            a = query.args(k)
            _sync(device)
            t0 = time.perf_counter()
            with torch.profiler.record_function(devtrace.QUERY):
                out = call(live, a)
                _sync(device)
            t1 = time.perf_counter()
            latencies.append(t1 - t0)
            counts.append(query.work(out, live))
            # reservoir sample of m answers, drawn from the seed
            if k < m:
                samples[k] = (a, out)
            else:
                j = int(pick.integers(k + 1))
                if j < m:
                    del samples[sorted(samples)[j]]
                    samples[k] = (a, out)
            del out
            k += 1
            if t1 - start >= seconds or k == max_queries:
                break
    window_s = t1 - start
    counts = [{name: int(v) for name, v in c.items()} for c in counts]
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    phase(f"window ({k} queries)")
    summary = None
    if prof is not None:
        prof.stop()
        summary = devtrace.read(prof)
        phase("trace read")

    numbers = check(query, live, base, k, samples)
    phase("check")
    limits = traffic.get("limits", {})
    ok = all(name in limits and value <= limits[name]
             for name, value in numbers.items())
    checked = {name: {"value": _number(v), "limit": limits.get(name)}
               for name, v in numbers.items()}

    record = RunRecord(torch.cuda.get_device_name(device) if cuda else "cpu",
                       setup_s, window_s, latencies, counts, summary)
    metrics = {}
    for mdef in wanted:
        v = readers[mdef["name"]](record)
        if v is not None:
            metrics[mdef["name"]] = {"value": v, "unit": mdef["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": record.device_name, "count": cell.chips,
           "memory_peak_bytes": peak}
    result = {"correct": ok, "attempted": k, "failed": 0,
              "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["check"] = checked
    return result


def check(query, live: graphs.LiveGraph, base: graphs.LiveGraph,
          n_queries: int, samples: dict) -> dict:
    """Replays the window's write windows on ``base`` and compares each
    sampled answer with the reference on its own snapshot; then counts
    the slots where the live arrays differ from the replay (the port must
    leave its inputs as they were).  Numbers are maxima over the
    sample."""
    numbers = {}
    for k in range(n_queries):
        base.write_window(k)
        if k in samples:
            a, out = samples.pop(k)
            ref = query.reference(base, a)
            for name, v in query.compare(out, ref).items():
                numbers[name] = max(numbers.get(name, v), v, key=_worst)
            del out, ref
    numbers["snapshot_changed"] = int((base.src != live.src).sum()
                                      + (base.dst != live.dst).sum())
    return numbers
