#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port of Weaver (``src/repro_torch``) on one
NVIDIA card and check it.

Phases, in order; any failure exits non-zero and prints no result line:

1. Device and build: the card's name and power limit, and the build of
   every CUDA source of the port (one ``nvcc`` per source, in parallel).
2. Kernels against their plain versions: ``before``, ``visibility`` and
   ``before_pairs`` on seeded int32 stamp matrices (NO_STAMP rows, mixed
   epochs, equal vectors) at C in {3, 9} and N in {1, 1023, 1025,
   68,993,773}; each must be bit-identical to its plain PyTorch version
   on the card.  At the largest N each kernel is timed with CUDA events.
3. The system end to end: a port ``Weaver`` on the card with the
   device-resident column plane and group commit loads a seeded social
   graph through ``begin_tx``/``run_tx`` and runs a seeded mix of
   transactions, node programs, GC, snapshots and ``visible_edges_at``.
   The same stream runs through a port ``Weaver(device="cpu")`` in a
   worker process at the same time; results, counters and snapshot
   arrays must be identical.  A smaller deployment
   without the column plane repeats this, and its final snapshot is also
   held against the per-object Python snapshot oracle.
4. The kernels' launch counts on the main path (each > 0 on the card,
   0 on the CPU), then one JSON line per the kernels table, the card's
   name and power limit, and last the result line.

Run from the root of a checkout: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import statistics
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import core  # noqa: E402
from repro_torch.core import analytics  # noqa: E402
from repro_torch.core.clock import NO_STAMP  # noqa: E402
from repro_torch.data import synth  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.mv_visibility import kernel as mvk  # noqa: E402
from repro_torch.kernels.mv_visibility import ops as mvops  # noqa: E402
from repro_torch.kernels.mv_visibility import ref as mvref  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
INT32_OPS_PER_S = 67e12        # H100 SXM non-tensor 32-bit rate (fp32 row)
LIVEJOURNAL_EDGES = 68_993_773  # SNAP soc-LiveJournal1

KERNELS = {           # name -> what it replaces
    "before": "src/repro/kernels/mv_visibility/kernel.py:75",
    "visibility": "src/repro/kernels/mv_visibility/kernel.py:104",
    "before_pairs": "src/repro/core/writepath.py:144",
}
# GC every simulated second and a WAL checkpoint every 4096 records
# (defaults 0.05 s / 256): both rewrite O(store) state in the pure-Python
# simulator, which at this scale would dominate the run; neither changes
# what a read or a commit guarantees
GC_PERIOD = 1.0
WAL_CHECKPOINT_EVERY = 4096
PROGRAMS = ("traverse", "reachable", "sssp", "get_edges", "clustering",
            "count_edges")


class PhaseError(Exception):
    pass


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def stamp_rows(rng: np.random.Generator, n: int, q: np.ndarray) -> np.ndarray:
    """(n, C) int32 rows around q: epochs q-1/q/q+1, ~10% equal vectors,
    ~20% NO_STAMP rows."""
    c = q.size
    rows = rng.integers(0, 6, size=(n, c), dtype=np.int32)
    rows[:, 0] = q[0] + rng.integers(-1, 2, size=n, dtype=np.int32)
    rows[rng.random(n, dtype=np.float32) < 0.1, 1:] = q[1:]
    rows[rng.random(n, dtype=np.float32) < 0.2] = NO_STAMP
    return rows


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds per call over ``reps`` CUDA-event-timed calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_cases(rng, n: int, c: int, dev):
    q = rng.integers(0, 6, size=c, dtype=np.int32)
    q[0] = 1
    create = torch.from_numpy(stamp_rows(rng, n, q)).to(dev)
    delete = torch.from_numpy(stamp_rows(rng, n, q)).to(dev)
    qs_host = np.repeat(q[None], n, axis=0)
    qs_host[rng.random(n, dtype=np.float32) < 0.5, 0] += 1
    qs = torch.from_numpy(qs_host).to(dev)
    qt = torch.from_numpy(q).to(dev)
    return {
        "before": ((create, qt), mvops.before_mask, mvref.before),
        "visibility": ((create, delete, qt), mvops.visibility_mask,
                       mvref.visibility),
        "before_pairs": ((create, qs), mvops.before_pairs,
                         mvref.before_pairs),
    }


def needed_words(name: str, args) -> int:
    """int32 words the compare must read for THIS data: every row's
    epoch, its other components only where the epoch ties with the query
    (the compare decides on the epoch alone otherwise), and for
    ``visibility`` the delete row only where the create row is before q.
    Two compares (<=, ==) per component word read."""
    if name == "before_pairs":
        rows, qs = args
        tie = int((rows[:, 0] == qs[:, 0]).sum())
        return 2 * rows.shape[0] + 2 * tie * (rows.shape[1] - 1)
    rows, q = args[0], args[-1]
    c = rows.shape[1]
    words = rows.shape[0] + int((rows[:, 0] == q[0]).sum()) * (c - 1) + c
    if name == "visibility":
        dele = args[1][mvref.before(rows, q)]
        words += dele.shape[0] + int((dele[:, 0] == q[0]).sum()) * (c - 1)
    return words


def phase_kernels(seed: int, big_n: int, reps: int) -> dict:
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    timings, max_err = {}, {}
    for c in (3, 9):
        for n in (1, 1023, 1025, big_n):
            cases = kernel_cases(rng, n, c, dev)
            for name, (args, wrapper, plain) in cases.items():
                got = wrapper(*args)
                want = plain(*args)
                torch.cuda.synchronize()
                if got.dtype != torch.bool or got.shape != want.shape:
                    raise PhaseError(f"{name} C={c} N={n}: got "
                                     f"{got.dtype} {tuple(got.shape)}")
                err = int((got.to(torch.int8) - want.to(torch.int8))
                          .abs().max())
                max_err[name] = max(max_err.get(name, 0), err)
                if err:
                    bad = int((got != want).sum())
                    raise PhaseError(f"{name} C={c} N={n}: {bad} rows differ "
                                     f"from the plain version")
                if n != big_n:
                    continue
                k_ms = time_ms(lambda: wrapper(*args), reps)
                p_ms = time_ms(lambda: plain(*args), max(3, reps // 4))
                full = sum(t.numel() * 4 for t in args) + n
                words = needed_words(name, args)
                nbytes = words * 4 + n
                bound_ms = max(nbytes / HBM_BYTES_PER_S,
                               2 * words / INT32_OPS_PER_S) * 1e3
                print(f"kernel {name} C={c} N={n}: {k_ms:.4f} ms, plain "
                      f"{p_ms:.4f} ms, bound {bound_ms:.4f} ms (this "
                      f"data needs {nbytes} bytes: "
                      f"{nbytes / k_ms / 1e6:.1f} GB/s; whole tables "
                      f"{full} bytes: {full / k_ms / 1e6:.1f} GB/s)",
                      flush=True)
                timings[(name, c)] = {"ms": k_ms, "plain_ms": p_ms,
                                      "bound_ms": bound_ms}
            del cases
            torch.cuda.empty_cache()
        print(f"kernels == plain versions at C={c}, N in "
              f"(1, 1023, 1025, {big_n})", flush=True)
    for (name, c), t in timings.items():
        t["max_abs_err"] = max_err[name]
    return timings


# ---------------------------------------------------------------------------
# Phase 3: the system end to end (also held against the JAX reference by
# tests/test_torch_weaver.py, which imports make_stream / run_stream)
# ---------------------------------------------------------------------------

def make_stream(seed: int, n_users: int, avg_degree: int = 14,
                n_tx: int = 300, n_prog: int = 50, chunk: int = 512,
                kill: str = None, gc_period: float = 0.05) -> list:
    """A seeded op stream: bulk load in ``chunk``-op transactions, then a
    shuffled mix of ``n_tx`` small transactions and ``n_prog`` of each
    node program, with GC, async submissions, snapshots and (optionally)
    a shard kill plus promotion.  Edges are named by creation index."""
    rng = np.random.default_rng(seed)
    users = [f"u{i}" for i in range(n_users)]
    edges = synth.social_graph(rng, n_users, avg_degree)
    steps = [("tx", [("cv", v) for v in users[i:i + chunk]])
             for i in range(0, n_users, chunk)]
    steps += [("tx", [("ce", s, d) for s, d in edges[i:i + chunk]])
              for i in range(0, len(edges), chunk)]
    n_edges = len(edges)
    n_new = 0
    deleted = set()      # program roots avoid these: a program whose roots
    #                      are all gone from the store never completes

    def pick() -> str:
        return users[int(rng.integers(n_users))]

    def prog(name: str) -> tuple:
        u, v = pick(), pick()
        while u in deleted:
            u = pick()
        params = {"traverse": {"depth": 0, "max_depth": 2},
                  "reachable": {"target": v},
                  "sssp": {"target": v, "max_depth": 3},
                  "get_edges": None, "count_edges": None,
                  "clustering": {"phase": 0}}[name]
        return ("prog", name, [(u, params)])

    def tx() -> tuple:
        nonlocal n_edges, n_new
        ops = []
        for _ in range(int(rng.integers(1, 4))):
            r = rng.random()
            if r < 0.3:
                ops.append(("ce", pick(), pick()))
                n_edges += 1
            elif r < 0.45:
                ops.append(("se", int(rng.integers(n_edges)), "weight",
                            float(rng.integers(1, 10))))
            elif r < 0.6:
                ops.append(("de", int(rng.integers(n_edges))))
            elif r < 0.75:
                ops.append(("sv", pick(), "age", int(rng.integers(100))))
            elif r < 0.92:
                vid = f"n{n_new}"
                n_new += 1
                ops += [("cv", vid), ("ce", vid, pick())]
                n_edges += 1
            else:
                vid = users[1 + int(rng.integers(n_users - 1))]  # keep u0
                deleted.add(vid)
                ops.append(("dv", vid))
        return ("tx", ops)

    kinds = ["tx"] * n_tx + [p for p in PROGRAMS for _ in range(n_prog)]
    mixed = []
    for k in rng.permutation(len(kinds)).tolist():
        mixed.append(tx() if kinds[k] == "tx" else prog(kinds[k]))
    half = len(mixed) // 2
    steps += mixed[:half]
    steps += [("settle", 1.2 * gc_period),   # a GC pass runs
              prog("count_edges"), ("snap", False),
              ("async", [prog(p)[1:] for p in PROGRAMS])]
    steps += mixed[half:]
    steps += [prog("count_edges"), ("snap", True)]
    if kill is not None:
        steps += [("kill", kill), prog("traverse"), prog("count_edges"),
                  ("snap", True)]
    return steps


def _stamp(s):
    return None if s is None else (s.epoch, tuple(s.clock), s.gk, s.ctr)


def run_stream(core, analytics_mod, cfg, steps: list, device=None) -> list:
    """Run ``steps`` through a fresh ``core.Weaver(cfg)`` and return one
    comparable record per step plus the final counters.  ``core`` and
    ``analytics_mod`` are the package's modules, so the same driver runs
    the port and (in the tests) the JAX reference."""
    w = core.Weaver(cfg)
    vis_kw = {} if device is None else {"device": device}
    handles = []
    out = []
    last = None
    for step in steps:
        kind = step[0]
        if kind == "tx":
            t = w.begin_tx()
            for op in step[1]:
                if op[0] == "cv":
                    t.create_vertex(op[1])
                elif op[0] == "ce":
                    handles.append(t.create_edge(op[1], op[2]))
                elif op[0] == "de":
                    t.delete_edge(handles[op[1]])
                elif op[0] == "se":
                    t.set_edge_prop(handles[op[1]], op[2], op[3])
                elif op[0] == "sv":
                    t.set_vertex_prop(op[1], op[2], op[3])
                elif op[0] == "dv":
                    t.delete_vertex(op[1])
            r = w.run_tx(t)
            out.append(("tx", r.ok, r.error, _stamp(r.stamp), r.retries,
                        r.latency))
        elif kind == "prog":
            res, stamp, lat = w.run_program(step[1], step[2], timeout=60.0)
            last = stamp
            out.append(("prog", step[1], res, _stamp(stamp), lat))
        elif kind == "async":
            box = []
            for name, entries in step[1]:
                w.submit_program(name, entries,
                                 lambda r, s, l, name=name: box.append(
                                     (name, r, _stamp(s), l)))
            deadline = w.sim.now + 60.0
            while len(box) < len(step[1]) and w.sim.pending() \
                    and w.sim.now < deadline:
                w.sim.run(until=min(deadline, w.sim.now + 5e-3))
            out.append(("async", box))
        elif kind == "settle":
            w.settle(step[1])
            out.append(("settle", w.sim.now))
        elif kind == "kill":
            w.kill(step[1])
            w.settle(0.1)            # heartbeat loss -> promote_backup
            out.append(("kill", w.manager.epoch))
        elif kind == "snap":
            ga = analytics_mod.snapshot_arrays(w, last, keep_raw=step[1])
            rec = ["snap", list(ga.vids[:ga.n_nodes]), ga.edge_src,
                   ga.edge_dst, ga.csc_src, ga.csc_dst]
            if step[1]:
                src, dst, mask = analytics_mod.visible_edges_at(
                    ga, last, cfg.n_gatekeepers, **vis_kw)
                rec += [ga.raw_src, ga.raw_dst, ga.edge_create,
                        ga.edge_delete, src, dst, mask]
            out.append(tuple(rec))
    out.append(("counters", w.counters()))
    return out, w


def diff_records(a: list, b: list) -> list:
    """Human-readable mismatches between two run_stream outputs."""
    def same(x, y) -> bool:
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            x, y = np.asarray(x), np.asarray(y)
            return x.shape == y.shape and x.dtype == y.dtype \
                and np.array_equal(x, y)
        if isinstance(x, (list, tuple)) and isinstance(y, (list, tuple)):
            return len(x) == len(y) and all(same(p, q) for p, q in zip(x, y))
        if isinstance(x, dict) and isinstance(y, dict):
            return x.keys() == y.keys() and all(same(x[k], y[k]) for k in x)
        return x == y

    bad = []
    if len(a) != len(b):
        bad.append(f"{len(a)} records vs {len(b)}")
    for i, (x, y) in enumerate(zip(a, b)):
        if not same(x, y):
            bad.append(f"step {i} ({x[0]}): {str(x)[:200]} != {str(y)[:200]}")
    return bad


def canon(ga) -> tuple:
    """Order-free snapshot form: vid set + vid-pair edge multiset."""
    vids = ga.vids[:ga.n_nodes]
    return sorted(vids), sorted(zip((vids[i] for i in ga.edge_src.tolist()),
                                    (vids[i] for i in ga.edge_dst.tolist())))


class BoundaryClock:
    """Host seconds spent in the port's stamp-compare entry points (host
    to device copy, kernel, device to host copy), by wrapping them for
    the duration of a run: where the system phase's time goes."""

    def __init__(self):
        from repro_torch.core import writepath
        from repro_torch.dist.columns import DeviceColumnPlane
        self.sites = [(analytics, "_before_batch"),
                      (analytics, "visible_edges_at"),
                      (writepath, "before_pairs"),
                      (DeviceColumnPlane, "before_all")]
        self.secs = {name: 0.0 for _, name in self.sites}
        self.calls = {name: 0 for _, name in self.sites}

    def __enter__(self):
        self._saved = [(obj, name, getattr(obj, name))
                       for obj, name in self.sites]
        for obj, name, fn in self._saved:
            def timed(*a, _fn=fn, _name=name, **kw):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **kw)
                finally:
                    self.secs[_name] += time.perf_counter() - t0
                    self.calls[_name] += 1
            setattr(obj, name, timed)
        return self

    def __exit__(self, *exc):
        for obj, name, fn in self._saved:
            setattr(obj, name, fn)


def run_on(device: str, seed: int, n_users: int, plane: bool, n_prog: int,
           n_tx: int):
    """One run of the deployment's seeded stream on ``device``: (steps,
    records, launch counts of this run, host seconds, entry-point line,
    the Weaver)."""
    steps = make_stream(seed, n_users, n_tx=n_tx, n_prog=n_prog,
                        gc_period=GC_PERIOD)
    cfg = core.WeaverConfig(n_gatekeepers=2, n_shards=4, device=device,
                            device_shard_columns=plane,
                            write_group_commit=1e-3, seed=seed,
                            gc_period=GC_PERIOD,
                            wal_checkpoint_every=WAL_CHECKPOINT_EVERY)
    mvk.reset_launches()                     # counts of THIS run only
    t0 = time.perf_counter()
    with BoundaryClock() as bc:
        recs, w = run_stream(core, analytics, cfg, steps, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    line = ", ".join(f"{k} {bc.calls[k]} calls {bc.secs[k]:.3f} s"
                     for k in bc.secs)
    return steps, recs, dict(mvk.launches), secs, line, w


def cpu_twin(*args):
    """``run_on("cpu", ...)`` for a worker process (no Weaver returned)."""
    steps, recs, counts, secs, line, _ = run_on("cpu", *args)
    return len(steps), recs, counts, secs, line


def deployment(label: str, seed: int, n_users: int, plane: bool,
               n_prog: int, n_tx: int, oracle: bool) -> dict:
    """Run one seeded stream on the card and, at the same time in a
    worker process, on the CPU; compare the two runs."""
    args = (seed, n_users, plane, n_prog, n_tx)
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=1, mp_context=ctx) as pool:
        twin = pool.submit(cpu_twin, *args)
        steps, recs, counts, secs, line, w = run_on("cuda", *args)
        n_load = sum(1 for s in steps if s[0] == "tx" and len(s[1]) > 64)
        print(f"{label} device=cuda: {len(steps)} steps ({n_load} load "
              f"txs) in {secs:.2f} s host wall clock, launches {counts}",
              flush=True)
        print(f"{label} device=cuda: stamp-compare entry points {line}",
              flush=True)
        n_e = sum(c.n_e for c in (sh.partition.columns for sh in w.shards)
                  if c is not None)
        print(f"{label}: {n_e} edge rows resident, plane stats "
              f"{None if w.device_plane is None else w.device_plane.stats}",
              flush=True)
        if oracle:
            _, stamp, _ = w.run_program("count_edges", [("u0", None)])
            got = analytics.snapshot_arrays(w, stamp)
            want = analytics.snapshot_arrays_python(w, stamp)
            if canon(got) != canon(want):
                raise PhaseError(f"{label}: engine snapshot != Python "
                                 f"snapshot oracle")
            print(f"{label}: snapshot == per-object Python oracle "
                  f"({got.n_nodes} vertices, {got.edge_src.size} edges)",
                  flush=True)
        del w
        n_steps, cpu_recs, cpu_counts, cpu_secs, cpu_line = twin.result()
    print(f"{label} device=cpu (worker process, concurrent): {n_steps} "
          f"steps in {cpu_secs:.2f} s host wall clock, launches "
          f"{cpu_counts}", flush=True)
    print(f"{label} device=cpu: stamp-compare entry points {cpu_line}",
          flush=True)
    bad = diff_records(recs, cpu_recs)
    if bad:
        raise PhaseError(f"{label}: CUDA run != CPU run:\n"
                         + "\n".join(bad[:10]))
    if any(cpu_counts.values()):
        raise PhaseError(f"{label}: the CPU run launched kernels: "
                         f"{cpu_counts}")
    print(f"{label}: CUDA run == CPU run over {len(steps)} steps "
          f"(results, TxResults, counters, snapshot arrays, "
          f"visible_edges_at)", flush=True)
    return counts


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--users", type=int, default=100_000,
                    help="users of the main deployment (LiveJournal has "
                         "4.85M; ingest through the simulator bounds it)")
    ap.add_argument("--small-users", type=int, default=20_000)
    ap.add_argument("--kernel-n", type=int, default=LIVEJOURNAL_EDGES)
    ap.add_argument("--n-prog", type=int, default=50,
                    help="node programs of each kind per deployment")
    ap.add_argument("--n-tx", type=int, default=300)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 2
    card = smi_line()
    print(f"device: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}",
          flush=True)

    t0 = time.perf_counter()
    paths = build.build_all()
    print(f"built {sorted(paths)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, log in build.build_log.items():
        for line in log.strip().splitlines():
            print(f"nvcc {name}: {line}")

    timings = phase_kernels(args.seed, args.kernel_n, args.reps)

    main_counts = deployment("main", args.seed, args.users, plane=True,
                             n_prog=args.n_prog, n_tx=args.n_tx,
                             oracle=False)
    small_counts = deployment("host-global", args.seed + 1,
                              args.small_users, plane=False,
                              n_prog=max(1, args.n_prog // 5),
                              n_tx=max(1, args.n_tx // 5), oracle=True)
    for label, counts in (("main", main_counts),
                          ("host-global", small_counts)):
        missing = [k for k in ("before", "before_pairs") if not counts[k]]
        if label == "main":
            missing += [] if counts["visibility"] else ["visibility"]
        if missing:
            raise PhaseError(f"{label}: kernels {missing} were never "
                             f"launched on the path: {counts}")

    rows = []
    for name, replaces in KERNELS.items():
        t = timings[(name, 3)]
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/csrc/mv_visibility.cu",
                     "replaces": replaces, "launches": main_counts[name],
                     "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": "bytes", "library_ms": None})
    print(json.dumps({"kernels": rows}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
