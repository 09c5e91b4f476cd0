"""The harness on the CPU at tiny sizes: a rehearsal of every cell's run
(write windows, the closed loop, the check), the control and the planted
faults coming out not correct, the trace and metric readers, the import
guard, and a new cell added by data files alone."""

import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.core import analytics
from weaverbench import devtrace, harness

REPO = Path(__file__).resolve().parent.parent
TINY = {"urand_s22": {"scale": 11}, "g500_s24": {"scale": 12}}
# the PageRank cell waits for a later PR (its files are here; PERF.md,
# open questions): the tests add its entries as that PR would
PAGERANK_CELL = {"name": "urand_s22.pagerank", "config": "urand_s22",
                 "traffic": "pagerank", "chips": 1, "why": "PageRank"}
ROOFLINE = {"name": "traversal_roofline_pct", "unit": "%",
            "better": "higher", "source": "device_trace",
            "layer": "kernels", "moves": "queries_per_s",
            "workloads": ["urand_s22.pagerank"]}
CELLS = ["urand_s22.bfs", "g500_s24.bfs", "urand_s22.pagerank"]


def tiny_root(tmp_path: Path) -> Path:
    """A checkout's benchmark files with each configuration cut to a size
    a test can hold."""
    here = tmp_path / "weaverbench"
    for sub in ("configs", "traffic", "metrics", "generators", "kinds"):
        shutil.copytree(REPO / "weaverbench" / sub, here / sub)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["workloads"].append(PAGERANK_CELL)
    bench["per_layer"].append(ROOFLINE)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for name, cut in TINY.items():
        path = here / "configs" / f"{name}.json"
        path.write_text(json.dumps(dict(json.loads(path.read_text()), **cut)))
    return tmp_path


def run(root, cell, seed=2**33 + 1, trace=False, impl="program",
        queries=6):
    return harness.run(root, cell, seed, 60.0, trace, "cpu", lambda: 1.5,
                       impl=impl, max_queries=queries)


@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal(tmp_path, cell):
    r = run(tiny_root(tmp_path), cell)
    assert r["correct"] is True
    assert r["attempted"] == 6 and r["failed"] == 0
    assert set(r["metrics"]) == {"queries_per_s", "query_p95_ms", "setup_s"}
    assert r["metrics"]["setup_s"] == {"value": 1.5, "unit": "s"}
    assert list(r)[-1] == "check"
    assert all(c["value"] <= c["limit"] for c in r["check"].values())
    assert r["check"]["snapshot_changed"]["value"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_traced_on_cpu_reads_no_device_metric(tmp_path, cell):
    r = run(tiny_root(tmp_path), cell, trace=True, queries=3)
    assert r["correct"] is True
    assert r["metrics"] == {}           # no device: nothing to read
    assert "breakdown" not in r and "busy_s" not in r["device"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [11, 2**31 + 7, 2**40 + 3])
def test_control_is_not_correct(tmp_path, cell, seed):
    """The control in the program's place: the reference one write
    window behind (BFS) or in bfloat16 (PageRank)."""
    r = run(tiny_root(tmp_path), cell, seed=seed, impl="control")
    assert r["correct"] is False


def _unchanged_bfs(src, dst, n, sources, **kw):
    out = torch.full((n,), int(analytics.INF), dtype=torch.int32)
    out[list(sources)] = 0
    return out


FAULTS = {
    "bfs": {
        "state_unchanged": _unchanged_bfs,
        "half_the_edges": lambda f: lambda s, d, n, r, **kw: f(
            s[: s.numel() // 2], d[: d.numel() // 2], n, r, **kw),
        "answer_altered": lambda f: lambda *a, **kw: _bump_level(f(*a, **kw)),
    },
    "pagerank": {
        "state_unchanged": lambda f: lambda s, d, n, *a, **kw: torch.full(
            (n,), 1.0 / n),
        "half_the_edges": lambda f: lambda s, d, n, *a, **kw: f(
            s[: s.numel() // 2], d[: d.numel() // 2], n, *a, **kw),
        "answer_altered": lambda f: lambda *a, **kw: _scale_rank(f(*a, **kw)),
    },
}


def _bump_level(out):
    reached = (out > 0) & (out < analytics.INF)
    out[reached.nonzero()[0]] += 1
    return out


def _scale_rank(out):
    out[out.numel() // 2] *= 1.5
    return out


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_edges",
                                   "answer_altered"])
def test_planted_fault_is_not_correct(tmp_path, monkeypatch, cell, fault):
    """The run with the timed path broken underneath it (the cells run on
    one card, so there is no exchange between cards to leave out)."""
    kind = cell.split(".")[1]
    entry = {"bfs": "bfs_levels", "pagerank": "pagerank"}[kind]
    real = getattr(analytics, entry)
    broken = FAULTS[kind][fault]
    if fault == "state_unchanged" and kind == "bfs":
        monkeypatch.setattr(analytics, entry, broken)
    else:
        monkeypatch.setattr(analytics, entry, broken(real))
    assert run(tiny_root(tmp_path), cell)["correct"] is False


def test_input_changed_by_program_is_not_correct(tmp_path, monkeypatch):
    real = analytics.bfs_levels

    def scribbles(src, dst, n, sources, **kw):
        src[0] = (int(src[0]) + 1) % n
        return real(src, dst, n, sources, **kw)

    monkeypatch.setattr(analytics, "bfs_levels", scribbles)
    r = run(tiny_root(tmp_path), "urand_s22.bfs")
    assert r["correct"] is False
    assert r["check"]["snapshot_changed"]["value"] > 0


NEW_GENERATOR = textwrap.dedent("""
    import torch
    from weaverbench import graphs

    def build(cfg, seed, device):
        # a ring of 2**scale vertices with a chord from each to its double
        n = 2 ** cfg["scale"]
        v = torch.arange(n, dtype=torch.int32, device=device)
        s = torch.cat([v, v[1:]])
        d = torch.cat([(v + 1) % n, (2 * v[1:]) % n])
        keep = s != d
        return graphs.undirected(n, s[keep], d[keep], cfg["graph_seed"],
                                 seed, 0)
    """)

NEW_KIND = textwrap.dedent("""
    import torch
    from repro_torch.core import analytics
    from weaverbench.reference import bfs as ref_bfs

    class Query:
        # the depth of a BFS from vertex 0's id: one number an answer
        def __init__(self, traffic, live, seed):
            self.root = int(live.perm[0])
        def args(self, k):
            return self.root
        def program(self, live, root):
            lv = analytics.bfs_levels(live.src, live.dst, live.n, [root],
                                      dst_sorted=True)
            return lv[lv < analytics.INF].max()
        def control(self, live, root):
            return self.program(live, root) + 1
        def work(self, out, live):
            return {"rounds": int(out) + 1}
        def reference(self, live, root):
            lv = ref_bfs.levels(live.src, live.dst, live.n, root)
            return lv[lv != ref_bfs.UNREACHED].max()
        @staticmethod
        def compare(out, ref):
            return {"depth_wrong": int((out - ref).abs())}
    """)


def test_new_cell_from_data_files_alone(tmp_path):
    """A configuration with a generator of its own, a traffic mix with a
    query kind of its own and a per-layer metric, each a new file, plus
    entries in BENCHMARK.json: the harness finds them by name."""
    root = tiny_root(tmp_path)
    here = root / "weaverbench"
    (here / "configs" / "tiny_ring.json").write_text(json.dumps({
        "name": "tiny_ring", "generator": "ring_chords", "scale": 9,
        "graph_seed": 3}))
    (here / "generators" / "ring_chords.py").write_text(NEW_GENERATOR)
    (here / "traffic" / "depth.json").write_text(json.dumps({
        "name": "depth", "query": "bfs_depth", "write_fraction": 0.002,
        "check_queries": 3,
        "limits": {"depth_wrong": 0, "snapshot_changed": 0}}))
    (here / "kinds" / "bfs_depth.py").write_text(NEW_KIND)
    (here / "metrics" / "rounds_per_query.py").write_text(textwrap.dedent("""
        def read(run):
            return sum(w["rounds"] for w in run.work) / len(run.work)
        """))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_ring", "source": "test",
                             "file": "weaverbench/configs/tiny_ring.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny_ring.depth",
                               "config": "tiny_ring", "traffic": "depth",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "rounds_per_query", "unit": "rounds",
                               "better": "lower", "source": "program_counter",
                               "layer": "traversal",
                               "moves": "query_p95_ms",
                               "workloads": ["tiny_ring.depth"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    r = run(root, "tiny_ring.depth", trace=True, queries=4)
    assert r["correct"] is True
    assert r["metrics"]["rounds_per_query"]["unit"] == "rounds"
    assert r["metrics"]["rounds_per_query"]["value"] >= 2
    r = run(root, "tiny_ring.depth", queries=4)
    assert set(r["metrics"]) == {"queries_per_s", "query_p95_ms", "setup_s"}
    assert list(r["check"]) == ["depth_wrong", "snapshot_changed"]
    assert run(root, "tiny_ring.depth", queries=4,
               impl="control")["correct"] is False


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def test_trace_summary_hand_counted():
    trace = {"traceEvents": [
        _ev("user_annotation", devtrace.WINDOW, 0, 100),
        _ev("user_annotation", devtrace.QUERY, 10, 40),
        _ev("user_annotation", devtrace.QUERY, 60, 30),
        _ev("cpu_op", "aten::index", 12, 5),
        _ev("cuda_runtime", "cudaLaunchKernel", 13, 1, correlation=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 14, 1, correlation=2),
        _ev("cuda_runtime", "cudaMemcpyAsync", 30, 1, correlation=3),
        _ev("cuda_runtime", "cudaLaunchKernel", 5, 1, correlation=4),
        _ev("cuda_runtime", "cudaLaunchKernel", 61, 1, correlation=5),
        _ev("kernel", "gather", 15, 10, tid=7, correlation=1),
        _ev("kernel", "scatter", 25, 5, tid=7, correlation=2),
        _ev("gpu_memcpy", "Memcpy DtoH", 31, 1, tid=7, correlation=3),
        _ev("kernel", "write_window", 6, 2, tid=7, correlation=4),
        _ev("kernel", "gather", 62, 20, tid=7, correlation=5),
        {"ph": "M", "name": "process_name"},
    ]}
    s = devtrace.summarize(trace)
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(38e-6)          # 2 + 10 + 5 + 1 + 20
    assert s.query_launches == 3                     # write window left out
    assert s.query_device_s == pytest.approx(36e-6)
    assert s.device_ops[0] == ["gather", pytest.approx(30e-6)]
    # idle: [0,6] [8,15] [30,31] [32,62] [82,100], named by the innermost
    # host range open at each gap's middle
    assert dict(s.idle_gaps) == {
        "host in " + devtrace.QUERY: pytest.approx(37e-6),
        "host in the harness, between queries": pytest.approx(24e-6),
        "host in cudaMemcpyAsync": pytest.approx(1e-6)}
    assert devtrace.summarize({"traceEvents": trace["traceEvents"][:4]}) \
        is None


def test_metric_readers(tmp_path):
    summary = devtrace.Summary(2.0, 1.5, 300, 1.2, [], [])
    rec = harness.RunRecord(
        "NVIDIA H100 80GB HBM3", 9.0, 4.0, [0.1, 0.2, 0.3, 0.4],
        [{"rounds": 21, "least_bytes": 10**12, "traversed_edges": 5}] * 4,
        summary)
    read = lambda name: harness.load_reader(REPO, name)(rec)
    assert read("queries_per_s") == 1.0
    assert read("query_p95_ms") == pytest.approx(385.0)
    assert read("setup_s") == 9.0
    assert read("launches_per_round") == pytest.approx(300 / 84)
    assert read("round_device_ms") == pytest.approx(1.2 / 84 * 1e3)
    assert read("traversal_roofline_pct") == pytest.approx(
        100 * 4e12 / 3.35e12 / 1.2)
    assert read("bfs_device_teps") == pytest.approx(20 / 1.2)
    assert read("device_idle_pct") == pytest.approx(25.0)
    rec.device_name = "a card not in the table"
    assert read("traversal_roofline_pct") is None
    rec.trace = None
    for name in ("launches_per_round", "round_device_ms", "bfs_device_teps",
                 "device_idle_pct", "traversal_roofline_pct"):
        assert read(name) is None


GUARD = textwrap.dedent("""
    import json, sys
    from pathlib import Path
    opened = []
    sys.addaudithook(lambda ev, args: opened.append(str(args[0]))
                     if ev == "open" and args and isinstance(args[0], str)
                     else None)
    from weaverbench import harness
    root = Path(sys.argv[1])
    r = harness.run(root, "g500_s24.bfs", 5, 60.0, False, "cpu",
                    lambda: 0.0, max_queries=2)
    tops = sorted({m.split(".")[0] for m in sys.modules})
    print(json.dumps({"correct": r["correct"], "tops": tops,
                      "opened": opened}))
    """)


def test_import_guard(tmp_path):
    """Loading and running a cell loads no jax, jaxlib, flax or repro
    (top-level names compared whole: repro_torch is the port), and opens
    nothing of the old benchmarks/ folder or its BENCH_*.json."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), str(REPO / "src")]))
    out = subprocess.run([sys.executable, "-c", GUARD,
                          str(tiny_root(tmp_path))], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"] is True
    assert "repro_torch" in got["tops"]
    assert not {"jax", "jaxlib", "flax", "repro", "benchmarks"} & set(
        got["tops"])
    bad = [p for p in got["opened"] if "/benchmarks/" in p
           or os.path.basename(p).startswith("BENCH_")]
    assert bad == []


def test_run_refuses_without_a_card():
    """The run command prints no result where there is no CUDA device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal needs none")
    out = subprocess.run(
        [sys.executable, "weaverbench/run.py", "--workload",
         "urand_s22.bfs", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=240)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
