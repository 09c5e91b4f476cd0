"""The split of a trace by the program's own ranges (``weaverbench.spans``)
on hand-counted traces, its command line, and the program's count of a
query's rounds (``obs.DATA_PLANE``) held against the rounds its answer
implies, in both BFS cells at tiny sizes."""

import json
import shutil
from pathlib import Path

import pytest

from repro_torch.core import obs
from weaverbench import devtrace, graphs, harness, spans

REPO = Path(__file__).resolve().parent.parent
TINY = {"urand_s22": {"scale": 11}, "g500_s24": {"scale": 12}}
CALL = "analytics.bfs_levels"


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def _program_trace():
    """A window with one query whose BFS call has a ``.prepare`` and two
    reads (``aten::item``, one with ``aten::_local_scalar_dense`` inside
    from its start), hand-counted in the tests below.  Device busy:
    [15,28] [36,56] [70,85] [86,87] [151,160]; idle: [0,15] [28,36]
    [56,70] [85,86] [87,151] [160,200]."""
    return {"traceEvents": [
        _ev("user_annotation", devtrace.WINDOW, 0, 200),
        _ev("user_annotation", devtrace.QUERY, 10, 100),
        _ev("user_annotation", CALL, 12, 88),
        _ev("user_annotation", CALL + ".prepare", 13, 17),
        _ev("cpu_op", "aten::item", 50, 10),
        _ev("cpu_op", "aten::_local_scalar_dense", 51, 8),
        _ev("cpu_op", "aten::_local_scalar_dense", 80, 14),
        _ev("cpu_op", "aten::item", 80, 15),
        _ev("cpu_op", "aten::item", 102, 3),             # the harness's
        _ev("user_annotation", CALL, 20, 30, tid=2),     # another thread
        _ev("cpu_op", "aten::item", 40, 5, tid=2),
        _ev("user_annotation", CALL, 205, 10),           # after the window
        _ev("cuda_runtime", "cudaLaunchKernel", 14, 1, correlation=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 20, 1, correlation=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 35, 1, correlation=3),
        _ev("cuda_runtime", "cudaMemcpyAsync", 52, 1, correlation=4),
        _ev("cuda_runtime", "cudaLaunchKernel", 65, 1, correlation=5),
        _ev("cuda_runtime", "cudaMemcpyAsync", 86, 1, correlation=6),
        _ev("cuda_runtime", "cudaLaunchKernel", 150, 1, correlation=7),
        _ev("kernel", "copy", 15, 10, tid=7, correlation=1),
        _ev("kernel", "fill", 25, 3, tid=7, correlation=2),
        _ev("kernel", "gather", 36, 19, tid=7, correlation=3),
        _ev("gpu_memcpy", "Memcpy DtoH", 55, 1, tid=7, correlation=4),
        _ev("kernel", "gather", 70, 15, tid=7, correlation=5),
        _ev("gpu_memcpy", "Memcpy DtoH", 86, 1, tid=7, correlation=6),
        _ev("kernel", "write_window", 151, 9, tid=7, correlation=7),
    ]}


def test_split_hand_counted():
    t = spans.split(_program_trace())
    assert sorted(t) == [CALL, CALL + ".prepare", CALL + ".sync"]
    call, prep, sync = t[CALL], t[CALL + ".prepare"], t[CALL + ".sync"]
    assert (call.count, prep.count, sync.count) == (1, 1, 2)
    assert call.host_s == pytest.approx(88e-6)
    assert prep.host_s == pytest.approx(17e-6)
    assert sync.host_s == pytest.approx(25e-6)
    # launched inside: the call counts its steps' launches too
    assert call.device_s == pytest.approx(49e-6)     # 10+3+19+1+15+1
    assert prep.device_s == pytest.approx(13e-6)     # copy and fill
    assert sync.device_s == pytest.approx(2e-6)      # the two reads
    # idle, each piece to the innermost range open over it: [12,13] to
    # the call and [13,15] to .prepare; [28,30] .prepare, [30,36] the
    # call; [56,60] the first read, whose exit the gap straddles, and
    # [60,70] the call up to the next kernel; [85,86] and [87,95] the
    # second read; [95,100] the call; the rest outside every program
    # range, the harness's read at [102,105] too
    assert call.idle_s == pytest.approx(22e-6)       # 1 + 6 + 10 + 5
    assert prep.idle_s == pytest.approx(4e-6)        # 2 + 2
    assert sync.idle_s == pytest.approx(13e-6)       # 4 + 1 + 8
    lines = spans.table(t)
    assert len(lines) == 4 and lines[1].split()[:2] == [CALL, "1"]


def test_breakdown_midpoint_names_the_program_ranges():
    """``devtrace``'s own numbers are those of the same trace with no
    program range in it; only its midpoint names now find the call."""
    trace = _program_trace()
    s = devtrace.summarize(trace)
    plain = devtrace.summarize({"traceEvents": [
        e for e in trace["traceEvents"]
        if not e["name"].startswith(spans.PROGRAM)]})
    assert (s.window_s, s.busy_s, s.query_launches, s.query_device_s,
            s.device_ops) == (plain.window_s, plain.busy_s,
                              plain.query_launches, plain.query_device_s,
                              plain.device_ops)
    assert s.query_device_s == pytest.approx(spans.split(trace)[CALL]
                                             .device_s)
    assert dict(s.idle_gaps) == {
        "host in the harness, between queries": pytest.approx(119e-6),
        "host in " + CALL: pytest.approx(22e-6),
        "host in aten::item": pytest.approx(1e-6)}
    assert dict(plain.idle_gaps)["host in " + devtrace.QUERY] == \
        pytest.approx(22e-6)


def test_split_without_program_ranges():
    """A trace of a program with no ranges of its own: nothing to split,
    the reads of one value left out with no range to name them by."""
    evs = [e for e in _program_trace()["traceEvents"]
           if not e["name"].startswith(spans.PROGRAM)]
    assert any(e["name"] in spans.READS for e in evs)
    assert spans.split({"traceEvents": evs}) == {}
    assert spans.split({"traceEvents": []}) == {}
    assert len(spans.table({})) == 1


def test_command_line_reads_a_trace_without_a_window(tmp_path, capsys):
    """An operator's own trace has no harness window: the whole trace is
    read, on the thread of the first program range."""
    evs = [e for e in _program_trace()["traceEvents"]
           if e["name"] not in (devtrace.WINDOW, devtrace.QUERY)]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": evs}))
    assert spans.main([str(path)]) == 0
    rows = {r.split()[0]: r.split()[1:]
            for r in capsys.readouterr().out.splitlines()[1:]}
    # the call after the old window now counts, with its idle [205,215];
    # thread 2 does not
    assert rows[CALL] == ["2", "0.098", "0.049", "0.032"]
    assert rows[CALL + ".sync"][0] == "2"
    assert rows[CALL + ".prepare"] == ["1", "0.017", "0.013", "0.004"]
    assert spans.main([]) == 2


def tiny_root(tmp_path: Path) -> Path:
    """A checkout's benchmark files with each configuration cut to a size
    a test can hold."""
    here = tmp_path / "weaverbench"
    for sub in ("configs", "traffic", "generators", "kinds"):
        shutil.copytree(REPO / "weaverbench" / sub, here / sub)
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for name, cut in TINY.items():
        path = here / "configs" / f"{name}.json"
        path.write_text(json.dumps(dict(json.loads(path.read_text()), **cut)))
    return tmp_path


@pytest.mark.parametrize("name", ["urand_s22.bfs", "g500_s24.bfs"])
def test_program_rounds_equal_the_answers_rounds(tmp_path, name):
    """The program's own count of rounds and reads over a cell's queries
    against the yardstick's (``work.bfs_rounds`` of each answer), each
    query on a new snapshot as in the harness's window."""
    root = tiny_root(tmp_path)
    cell = harness.load_cell(root, name)
    gen = harness.load(root, "generators", cell.config["generator"])
    seed = 2**33 + 5
    live = getattr(gen, "LiveGraph", graphs.LiveGraph)(
        gen.build(cell.config, seed, "cpu"), cell.traffic["write_fraction"])
    query = harness.load(root, "kinds", cell.traffic["query"]).Query(
        cell.traffic, live, seed)
    before = dict(obs.DATA_PLANE.counters)
    answers = 0
    for k in range(5):
        live.write_window(k)
        answers += int(query.work(query.program(live, query.args(k)),
                                  live)["rounds"])
    gained = {k: v - before.get(k, 0)
              for k, v in obs.DATA_PLANE.counters.items()}
    assert gained[CALL + ".rounds"] == gained[CALL + ".syncs"] == answers
    assert answers >= 5 * 2
