"""The data-plane spans and counters of the port's traversals
(``obs.device_span``, ``obs.DATA_PLANE``): the ranges a profiler
records, none built without one, answers unchanged by them, and counters
equal to the rounds the loop ran."""

import json

import pytest
import torch

from repro_torch.core import analytics, obs

# (edges one way, vertex count, sources): a path 0-1-2-3-4 with a
# separate pair 5-6; a cycle of 9 with a chord; a star of 6 leaves
GRAPHS = {
    "path_and_pair": ([(0, 1), (1, 2), (2, 3), (3, 4), (5, 6)], 8, [0]),
    "cycle_chord": ([(i, (i + 1) % 9) for i in range(9)] + [(0, 4)], 9,
                    [2]),
    "star": ([(0, i) for i in range(1, 7)], 7, [3, 5]),
}


def _graph(name):
    pairs, n, sources = GRAPHS[name]
    src = torch.tensor([a for a, b in pairs] + [b for a, b in pairs])
    dst = torch.tensor([b for a, b in pairs] + [a for a, b in pairs])
    order = torch.argsort(dst, stable=True)
    return (src[order].to(torch.int32), dst[order].to(torch.int32), n,
            sources)


def _rounds(levels):
    """Rounds the loop runs: one a level beyond the sources, and the
    round that finds nothing."""
    return int(levels[levels < analytics.INF].max()) + 1


def _events(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


def _ranges(evs, cat="user_annotation", prefix="analytics."):
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"], e["tid"]) for e in evs
                  if e.get("ph") == "X" and e.get("cat") == cat
                  and e["name"].startswith(prefix))


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_bfs_ranges_nest_on_one_thread(tmp_path, graph):
    src, dst, n, sources = _graph(graph)
    with _profile() as prof:
        levels = analytics.bfs_levels(src, dst, n, sources, dst_sorted=True)
    evs = _events(prof, tmp_path)
    got = _ranges(evs)
    assert [name for _, _, name, _ in got] == [
        "analytics.bfs_levels", "analytics.bfs_levels.prepare"]
    (c0, c1, _, tid), (p0, p1, _, ptid) = got
    assert c0 <= p0 <= p1 <= c1 and tid == ptid
    # each round's read of its flag is the profiler's own range (the one
    # ``weaverbench.spans`` names the call's ``.sync``): one a round,
    # after the set-up, inside the call, on its thread
    syncs = _ranges(evs, "cpu_op", "aten::item")
    assert len(syncs) == _rounds(levels)
    assert all(c0 <= a <= b <= c1 and a >= p1 and t == tid
               for a, b, _, t in syncs)
    # one read after another, never overlapping
    assert all(syncs[i][1] <= syncs[i + 1][0] for i in range(len(syncs) - 1))


def test_pagerank_ranges(tmp_path):
    src, dst, n, _ = _graph("cycle_chord")
    with _profile() as prof:
        analytics.pagerank(src, dst, n, n_iters=5, dst_sorted=True)
    got = _ranges(_events(prof, tmp_path))
    assert [name for _, _, name, _ in got] == [
        "analytics.pagerank", "analytics.pagerank.prepare"]
    (c0, c1, _, _), (p0, p1, _, _) = got
    assert c0 <= p0 <= p1 <= c1


def test_device_span_records_only_under_a_profiler():
    assert obs.device_span("analytics.x") is obs.device_span("analytics.y")
    with _profile():
        span = obs.device_span("analytics.x")
        assert isinstance(span, torch.profiler.record_function)


def test_no_record_function_built_without_a_profiler(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function built with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    src, dst, n, sources = _graph("path_and_pair")
    levels = analytics.bfs_levels(src, dst, n, sources)
    assert levels.tolist() == [0, 1, 2, 3, 4] + [int(analytics.INF)] * 3
    analytics.pagerank(src, dst, n, n_iters=3)
    with pytest.raises(AssertionError, match="no profiler"):
        with _profile():
            analytics.bfs_levels(src, dst, n, sources)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_answers_bit_identical_with_and_without_a_profiler(graph):
    src, dst, n, sources = _graph(graph)
    plain = (analytics.bfs_levels(src, dst, n, sources),
             analytics.pagerank(src, dst, n, n_iters=7))
    with _profile():
        traced = (analytics.bfs_levels(src, dst, n, sources),
                  analytics.pagerank(src, dst, n, n_iters=7))
    for a, b in zip(plain, traced):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_counters_equal_the_loop_rounds(graph):
    src, dst, n, sources = _graph(graph)
    before = dict(obs.DATA_PLANE.counters)
    levels = analytics.bfs_levels(src, dst, n, sources)
    analytics.bfs_levels(src, dst, n, sources, max_iters=1)
    analytics.pagerank(src, dst, n, n_iters=4)
    gained = {k: v - before.get(k, 0)
              for k, v in obs.DATA_PLANE.counters.items()}
    assert gained["analytics.bfs_levels.rounds"] == _rounds(levels) + 1
    assert gained["analytics.bfs_levels.syncs"] == _rounds(levels) + 1
    assert gained["analytics.pagerank.rounds"] == 4


def test_data_plane_is_no_deployment_registry():
    """The counters live apart from every simulator's registry and from
    ``Counters``."""
    from repro_torch.core.simulation import Simulator
    sim = Simulator()
    assert sim.metrics is not obs.DATA_PLANE
    assert "analytics.bfs_levels.rounds" not in vars(sim.counters)
    assert set(obs.DATA_PLANE.export()) == {
        "counters", "gauges", "histograms", "timeline"}
