"""The ``urand_s22_mv4.bfs_at`` cell on the CPU at a size a test holds:
the plain reference against a hand-worked versioned graph, the
deployment's stamps (each query finds the other gatekeepers' last
announce period concurrent and every earlier write before it), a
rehearsal of the cell, the control and planted faults of the program
(refinement, visibility, traversal, GC, compaction, a query that writes
the table) coming out not correct, and the new readers."""

import copy
import json
import shutil
from pathlib import Path

import pytest
import torch

from repro_torch.core import analytics, clock
from repro_torch.core.clock import Order, compare
from repro_torch.core.edgeversions import EdgeVersionTable
from repro_torch.kernels.mv_visibility import ops as mv_ops
from weaverbench import devtrace, harness, work_mv
from weaverbench.reference import bfs as ref_bfs
from weaverbench.reference import bfs_at as ref_bfs_at

REPO = Path(__file__).resolve().parent.parent
CELL = "urand_s22_mv4.bfs_at"
NO = ref_bfs_at.NO_STAMP
UN = ref_bfs.UNREACHED


def tiny_root(tmp_path: Path) -> Path:
    """The benchmark's files with the cell cut to 2**10 vertices and a
    write window of 2 % of the slots (163 transactions, so that a window
    holds a whole announce period of 16)."""
    here = tmp_path / "weaverbench"
    for sub in ("configs", "traffic", "metrics", "generators", "kinds"):
        shutil.copytree(REPO / "weaverbench" / sub, here / sub)
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for folder, name, cut in (("configs", "urand_s22_mv4", {"scale": 10}),
                              ("traffic", "bfs_at", {"write_fraction": 0.02})):
        path = here / folder / f"{name}.json"
        path.write_text(json.dumps(dict(json.loads(path.read_text()), **cut)))
    return tmp_path


def run(root, seed=2**33 + 1, trace=False, impl="program", queries=6):
    return harness.run(root, CELL, seed, 60.0, trace, "cpu", lambda: 1.5,
                       impl=impl, max_queries=queries)


def test_reference_hand_worked():
    """Six vertices, two gatekeepers, the query at (2, 2): a version
    deleted before it, one re-created, one created concurrently (visible
    after refinement), one deleted concurrently (hidden after
    refinement), one created after it, one at a later epoch, one whose
    create stamp is none."""
    t = torch.tensor
    src = t([0, 1, 1, 2, 3, 4, 0, 5], dtype=torch.int32)
    dst = t([1, 2, 2, 3, 4, 5, 5, 0], dtype=torch.int32)
    stamps = t([[NO, NO, NO], [0, 0, 0], [0, 1, 0], [0, 1, 1], [0, 3, 0],
                [0, 2, 3], [1, 0, 0], [0, 0, 3]], dtype=torch.int32)
    made = t([1, 2, 3, 4, 1, 5, 6, 0], dtype=torch.int32)
    gone = t([0, 3, 0, 0, 7, 0, 0, 0], dtype=torch.int32)
    q = t([0, 2, 2], dtype=torch.int32)
    levels, vis = ref_bfs_at.levels_at(src, dst, made, gone, stamps, q, 6, 0)
    assert vis.tolist() == [True, False, True, True, False, False, False,
                            False]
    assert levels.tolist() == [0, 1, 2, 3, UN, UN]
    assert torch.equal(vis, ref_bfs_at.visible(stamps[made.long()],
                                               stamps[gone.long()], q))
    levels, vis = ref_bfs_at.levels_at(src, dst, made, gone, stamps, q, 6, 0,
                                       refine=False)
    assert vis.tolist() == [True, False, True, False, True, False, False,
                            False]
    assert levels.tolist() == [0, 1, 2, UN, UN, UN]
    bits = t([0b1101], dtype=torch.int32)
    assert ref_bfs_at.mask_of_bits(bits, 8).tolist() == [
        True, False, True, True, False, False, False, False]


def test_pair_multisets_hand_counted():
    t = torch.tensor
    a = ref_bfs_at.pair_keys(t([3, 1, 1]), t([4, 2, 2]))
    b = ref_bfs_at.pair_keys(t([5, 1]), t([6, 2]))
    assert a.tolist() == [(1 << 32) | 2, (1 << 32) | 2, (3 << 32) | 4]
    assert ref_bfs_at.pair_difference(a, b) == 3      # (1,2) once, (3,4), (5,6)
    assert ref_bfs_at.pair_difference(a, a.clone()) == 0
    assert ref_bfs_at.pair_difference(a, a[:0]) == 3


def test_each_query_finds_the_last_period_of_the_other_gatekeepers(tmp_path):
    root = tiny_root(tmp_path)
    cell = harness.load_cell(root, CELL)
    gen = harness.load(root, "generators", cell.config["generator"])
    live = gen.LiveGraph(gen.build(cell.config, 5, "cpu"),
                         cell.traffic["write_fraction"])
    g, period = cell.config["n_gatekeepers"], cell.config["announce_every"]
    for k in range(5):
        start = live.txs
        live.write_window(k)
        at, m = live.at, live.txs - start
        assert at.gk == k % g
        stamps = [live._stamp(start + j, start + m - period)
                  for j in range(m - period, m)]
        conc = [s for s in stamps if compare(s, at) is Order.CONCURRENT]
        assert len(conc) == period // g * (g - 1)
        assert all(s.gk != at.gk for s in conc)
        kept = {x.key() for s in live.table.recent.values() for x in s
                if x is not None}
        assert {s.key() for s in conc} <= kept
        # every row's packed stamps: the last period's are the only ones
        # concurrent with the query, as many rows as its 12 writes hold
        q = torch.from_numpy(clock.pack(at, g))
        t = live.table
        n_conc = int((ref_bfs_at.visible(t.create_rows, t.delete_rows, q)
                      != ref_bfs_at.visible(t.create_rows, t.delete_rows, q,
                                            refine=False)).sum())
        assert n_conc == 8 * len(conc)
        # the generator's record and the port's table hold the same
        # visible versions
        r = live.record
        _, vis = ref_bfs_at.levels_at(r.src, r.dst, r.made, r.gone,
                                      r.stamps, live.at_row, live.n, 0)
        seen = ref_bfs_at.visible(t.create_rows, t.delete_rows, q)
        assert torch.equal(ref_bfs_at.pair_keys(r.src[vis], r.dst[vis]),
                           ref_bfs_at.pair_keys(t.src[seen], t.dst[seen]))
        assert torch.equal(live.at_row, q)


def test_rehearsal(tmp_path):
    r = run(tiny_root(tmp_path))
    assert r["correct"] is True
    assert set(r["metrics"]) == {"queries_per_s", "query_p95_ms", "setup_s"}
    assert list(r["check"]) == ["levels_wrong", "visibility_wrong",
                                "snapshot_changed"]
    assert all(c["value"] == 0 for c in r["check"].values())


def test_rehearsal_traced_on_cpu_reads_the_program_counter(tmp_path):
    r = run(tiny_root(tmp_path), trace=True, queries=3)
    assert r["correct"] is True
    assert r["metrics"] == {"oracle_stamps_per_query": {"value": 12.0,
                                                        "unit": "stamps"}}


@pytest.mark.parametrize("seed", [11, 2**31 + 7, 2**40 + 3])
def test_control_is_not_correct(tmp_path, seed):
    """The reference without refinement in the program's place."""
    r = run(tiny_root(tmp_path), seed=seed, impl="control")
    assert r["correct"] is False
    assert r["check"]["visibility_wrong"]["value"] > 0


def _skip_log(real):
    def skip(table, at, sources, oracle, **kw):
        base = copy.copy(table)
        base.n = table.sorted_rows
        levels, bits = real(base, at, sources, oracle, **kw)
        full = torch.zeros((table.n + 31) // 32, dtype=torch.int32)
        full[:bits.numel()] = bits
        return levels, full
    return skip


def _deletes_ignored(real):
    return lambda c, d, q, res=None: real(c, torch.full_like(d, NO), q, res)


def _purge_drops_a_live_version(real):
    def purge(table, q):
        k = real(table, q)
        n = table.n
        live = ((table._delete[:n, 0] == NO)
                & (table._create[:n, 0] != NO)).nonzero()
        table._create[live[0]] = NO
        return k
    return purge


def _compaction_moves_an_end(real):
    def compact(table, *a, **kw):
        moved = real(table)
        table._src[[0, table.n - 1]] = table._src[[table.n - 1, 0]]
        return moved
    return compact


def _query_writes_a_stamp(real):
    def query(table, *a, **kw):
        out = real(table, *a, **kw)
        table._create[0, 0] += 0 if int(table._create[0, 0]) == NO else 1
        return out
    return query


@pytest.mark.parametrize("fault", ["concurrent_after", "deletes_ignored",
                                   "log_skipped", "purge_drops_live",
                                   "compaction_moves_an_end",
                                   "query_writes_a_stamp"])
def test_planted_fault_is_not_correct(tmp_path, monkeypatch, fault):
    """Faults of the program; those of the GC and the compaction act on
    the check's replay too, which the reference does not read."""
    if fault == "concurrent_after":     # refinement skipped
        monkeypatch.setattr(analytics, "_refine_residue", lambda *a: 0)
    elif fault == "deletes_ignored":
        monkeypatch.setattr(mv_ops, "visibility_residue",
                            _deletes_ignored(mv_ops.visibility_residue))
    elif fault == "log_skipped":
        monkeypatch.setattr(analytics, "bfs_levels_at",
                            _skip_log(analytics.bfs_levels_at))
    elif fault == "purge_drops_live":
        monkeypatch.setattr(EdgeVersionTable, "purge_deleted_before",
                            _purge_drops_a_live_version(
                                EdgeVersionTable.purge_deleted_before))
    elif fault == "compaction_moves_an_end":   # compacting every window
        monkeypatch.setattr(EdgeVersionTable, "maybe_compact",
                            _compaction_moves_an_end(EdgeVersionTable.compact))
    else:
        monkeypatch.setattr(analytics, "bfs_levels_at",
                            _query_writes_a_stamp(analytics.bfs_levels_at))
    r = run(tiny_root(tmp_path))
    assert r["correct"] is False
    if fault == "query_writes_a_stamp":
        assert r["check"]["snapshot_changed"]["value"] > 0


def test_compaction_every_window_stays_correct(tmp_path, monkeypatch):
    monkeypatch.setattr(EdgeVersionTable, "maybe_compact",
                        lambda table, *a, **kw: table.compact())
    assert run(tiny_root(tmp_path))["correct"] is True


def test_readers_hand_counted():
    ops = [["void (anonymous namespace)::visibility_residue_kernel<5>(int "
            "const*", 0.004],
           ["void (anonymous namespace)::masked_relax_kernel<true>(int "
            "const*", 0.02],
           ["void (anonymous namespace)::relax_kernel<true>(int const*",
            0.5]]
    summary = devtrace.Summary(2.0, 1.5, 300, 1.2, ops, [])
    work = [{"rounds": 7, "rows": 10**8, "oracle_stamps": s,
             "visibility_bytes": work_mv.visibility_least_bytes(10**8, 5),
             "masked_round_bytes": work_mv.masked_round_least_bytes(10**8,
                                                                    7)}
            for s in (12, 12, 11, 13)]
    rec = harness.RunRecord("NVIDIA H100 80GB HBM3", 9.0, 4.0,
                            [0.1] * 4, work, summary)
    read = lambda name: harness.load_reader(REPO, name)(rec)
    assert work_mv.visibility_least_bytes(8, 5) == 8 * 40 + 1
    assert work_mv.masked_round_least_bytes(9, 2) == 2 * (9 * 8 + 2)
    assert read("visibility_roofline_pct") == pytest.approx(
        100 * 4 * (4 * 10**9 + 1.25e7) / 3.35e12 / 0.004)
    assert read("masked_round_roofline_pct") == pytest.approx(
        100 * 4 * 7 * (8 * 10**8 + 1.25e7) / 3.35e12 / 0.02)
    assert read("oracle_stamps_per_query") == 12.0
    for name in ("launches_per_round", "round_device_ms", "bfs_device_teps",
                 "device_idle_pct"):
        for cell in ("bfs_at", "pagerank"):
            if (REPO / "weaverbench" / "metrics"
                    / f"{name}.{cell}.py").exists():
                assert read(f"{name}.{cell}") == read(name)
    rec.trace = devtrace.Summary(2.0, 1.5, 300, 1.2, ops[2:], [])
    assert read("visibility_roofline_pct") is None
    assert read("masked_round_roofline_pct") is None
    rec.device_name = "a card not in the table"
    rec.trace = summary
    assert read("visibility_roofline_pct") is None
    rec.work = [{"rounds": 7}]
    assert read("oracle_stamps_per_query") is None


def test_benchmark_entries():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    assert cells[CELL]["config"] == "urand_s22_mv4"
    assert cells["urand_s22.pagerank"]["traffic"] == "pagerank"
    assert all(cells[c]["chips"] == 1 for c in (CELL, "urand_s22.pagerank"))
    per = {m["name"]: m for m in bench["per_layer"]}
    for name in ("visibility_roofline_pct", "masked_round_roofline_pct",
                 "oracle_stamps_per_query"):
        assert per[name]["workloads"] == [CELL]
        assert (REPO / "weaverbench" / "metrics" / f"{name}.py").exists()
    assert per["traversal_roofline_pct"]["workloads"] == [
        "urand_s22.pagerank"]
    # the accepted device metrics, each under a name of its own a new cell
    for name, cells in (("launches_per_round", ("bfs_at", "pagerank")),
                        ("round_device_ms", ("bfs_at", "pagerank")),
                        ("bfs_device_teps", ("bfs_at",)),
                        ("device_idle_pct", ("bfs_at", "pagerank"))):
        for cell in cells:
            m = per[f"{name}.{cell}"]
            assert m["workloads"] == [CELL if cell == "bfs_at"
                                      else "urand_s22.pagerank"]
            assert {k: m[k] for k in ("unit", "better", "source", "layer",
                                      "moves")} == {
                k: per[name][k] for k in ("unit", "better", "source",
                                          "layer", "moves")}
    cfg = json.loads((REPO / "weaverbench" / "configs" /
                      "urand_s22_mv4.json").read_text())
    base = json.loads((REPO / "weaverbench" / "configs" /
                       "urand_s22.json").read_text())
    for key in ("scale", "edge_factor", "num_vertices", "num_edges",
                "graph_seed", "reduced"):
        assert cfg[key] == base[key]
    assert cfg["stamp_columns"] == cfg["n_gatekeepers"] + 1 == 5
