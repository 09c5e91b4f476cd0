"""The failover half of the port held against the JAX reference: read
replicas and their promotion, windowed read admission, causal tracing and
the metrics timeline, and recovery under injected faults (WAL replay and
the store walk, torn WAL tails, crash points, the exactly-once client
retry).

One seeded op stream (``chip_smoke.make_stream`` with a shard kill and
the serving steps) goes through the reference ``Weaver`` and the port's
``Weaver(device="cpu")`` under each setting, with the column plane off
and on.  Every case must give equal records (program results,
``TxResult``s, counters, snapshot arrays, serving loops), an equal
metrics export and, where tracing is on, an equal Chrome trace with
every invariant checker clean in both packages.  Every node program is
re-executed in its callback by ``frontier.run_local`` at the stamp it
was answered at (the reference replica battery's bit-identity check,
``chip_smoke.ReadChecker``): the two packages must find the same
mismatches, and the only ones the reference has are clustering programs
answered by a replica (ROADMAP §3, reference behaviour).  Under faults
every acknowledged transaction is read back from the store and its live
shard, and each shard's WAL replay equals the store walk, in both
packages and across them.  Where the plane is on, its ``launches`` equal
the reference's and every rebuild keeps only the live partitions, at
B = pow2(max(min_block, 1.25 x the largest live table)), with masks equal
to the plain ``before`` (``chip_smoke.PlaneAudit``).
"""

import os
import sys

import pytest

import repro.core as ref_core
from repro.core import analytics as ref_analytics
from repro.core import faultinject as ref_fi
from repro.core import obs as ref_obs
import repro_torch.core as port_core
from repro_torch.core import analytics as port_analytics
from repro_torch.core import faultinject as port_fi
from repro_torch.core import obs as port_obs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

USERS = 200
BASE = dict(n_gatekeepers=2, n_shards=3, seed=5, write_group_commit=1e-3)


def stream(faults: int = 0) -> list:
    return chip_smoke.make_stream(5, USERS, avg_degree=6, n_tx=40, n_prog=4,
                                  chunk=64, kill="shard1",
                                  serve_requests=120, faults=faults)


STEPS = stream()
FAULT_STEPS = stream(faults=24)

REPLICAS = dict(n_replicas=2, read_group_commit=1e-3, read_window_alias=True)
# overrides of the round-robin pods: both replicas of shard0 and one of
# shard1 beside gk0
POD_MAP = {"gk0": 0, "gk1": 1, "shard0": 1, "shard1": 0, "shard2": 1,
           "shard0r0": 0, "shard0r1": 0, "shard1r1": 0}
PODS = dict(REPLICAS, pods=2, pod_map=POD_MAP, metrics_period=5e-3)
ADMISSION = dict(read_group_commit=1e-3, adaptive_admission=True,
                 admission_queue_limit=8, read_retry_timeout=4e-3,
                 shared_load_signal=True, read_your_writes=True,
                 trace_sample_rate=1.0)
CHAOS = dict(REPLICAS, read_retry_timeout=20e-3, trace_sample_rate=1.0)
RECOVERY = dict(read_retry_timeout=20e-3, trace_sample_rate=1.0)


def crash(point: str, target: str, after: int = 0, kind: str = "crash",
          arg: int = 1):
    return lambda fi: fi.FaultPlan([fi.FaultAction(
        kind, point=point, target=target, after=after, arg=arg)])


def chaos(seed: int):
    return lambda fi: fi.FaultPlan.random(seed, n_gk=2, n_shards=3,
                                          replica_faults=True)


# name -> (stream, WeaverConfig keywords, fault plan from a faultinject
# module or None, counters that must be > 0)
CASES = {
    # (a) replicas, read windows and alias; failover by promotion or WAL
    "replicas-promotion": (STEPS, REPLICAS, None,
                           ("replica_reads_served", "replica_promotions",
                            "stamps_settled")),
    "replicas-wal-recovery": (STEPS, dict(REPLICAS, replica_promotion=False),
                              None, ("replica_reads_served",
                                     "wal_replay_ops")),
    # (b) pods, causal tracing, the metrics timeline
    "pods-trace-0.25": (STEPS, dict(PODS, trace_sample_rate=0.25), None,
                        ("cross_pod_msgs", "spans_recorded",
                         "metrics_samples", "replica_reads_served")),
    "pods-trace-1.0": (STEPS, dict(PODS, trace_sample_rate=1.0), None,
                       ("cross_pod_msgs", "spans_recorded",
                        "metrics_samples", "replica_reads_served")),
    # (c) adaptive admission, queue limit, read retry, shared load signal,
    # read-your-writes; sheds NACKed or silent
    "admission-nack": (STEPS, dict(ADMISSION, shed_nack=True), None,
                       ("shed_nacks", "nack_reroutes", "progs_shed",
                        "acks_deferred", "window_grows_shared",
                        "prog_retries")),
    "admission-silent": (STEPS, dict(ADMISSION, shed_nack=False), None,
                         ("progs_shed", "acks_deferred",
                          "window_grows_shared", "prog_retries")),
    # (d) faults: random plans with the change feed hit, then the
    # reference fault battery's crash points under both recovery paths
    **{f"chaos-{s}": (FAULT_STEPS, CHAOS, chaos(s), ("crashes_injected",))
       for s in (0, 1, 2)},
    **{f"torn-mid-wal-{m}": (FAULT_STEPS, dict(RECOVERY, wal_replay=r),
                             # no entry of gk0's first window survives:
                             # a torn tail even where it holds one tx
                             crash("mid_wal", "gk0", kind="torn", arg=0),
                             ("crashes_injected", "client_retries"))
       for m, r in (("replay", True), ("walk", False))},
    **{f"mid-shard-apply-{m}": (FAULT_STEPS, dict(RECOVERY, wal_replay=r),
                                crash("mid_shard_apply", "shard0", 2),
                                ("crashes_injected",)
                                + (("wal_replay_ops",) if r else ()))
       for m, r in (("replay", True), ("walk", False))},
    **{f"epoch-barrier-{m}": (FAULT_STEPS, dict(RECOVERY, wal_replay=r),
                              crash("epoch_barrier", "shard2"),
                              ("crashes_injected",))
       for m, r in (("replay", True), ("walk", False))},
}


def run(pkg: str, steps: list, kw: dict, plan, plane: bool):
    """One package's run: (records, Weaver, read checker, plane audit)."""
    core, analytics, fi = ((ref_core, ref_analytics, ref_fi) if pkg == "ref"
                           else (port_core, port_analytics, port_fi))
    cfg = dict(BASE, **kw, device_shard_columns=plane,
               fault_plan=None if plan is None else plan(fi))
    if pkg == "port":
        cfg["device"] = "cpu"
    reads, audit = chip_smoke.ReadChecker(), chip_smoke.PlaneAudit()

    def hooks(w):
        reads.attach(w)
        if pkg == "port":
            audit.attach(w)

    recs, w = chip_smoke.run_stream(
        core, analytics, core.WeaverConfig(**cfg), steps,
        device=None if pkg == "ref" else "cpu", on_weaver=hooks)
    return recs, w, reads, audit


@pytest.mark.parametrize("plane", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_failover_matches_reference(case, plane):
    steps, kw, plan, positive = CASES[case]
    want, w_ref, reads_ref, _ = run("ref", steps, kw, plan, plane)
    got, w_port, reads, audit = run("port", steps, kw, plan, plane)
    assert chip_smoke.diff_records(want, got) == []
    assert w_port.sim.metrics.export() == w_ref.sim.metrics.export()

    counters = got[-1][1]
    assert all(counters[k] > 0 for k in positive), (
        {k: counters[k] for k in positive})
    assert [r[1] >= 1 for r in got if r[0] == "kill"] == [True]
    # every read re-executed at its stamp: the same findings in both
    # packages, and none but the reference's own (clustering answered by
    # a replica under aliased windows), so none without replicas
    assert reads.checked == reads_ref.checked > 20
    assert reads.mismatches == reads_ref.mismatches
    assert reads.unexplained(w_port.cfg) == [] \
        == reads_ref.unexplained(w_ref.cfg)
    if not kw.get("n_replicas"):
        assert reads.mismatches == []
    if kw.get("trace_sample_rate"):
        assert (port_obs.to_chrome_trace(w_port.sim.tracer.spans)
                == ref_obs.to_chrome_trace(w_ref.sim.tracer.spans))
        for obs, w in ((ref_obs, w_ref), (port_obs, w_port)):
            assert obs.run_invariant_checks(w.sim.tracer) == {
                "completeness": [], "exactly_once": [],
                "stamp_monotonic": [], "replica_staleness": []}
    if steps is FAULT_STEPS:
        # every acked transaction of the burst survives recovery, and
        # each shard's WAL replay (torn tails truncated) == the walk, in
        # both packages, with the same replayed state in both
        assert [r for r in got if r[0] == "unique"][0][1] == 24
        for w in (w_ref, w_port):
            assert chip_smoke.acked_lost(w, got) == []
            assert chip_smoke.replay_diffs(w) == []
        for sid in range(BASE["n_shards"]):
            prints = []
            for w in (w_ref, w_port):
                p = type(w.shards[0].partition)(2, intern=w.intern)
                for op in w.store.recover_shard(sid, use_wal=True):
                    p.apply_op(op, op["ts"])
                prints.append(chip_smoke.partition_print(p))
            assert prints[0] == prints[1]
        # right after the burst too, while a torn tail is still on the
        # log (a later checkpoint rewrite drops it): replay truncates it
        (replay,) = [r for r in got if r[0] == "replay"]
        assert replay[1] == []
        if case.startswith("torn"):
            assert replay[2] > 0
    if plane:
        plane_port = w_port.device_plane
        assert plane_port.stats["launches"] == \
            w_ref.device_plane.stats["launches"] > 0
        assert audit.bad == []
        assert audit.rebuilds and audit.masks_checked >= 1
        live = {id(sh.partition.columns) for sh in w_port.shards}
        assert {id(c) for c in plane_port._cols} == live
        assert len(plane_port._cols) == BASE["n_shards"]


def test_plane_after_failover_keeps_live_partitions_at_their_size():
    """Regression: a kill and its promotion, then a second kill by WAL
    replay.  The plane ends with one block per live partition, and B
    stays what the live tables need while no table grows: the dead
    shards' blocks were dropped at the next rebuild, and no fresh
    registration doubles B."""
    def drive(**kw):
        w = port_core.Weaver(port_core.WeaverConfig(
            n_gatekeepers=2, n_shards=3, seed=3, device="cpu",
            device_shard_columns=True, heartbeat_period=2e-3, **kw))
        tx = w.begin_tx()
        for i in range(200):
            tx.create_vertex(f"v{i}")
        for i in range(600):
            tx.create_edge(f"v{i % 200}", f"v{(7 * i + 1) % 200}")
        assert w.run_tx(tx).ok
        w.settle(20e-3)
        return w

    def snap(w):
        _, stamp, _ = w.run_program("count_edges", [("v0", None)])
        port_analytics.snapshot_arrays(w, stamp)
        return w.device_plane

    for kw in ({}, {"n_replicas": 2, "read_group_commit": 1e-3}):
        w = drive(**kw)
        plane = snap(w)
        cap0 = plane._cap
        rows0 = max(max(sh.partition.columns.n_v, sh.partition.columns.n_e)
                    for sh in w.shards)
        assert len(plane._cols) == 3
        assert cap0 == chip_smoke.live_cap(rows0, plane.min_block) > 64
        dead = []
        for name in ("shard1", "shard2"):
            dead.append(w.shards[int(name[-1])].partition.columns)
            w.kill(name)
            w.settle(0.1)
            plane = snap(w)
            rows = max(max(sh.partition.columns.n_v, sh.partition.columns.n_e)
                       for sh in w.shards)
            assert rows <= rows0                 # no table grew
            assert len(plane._cols) == 3         # one block per live shard
            assert {id(c) for c in plane._cols} == {
                id(sh.partition.columns) for sh in w.shards}
            assert not any(c is d for c in plane._cols for d in dead)
            assert plane._cap == cap0            # B did not grow
            assert plane._spd == 3
        c = w.sim.counters
        assert w.manager.epoch == 2
        assert (c.replica_promotions == 2) == bool(kw)


def test_replica_promotion_after_gc_pruned_its_applied_map_fails_alike():
    """Reference behaviour the port copies (ROADMAP §3): once GC has
    pruned a replica's applied-op map (entries older than the store's
    RESULT_RETENTION, 2 s), promoting that replica re-applies the WAL
    ops it already holds, and the first re-created vertex raises
    ``KeyError`` out of the heartbeat check, in both packages alike."""
    steps = chip_smoke.make_stream(5, 60, avg_degree=4, n_tx=10, n_prog=1,
                                   chunk=64)
    steps = steps[:8] + [("settle", 3.5), ("kill", "shard1")]
    errors = []
    for core, analytics, dev in ((ref_core, ref_analytics, None),
                                 (port_core, port_analytics, "cpu")):
        kw = dict(BASE, **REPLICAS, gc_period=1.0)
        if dev:
            kw["device"] = dev
        with pytest.raises(KeyError) as err:
            chip_smoke.run_stream(core, analytics, core.WeaverConfig(**kw),
                                  steps, device=dev)
        errors.append(err.value.args)
    assert errors[0] == errors[1]
    assert "already exists" in errors[0][0]


def test_replica_served_clustering_mismatch_is_the_reference_s():
    """Reference behaviour the port copies (ROADMAP §3): phase 3e's run A
    stream at 500 users has a clustering program answered by a replica
    under aliased read windows whose result differs from ``run_local`` at
    its stamp.  Both packages find the same mismatches, each marked
    replica-served by the read checker, so none is unexplained."""
    steps = chip_smoke.failover_stream("A", 0, 500, 2, 20, 60)
    found = []
    for core, analytics, dev in ((ref_core, ref_analytics, None),
                                 (port_core, port_analytics, "cpu")):
        cfg = chip_smoke.failover_config(core, "A", 0, (4, 8), dev, False)
        reads = chip_smoke.ReadChecker()
        chip_smoke.run_stream(core, analytics, cfg, steps, device=dev,
                              on_weaver=reads.attach)
        assert reads.unexplained(cfg) == []
        found.append(reads.mismatches)
    assert found[0] == found[1]
    assert [(m[0], m[3]) for m in found[0]] == [("clustering", True)]


def test_chip_smoke_failover_phase_rehearses_on_cpu():
    """chip_smoke's phase 3e end to end at a small size with the plane on
    one CPU entry: runs A (replicas, two promotions) and B (recovery
    under a torn tail, a gatekeeper and two shard crashes) against their
    plane-off twins in worker processes."""
    r = chip_smoke.phase_failover(0, 400, 2, 20, 60, device="cpu")
    assert r["A"]["counters"]["replica_promotions"] == 2
    assert r["B"]["counters"]["wal_replay_ops"] > 0
    for lb in ("A", "B"):
        p = r[lb]["plane"]
        assert p["blocks"] == p["live"] == 8
        assert all(b == chip_smoke.live_cap(rows, 64)
                   for _, b, rows in r[lb]["rebuilds"])
