"""System gate: one seeded op stream through the reference ``Weaver`` and
the port's ``Weaver(device="cpu")`` gives identical program results,
``TxResult``s, counters, snapshot arrays and ``visible_edges_at``.

The stream and its driver are ``chip_smoke.make_stream`` /
``chip_smoke.run_stream`` — the same code that runs the port on the card
— at a small size: transactions (vertex/edge create and delete,
properties), every node program, a GC pass, async submissions, cold and
delta snapshots, the serving steps (closed and open loops of TAO
requests through each package's ``GraphQueryServer``, every request's
ok flag and latency), then a shard kill plus promotion."""

import os
import sys

import pytest

import repro.core as ref_core
from repro.core import analytics as ref_analytics
import repro_torch.core as port_core
from repro_torch.core import analytics as port_analytics

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("plane", [False, True])
@pytest.mark.parametrize("group_commit", [0.0, 1e-3])
def test_port_weaver_matches_reference(group_commit, plane):
    steps = chip_smoke.make_stream(5, 40, avg_degree=6, n_tx=30, n_prog=4,
                                   chunk=64, kill="shard1",
                                   serve_requests=120)
    kw = dict(n_gatekeepers=2, n_shards=3, seed=5,
              write_group_commit=group_commit, device_shard_columns=plane)
    want, w_ref = chip_smoke.run_stream(
        ref_core, ref_analytics, ref_core.WeaverConfig(**kw), steps)
    audit = chip_smoke.PlaneAudit()
    got, w_port = chip_smoke.run_stream(
        port_core, port_analytics,
        port_core.WeaverConfig(device="cpu", **kw), steps, device="cpu",
        on_weaver=audit.attach)
    assert chip_smoke.diff_records(want, got) == []

    counters = got[-1][1]
    progs = [r for r in got if r[0] == "prog"]
    assert counters["nodeprog_completed"] >= len(progs) > 24
    assert any(r[2] for r in progs if r[1] == "traverse")
    assert ("kill", 1) in got                      # promotion -> epoch 1
    assert counters["tx_committed"] > 30
    assert (counters["tx_batches"] > 0) == (group_commit > 0)
    snaps = [r for r in got if r[0] == "snap"]
    assert len(snaps) == 3 and snaps[-1][2].size > 0
    serve = [r for r in got if r[0] == "serve"]
    assert [r[1] for r in serve] == ["closed", "closed", "open"]
    assert [len(r[3]) for r in serve] == [120, 24, 30]
    assert all(r[2]["ok"] == r[2]["completed"] == r[2]["issued"]
               for r in serve)
    if plane:
        assert w_port.device_plane.stats["launches"] > 0
        assert (w_port.device_plane.stats
                == w_ref.device_plane.stats)
        # the kill re-registers shard1: the reference keeps the dead
        # partition's block and doubles B, the port rebuilds with the
        # live partitions only, B from their largest table
        assert audit.bad == [] and audit.masks_checked >= 1
        blocks, cap, rows = audit.rebuilds[-1]
        assert blocks == len(w_port.device_plane._cols) == 3
        assert cap == w_port.device_plane._cap == chip_smoke.live_cap(
            rows, w_port.device_plane.min_block)
        assert len(w_ref.device_plane._cols) == 4
        assert w_ref.device_plane._cap > cap
