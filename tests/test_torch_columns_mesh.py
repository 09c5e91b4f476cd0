"""The port's column plane over several devices (``repro_torch.dist.columns``
with ``launch.mesh.make_columns_mesh``), run on the CPU with N entries of
the CPU device, held against the reference's plane over N forced host
devices (``XLA_FLAGS=--xla_force_host_platform_device_count=N``, in a
subprocess, as ``tests/test_device_shard.py`` runs it): under
``CHURN_SRC``'s stream the snapshots stay bit-equal to the host-global
path, the plane's stats equal the reference's, and ``spd``, ``B`` and
where each block lives equal the reference's."""

import functools
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from test_device_shard import CHURN_SRC

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

# CHURN_SRC, returning the sharded Weaver's plane beside its stats
CHURN_PLANE_SRC = CHURN_SRC.replace(
    "    return stats\n", "    return stats, w_dev.device_plane\n")
assert CHURN_PLANE_SRC.count("w_dev.device_plane\n") == 1

# One walk over a plane of 2-gatekeeper partitions, shared by the two
# packages (``repro.core`` is rewritten for the port): 3 shards, then
# rows past the capacity, then 2 more shards than n_dev * spd holds,
# which forces a rebuild with a new spd.  Every step checks each
# partition's masks against the host compare and records spd, B, the
# stats and where each block's rows were found.
LAYOUT_SRC = '''
def layout_walk(make_plane, to_np):
    import numpy as np
    from repro.core.clock import NO_STAMP, Stamp, _np_before, pack
    from repro.core.mvgraph import MVGraphPartition

    plane = make_plane(2)
    parts = []
    clk = [0, 0]

    def nxt(g):
        clk[g] += 1
        return Stamp(0, tuple(clk), g, clk[g])

    def grow(k, nv):
        for _ in range(k):
            p = MVGraphPartition(2)
            pi = len(parts)
            parts.append(p)
            for i in range(nv):
                p.create_vertex(f"p{pi}v{i}", nxt(i % 2))
            for i in range(2 * nv):
                p.create_edge(f"p{pi}v{i % nv}", f"p{pi}v{(3 * i) % nv}",
                              nxt(i % 2))

    def owners():
        found = []
        arrs = [to_np(a) for a in plane._dev]
        for cols in plane._cols:
            hits = []
            for d, a in enumerate(arrs):
                for j in range(a.shape[0]):
                    b = a[j]
                    if (np.array_equal(b[0, :cols.n_v], cols.v_create.view())
                            and np.array_equal(b[2, :cols.n_e],
                                               cols.e_create.view())
                            and (b[:, max(cols.n_v, cols.n_e):] ==
                                 NO_STAMP).all()):
                        hits.append([d, j])
            found.append(hits)
        return found

    out = []

    def step():
        cols = [p.columns for p in parts]
        q = pack(Stamp(0, tuple(c - 3 for c in clk), 0, 0), 2)
        plane.sync(cols)
        plane.before_all(q)
        for c in cols:
            for m, tbl in zip(plane.masks_for(c),
                              (c.v_create, c.v_delete, c.e_create,
                               c.e_delete)):
                assert np.array_equal(m, _np_before(tbl.view(), q))
        out.append({"spd": plane._spd, "cap": plane._cap,
                    "rows": max(max(c.n_v, c.n_e) for c in cols),
                    "n_blocks": [int(to_np(a).shape[0]) for a in plane._dev],
                    "stats": dict(plane.stats), "owners": owners()})

    grow(3, 12)
    step()
    for i in range(0, 12, 5):                   # in-place patches
        parts[1].delete_vertex(f"p1v{i}", nxt(1))
    step()
    for i in range(12, 80):                     # past the capacity
        parts[0].create_vertex(f"p0v{i}", nxt(i % 2))
    step()
    grow(2, 7)                                  # 5 shards > n_dev * spd
    step()
    return out
'''
PORT_LAYOUT_SRC = LAYOUT_SRC.replace("from repro.core", "from repro_torch.core")
assert "from repro.core" not in PORT_LAYOUT_SRC


def _exec(src: str, name: str, **env):
    ns = dict(env)
    exec(src, ns)
    return ns[name]


PORT_CHURN = {n: _exec(CHURN_PLANE_SRC.replace(
    "from repro.core", "from repro_torch.core").replace(
    "device_shard_columns=flag))",
    "device_shard_columns=flag, device=DEVICES))"),
    "churn_equivalence", DEVICES=["cpu"] * n) for n in (2, 4)}
PORT_LAYOUT = _exec(PORT_LAYOUT_SRC, "layout_walk")

REF_BODY = '''
import json
import numpy as np
from repro.launch.mesh import make_columns_mesh


def ref_layout(plane):
    # every per-device array lies on the mesh device of its position
    for d, arr in enumerate(plane._dev):
        assert list(arr.devices()) == [plane._devices[d]]
    return {"spd": plane._spd, "cap": plane._cap, "n_dev": plane.n_dev}


out = {"mesh": int(make_columns_mesh().devices.size), "churn": {}}
for seed in (0, 1):
    stats, plane = churn_equivalence(seed, rounds=6)
    out["churn"][seed] = {"stats": stats, **ref_layout(plane)}
from repro.dist.columns import DeviceColumnPlane
out["layout"] = layout_walk(lambda n_gk: DeviceColumnPlane(n_gk), np.asarray)
print("REF_JSON " + json.dumps(out))
'''


@functools.lru_cache(maxsize=None)
def reference(devices: int) -> dict:
    """The reference plane's figures over ``devices`` forced host devices,
    from a subprocess (jax fixes its device count at first use)."""
    code = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = \\
            "--xla_force_host_platform_device_count={devices}"
        import sys
        sys.path.insert(0, {os.path.join(REPO, 'src')!r})
        import jax
        assert len(jax.devices()) == {devices}
    """) + CHURN_PLANE_SRC + LAYOUT_SRC + REF_BODY
    proc = subprocess.run([sys.executable, "-c", code],
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, f"STDOUT:\n{proc.stdout}\n" \
                                 f"STDERR:\n{proc.stderr[-3000:]}"
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("REF_JSON ")]
    assert len(line) == 1, proc.stdout
    out = json.loads(line[0][len("REF_JSON "):])
    assert out["mesh"] == devices
    return out


@pytest.mark.parametrize("devices", [2, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_forced_multi_device_churn(devices, seed):
    """The port's plane over ``devices`` CPU entries under CHURN_SRC's
    stream: cold and delta snapshots bit-equal to the host-global path
    (asserted inside the stream), stats, spd and B equal to the
    reference plane's over as many forced host devices."""
    stats, plane = PORT_CHURN[devices](seed, rounds=6)
    assert plane.n_dev == devices and plane.devices == [
        torch.device("cpu")] * devices
    ref = reference(devices)["churn"][str(seed)]
    assert stats == ref["stats"]
    assert (plane._spd, plane._cap, plane.n_dev) == (
        ref["spd"], ref["cap"], ref["n_dev"])
    assert plane._spd == -(-3 // devices)           # 3 shards
    assert [(b.device, tuple(b.shape)) for b in plane._dev] == [
        (d, (plane._spd, 4, plane._cap, plane.c)) for d in plane.devices]


@pytest.mark.parametrize("devices", [2, 4])
def test_layout_walk_matches_reference(devices):
    """Patches, a capacity overflow and a shard count that outgrows
    n_dev * spd (a rebuild with a new spd): every step's masks equal the
    host compare, and spd, each device's block count, the stats and
    where every block's rows lie equal the reference's.  B equals the
    reference's until the two new shards arrive; there the reference
    starts its size at the old B and doubles it, the port sizes B from
    the largest live table (``dist/columns.py``'s live-size rule)."""
    from repro_torch.dist.columns import DeviceColumnPlane
    got = PORT_LAYOUT(
        lambda n_gk: DeviceColumnPlane(n_gk, devices=["cpu"] * devices),
        lambda t: t.numpy())
    want = reference(devices)["layout"]
    assert got[:3] == want[:3]
    assert [{k: v for k, v in s.items() if k != "cap"} for s in got] == [
        {k: v for k, v in s.items() if k != "cap"} for s in want]
    assert [s["cap"] for s in got] == [chip_smoke.live_cap(s["rows"], 64)
                                       for s in got]
    assert want[3]["cap"] == 2 * got[3]["cap"]
    spds = [s["spd"] for s in got]
    assert spds[0] == -(-3 // devices) and spds[-1] == -(-5 // devices)
    assert [s["stats"]["rebuilds"] for s in got] == [1, 1, 2, 3]
    for s in got:                       # each block found exactly once
        assert all(len(h) == 1 for h in s["owners"])
        assert [h[0] for h in s["owners"]] == [
            [bi // s["spd"], bi % s["spd"]] for bi in range(len(s["owners"]))]


def test_retire_keeps_the_other_blocks_bits_until_the_next_rebuild():
    """A retired partition's block stays in the layout until the next
    rebuild: another shard's sync at a repeated query neither rebuilds
    nor launches (as the reference, which never retires, does not), and
    the other blocks' masks stay the host compare's.  The new partition
    that takes its place rebuilds, with one block per live partition."""
    from repro_torch.core.clock import Stamp, _np_before, pack
    from repro_torch.core.mvgraph import MVGraphPartition
    from repro_torch.dist.columns import DeviceColumnPlane

    clk = [0, 0]

    def part(pi, nv):
        p = MVGraphPartition(2)
        for i in range(nv):
            clk[i % 2] += 1
            p.create_vertex(f"p{pi}v{i}", Stamp(0, tuple(clk), i % 2,
                                                clk[i % 2]))
        return p.columns

    cols = [part(pi, 10 + 5 * pi) for pi in range(3)]
    plane = DeviceColumnPlane(2, devices=["cpu"] * 2)
    q = pack(Stamp(0, tuple(c - 2 for c in clk), 0, 0), 2)
    plane.sync(cols)
    plane.before_all(q)
    stats = dict(plane.stats)
    plane.retire(cols[1])
    plane.sync([cols[0]])
    plane.before_all(q)
    assert plane.stats == stats                 # no rebuild, no launch
    assert [c for _, c, _ in plane.live_blocks()] == [cols[0], cols[2]]
    assert not plane.has(cols[1]) and plane.has(cols[2])
    for c in (cols[0], cols[2]):
        for m, tbl in zip(plane.masks_for(c), (c.v_create, c.v_delete,
                                               c.e_create, c.e_delete)):
            assert np.array_equal(m, _np_before(tbl.view(), q))
    nu = part(3, 12)
    plane.sync([cols[0], nu, cols[2]])
    assert plane.stats["rebuilds"] == stats["rebuilds"] + 1
    assert plane._cols == [cols[0], cols[2], nu]
    assert plane._cap == chip_smoke.live_cap(20, 64) == 64


def test_program_path_through_sharded_plans_on_4_entries():
    """run_program (ShardPlan cold builds) through the real tx pipeline
    with the plane over 4 CPU entries == the plane off == the reference's
    answers."""
    from repro.core import Weaver as RefWeaver, WeaverConfig as RefConfig
    from repro_torch.core import Weaver, WeaverConfig

    def drive(w):
        tx = w.begin_tx()
        for i in range(14):
            tx.create_vertex(f"n{i}")
        for i in range(13):
            tx.create_edge(f"n{i}", f"n{i+1}")
        assert w.run_tx(tx).ok
        tx = w.begin_tx()
        tx.delete_vertex("n7")
        assert w.run_tx(tx).ok
        r_reach, _, _ = w.run_program(
            "reachable", [("n0", {"target": "n13"})])
        r_count, _, _ = w.run_program("count_edges", [("n3", None)])
        return r_reach, r_count

    results = {}
    for flag in (False, True):
        w = Weaver(WeaverConfig(n_gatekeepers=2, n_shards=3, seed=11,
                                device_shard_columns=flag,
                                device=["cpu"] * 4))
        assert w.device == "cpu"
        results[flag] = drive(w)
        if flag:
            assert w.device_plane.n_dev == 4
            assert w.device_plane._spd == 1
            assert w.device_plane.stats["launches"] > 0
    ref = drive(RefWeaver(RefConfig(n_gatekeepers=2, n_shards=3, seed=11,
                                    device_shard_columns=True)))
    assert results[True] == results[False] == ref


def test_bit_stream_of_three_entries_and_seven_shards():
    """spd = 3 over 3 entries for 7 shards: the entries' bit words form
    one stream over the flattened (9, 4, B) rows, equal to one compare
    over the concatenated blocks; the two padding blocks are all False
    and every shard's masks equal the host compare."""
    from repro_torch.core.clock import Stamp, _np_before, pack
    from repro_torch.core.mvgraph import MVGraphPartition
    from repro_torch.dist.columns import DeviceColumnPlane, TABLES
    from repro_torch.kernels.mv_visibility import ref as mvref

    rng = np.random.default_rng(3)
    parts = [MVGraphPartition(2) for _ in range(7)]
    clk = [0, 0]
    for i in range(200):
        g = int(rng.integers(0, 2))
        clk[g] += 1
        p = parts[int(rng.integers(0, 7))]
        vid = f"v{i}"
        p.create_vertex(vid, Stamp(0, tuple(clk), g, clk[g]))
        if i % 3:
            clk[g] += 1
            p.create_edge(vid, f"v{int(rng.integers(0, i + 1))}",
                          Stamp(0, tuple(clk), g, clk[g]))
    plane = DeviceColumnPlane(2, devices=["cpu"] * 3)
    cols = [p.columns for p in parts]
    q = pack(Stamp(0, (clk[0] - 20, clk[1] - 10), 0, 0), 2)
    plane.sync(cols)
    plane.before_all(q)
    assert plane._spd == 3 and len(plane._dev) == 3
    rows = torch.cat([b.reshape(-1, plane.c) for b in plane._dev])
    want = mvref.pack_bits(mvref.before(rows, torch.from_numpy(q)))
    assert np.array_equal(plane._bits, want.numpy().view(np.uint8))
    bits = np.unpackbits(plane._bits, bitorder="little").reshape(
        9, TABLES, plane._cap)
    assert not bits[7:].any()
    for c in cols:
        for m, tbl in zip(plane.masks_for(c), (c.v_create, c.v_delete,
                                               c.e_create, c.e_delete)):
            np.testing.assert_array_equal(m, _np_before(tbl.view(), q))


def test_before_all_issues_every_launch_and_copy_before_a_wait(monkeypatch):
    """One round over the devices: every device's launch and bit copy is
    issued before the host's first wait, and a second call at the same
    query is answered from the cached bits."""
    from repro_torch.core.clock import Stamp, pack
    from repro_torch.core.mvgraph import MVGraphPartition
    from repro_torch.dist import columns
    from repro_torch.kernels.mv_visibility import ops as mv_ops

    parts = [MVGraphPartition(2) for _ in range(5)]
    for i, p in enumerate(parts):
        p.create_vertex(f"v{i}", Stamp(0, (i + 1, 0), 0, i + 1))
    plane = columns.DeviceColumnPlane(2, devices=["cpu"] * 4)
    plane.sync([p.columns for p in parts])
    log = []
    launch, copy_back, wait = (mv_ops.before_mask, plane._copy_back,
                               plane._wait)
    monkeypatch.setattr(mv_ops, "before_mask", lambda *a, **k: (
        log.append("launch"), launch(*a, **k))[1])
    monkeypatch.setattr(plane, "_copy_back", lambda w: (
        log.append(f"copy x{len(w)}"), copy_back(w))[1])
    monkeypatch.setattr(plane, "_wait", lambda: (
        log.append("wait"), wait())[1])
    q = pack(Stamp(0, (9, 9), 0, 0), 2)
    plane.before_all(q)
    plane.before_all(q)
    assert log == ["launch"] * 4 + ["copy x4", "wait"]
    assert plane.stats["launches"] == 1


def test_make_columns_mesh_cases(monkeypatch):
    from repro_torch.launch.mesh import make_columns_mesh

    cpu = torch.device("cpu")
    assert make_columns_mesh(device="cpu") == [cpu]
    assert make_columns_mesh(3, device="cpu") == [cpu] * 3
    with pytest.raises(ValueError):
        make_columns_mesh(0, device="cpu")
    # no card here: "cuda" raises, with or without a count; no fallback
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    for n in (None, 1):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            make_columns_mesh(n)
    # two cards: every card, the first n, or one named card; more raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cards = [torch.device("cuda", i) for i in range(2)]
    assert make_columns_mesh() == cards
    assert make_columns_mesh(1) == cards[:1]
    assert make_columns_mesh(device="cuda:1") == cards[1:]
    with pytest.raises(RuntimeError, match="asks for 4 cards"):
        make_columns_mesh(4)
    with pytest.raises(RuntimeError):
        make_columns_mesh(device="cuda:2")


def test_plane_and_weaver_refuse_missing_devices(monkeypatch):
    from repro_torch.core import Weaver, WeaverConfig
    from repro_torch.dist.columns import DeviceColumnPlane

    with pytest.raises(ValueError):
        DeviceColumnPlane(2, devices=[])
    with pytest.raises(ValueError, match="min_block"):
        DeviceColumnPlane(2, devices=["cpu"], min_block=4)
    with pytest.raises(ValueError):
        Weaver(WeaverConfig(device=[], device_shard_columns=True))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        DeviceColumnPlane(2, devices=["cpu", "cuda:3"])
    with pytest.raises(RuntimeError):
        DeviceColumnPlane(2)                 # every card: there is none
    with pytest.raises(RuntimeError):
        Weaver(WeaverConfig(device_shard_columns=True))
    # two cards: the third is not present (checked before any block is
    # placed); "cuda" is the current card, with its index
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    with pytest.raises(RuntimeError, match="not present"):
        DeviceColumnPlane(2, devices=["cpu", "cuda:3"])
    from repro_torch.launch.mesh import columns_devices
    assert columns_devices(["cuda", "cpu", "cuda:0"]) == [
        torch.device("cuda", 1), torch.device("cpu"), torch.device("cuda", 0)]
    with pytest.raises(ValueError):
        columns_devices(["meta"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    # a string device gives make_columns_mesh's list: one CPU entry
    w = Weaver(WeaverConfig(device="cpu", device_shard_columns=True))
    assert w.device == "cpu" and w.device_plane.devices == [
        torch.device("cpu")]


def test_chip_smoke_sharded_plane_phase_rehearses_on_cpu():
    """chip_smoke's phase 3d end to end on 1, 2 and 4 CPU entries at a
    small size: masks == the plain before cold and after appends, patches
    and a forced compaction, equal stats across the lists, and the
    paper-layout deployment with the plane over 4 entries == the plane
    off (in a worker process)."""
    r = chip_smoke.phase_sharded_plane(0, 50_000, 2, 300, 1, 10,
                                       device="cpu")
    assert sorted(r["lists"]) == ["cpu x1", "cpu x2", "cpu x4"]
    assert [r["lists"][k]["spd"] for k in ("cpu x1", "cpu x2", "cpu x4")] \
        == [8, 4, 2]
    dep = r["deployment"]
    assert dep["stats"]["launches"] > 0 and dep["entries"] == 4
