"""BFS at a refinable timestamp over a table of edge versions
(``core.analytics.bfs_levels_at`` over ``core.edgeversions``), against
the benchmark's plain reference (``weaverbench/reference/bfs_at.py``).

On the CPU: seeded deployments of about 2**10 vertices whose versions
are written by transactions through four gatekeepers (C = 5) that
announce their clocks at random, so that each query finds a tail of
writes concurrent with its stamp; the levels and the visibility bits
equal the reference's, one oracle request a query carries exactly the
unique concurrent Stamps (none where nothing is concurrent), purge and
compaction leave the answers as they were, and the residue mode's plain
version equals ``clock.visibility_mask_np`` and
``clock.concurrent_mask_np``.  On a card (skipped here with the reason):
the residue mode bit for bit against its plain version, the masked round
against the unmasked one over the visible rows alone, and the whole
query against its CPU run."""

import numpy as np
import pytest
import torch

from repro_torch.core import analytics, clock, obs
from repro_torch.core.clock import Order, Stamp, compare
from repro_torch.core.edgeversions import EdgeVersionTable
from repro_torch.core.oracle import TimelineOracle
from repro_torch.kernels.bfs_round import kernel as bfs_kernel
from repro_torch.kernels.bfs_round import ops as bfs_ops
from repro_torch.kernels.mv_visibility import kernel as mv_kernel
from repro_torch.kernels.mv_visibility import ops as mv_ops
from repro_torch.kernels.mv_visibility import ref as mv_ref

from weaverbench.reference import bfs as ref_bfs
from weaverbench.reference import bfs_at as ref_bfs_at

G = 4                   # gatekeepers: stamp rows of C = 5


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the residue mode and the masked "
                    "round run only on the card")
    return torch.device("cuda")


class SpyOracle(TimelineOracle):
    """A timeline oracle that records every request's stamps."""

    def __init__(self):
        super().__init__()
        self.requests = []

    def order_events(self, stamps, kinds=None):
        self.requests.append(list(stamps))
        return super().order_events(stamps, kinds)


class Deployment:
    """A seeded multi-version graph: ``e`` base edges over ``n`` vertices
    loaded at the zero stamp, then ``txs`` transactions through ``G``
    gatekeepers, each deleting 1-5 live versions and appending as many
    new ones; after each, with probability ``announce``, one gatekeeper's
    clock reaches the others.  ``stamps`` holds every transaction's
    Stamp."""

    def __init__(self, seed, n=1024, e=8192, txs=60, announce=0.3,
                 device="cpu"):
        rng = self.rng = np.random.default_rng(seed)
        self.n = n
        src = rng.integers(0, n, e).astype(np.int32)
        dst = rng.integers(0, n, e).astype(np.int32)
        order = np.argsort(dst, kind="stable")
        self.table = EdgeVersionTable(G, n, torch.from_numpy(src[order]).to(
            device), torch.from_numpy(dst[order]).to(device))
        self.live = list(range(e))
        self.clocks = [[0] * G for _ in range(G)]
        self.stamps = []
        for _ in range(txs):
            self.transaction(int(rng.integers(G)))
            if rng.random() < announce:
                self.announce(int(rng.integers(G)))

    def transaction(self, g):
        rng, t = self.rng, self.table
        self.clocks[g][g] += 1
        s = Stamp(0, tuple(self.clocks[g]), g, self.clocks[g][g])
        self.stamps.append(s)
        k = int(rng.integers(1, 6))
        pick = sorted(rng.choice(len(self.live), k, replace=False),
                      reverse=True)
        gone = [self.live.pop(i) for i in pick]
        dev = t.device
        rows = torch.from_numpy(np.tile(clock.pack(s, G), (k, 1))).to(dev)
        t.delete(torch.tensor(gone, dtype=torch.int64, device=dev), rows)
        first = t.append(
            torch.from_numpy(rng.integers(0, self.n, k).astype(np.int32)).to(
                dev),
            torch.from_numpy(rng.integers(0, self.n, k).astype(np.int32)).to(
                dev), rows)
        t.remember(gone, [s] * k, 1)
        t.remember(range(first, first + k), [s] * k, 0)
        self.live.extend(range(first, first + k))

    def announce(self, a):
        for g in range(G):
            self.clocks[g] = list(clock.merge(self.clocks[g],
                                              self.clocks[a]))

    def query_stamp(self, h):
        """A node program's stamp at gatekeeper ``h``."""
        self.clocks[h][h] += 1
        return Stamp(0, tuple(self.clocks[h]), h, self.clocks[h][h])


def reference(table, at, root):
    q = torch.from_numpy(clock.pack(at, G)).to(table.device)
    vis = ref_bfs_at.visible(table.create_rows, table.delete_rows, q)
    return ref_bfs.levels(table.src[vis], table.dst[vis], table.n_nodes,
                          root), vis


def check_query(table, at, root, oracle=None):
    """The port's answer equals the reference's; returns the levels, the
    unpacked bits and the oracle."""
    oracle = oracle if oracle is not None else SpyOracle()
    levels, bits = analytics.bfs_levels_at(table, at, [root], oracle)
    want_levels, want_vis = reference(table, at, root)
    vis = mv_ref.unpack_bits(bits, table.n)
    assert torch.equal(vis.cpu(), want_vis.cpu())
    assert torch.equal(levels.cpu(), want_levels.cpu())
    return levels, vis, oracle


def concurrent_stamps(d, at):
    return {s.key() for s in d.stamps if compare(s, at) is Order.CONCURRENT}


# ---------------------------------------------------------------- the CPU


@pytest.mark.parametrize("seed", range(6))
def test_bfs_levels_at_matches_reference(seed):
    d = Deployment(seed)
    at = d.query_stamp(seed % G)
    conc = concurrent_stamps(d, at)
    assert conc, "the seed leaves nothing concurrent with the query"
    before = dict(obs.DATA_PLANE.counters)
    _, vis, oracle = check_query(d.table, at, int(d.rng.integers(d.n)))
    # one request: the unique concurrent Stamps, then the query's own
    assert len(oracle.requests) == 1
    sent = oracle.requests[0]
    assert sent[-1] == at
    assert len({s.key() for s in sent[:-1]}) == len(sent) - 1
    assert {s.key() for s in sent[:-1]} == conc
    got = {k: obs.DATA_PLANE.counters[k] - before.get(k, 0)
           for k in obs.DATA_PLANE.counters
           if k.startswith("analytics.bfs_levels_at.")}
    pre = "analytics.bfs_levels_at."
    assert got[pre + "rows"] == d.table.n
    assert got[pre + "oracle_stamps"] == len(conc)
    assert got[pre + "oracle_requests"] == 1
    assert got[pre + "concurrent_rows"] > 0
    # the refinement matters: without it the bits differ
    q = torch.from_numpy(clock.pack(at, G))
    plain = ref_bfs_at.visible(d.table.create_rows, d.table.delete_rows, q,
                               refine=False)
    assert not torch.equal(plain, vis)


def test_no_request_when_nothing_is_concurrent():
    d = Deployment(11)
    for a in range(G):
        d.announce(a)
    at = d.query_stamp(2)
    assert not concurrent_stamps(d, at)
    before = obs.DATA_PLANE.counters.get(
        "analytics.bfs_levels_at.oracle_requests", 0)
    _, _, oracle = check_query(d.table, at, 5)
    assert oracle.requests == []
    assert obs.DATA_PLANE.counters[
        "analytics.bfs_levels_at.oracle_requests"] == before


def test_missing_stamp_of_a_concurrent_row_raises():
    d = Deployment(3)
    at = d.query_stamp(1)
    d.table.recent.clear()
    with pytest.raises(RuntimeError, match="keeps no Stamp"):
        analytics.bfs_levels_at(d.table, at, [0], TimelineOracle())


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_purge_and_compaction_leave_the_answers(seed):
    """GC at a stamp that every gatekeeper has passed, then compaction:
    the rows move, the answers at a later stamp do not."""
    d = Deployment(seed, txs=80)
    for a in range(G):
        d.announce(a)
    horizon = d.query_stamp(0)
    for g in (1, 2, 3, 0, 2):
        d.transaction(g)
    at = d.query_stamp(3)
    root = int(d.rng.integers(d.n))
    levels, vis, _ = check_query(d.table, at, root)
    edges = lambda t, v: sorted(zip(t.src[v].tolist(), t.dst[v].tolist()))
    want = edges(d.table, vis)
    purged = d.table.purge_deleted_before(horizon)
    assert purged > 0 and d.table.dead == purged
    assert d.table.maybe_compact(dead_frac=1.0) is None
    levels2, vis2, _ = check_query(d.table, at, root)
    assert torch.equal(levels2, levels) and edges(d.table, vis2) == want
    n_before = d.table.n
    moved = d.table.compact()
    assert d.table.n == n_before - purged and d.table.dead == 0
    assert int((moved >= 0).sum()) == d.table.n
    key = d.table.dst.long() << 32 | d.table.src.long()
    assert bool((key[1:] >= key[:-1]).all())          # destination order
    levels3, vis3, _ = check_query(d.table, at, root)
    assert torch.equal(levels3, levels) and edges(d.table, vis3) == want


def test_settle_drops_the_covered_stamps():
    d = Deployment(5, txs=30)
    floor = Stamp(0, tuple(min(c[j] for c in d.clocks) for j in range(G)),
                  -1, 0)
    d.table.settle(floor)
    for row, kept in d.table.recent.items():
        assert any(s is not None and not all(
            a <= b for a, b in zip(s.clock, floor.clock)) for s in kept)
    for a in range(G):
        d.announce(a)
    d.table.settle(Stamp(0, tuple(d.clocks[0]), -1, 0))
    assert d.table.recent == {}


@pytest.mark.parametrize("n", [0, 1, 31, 33, 1000])
@pytest.mark.parametrize("seed", [0, 1])
def test_residue_plain_matches_clock_forms(n, seed):
    rng = np.random.default_rng(100 * n + seed)
    q = rng.integers(0, 4, G + 1).astype(np.int32)
    q[0] = 2

    def rows():
        r = rng.integers(0, 4, (n, G + 1)).astype(np.int32)
        r[:, 0] = q[0] + rng.integers(-1, 2, n)
        r[rng.random(n) < 0.2, 1:] = q[1:]           # equal vectors
        r[rng.random(n) < 0.2] = clock.NO_STAMP
        return r

    create, delete = rows(), rows()
    bits, res = mv_ops.visibility_residue(torch.from_numpy(create),
                                          torch.from_numpy(delete),
                                          torch.from_numpy(q))
    np.testing.assert_array_equal(
        mv_ref.unpack_bits(bits, n).numpy(),
        clock.visibility_mask_np(create, delete, q))
    entries = mv_ops.read_residue(res)
    cc = clock.concurrent_mask_np(create, q)
    dc = clock.concurrent_mask_np(delete, q)
    rows_ = entries >> mv_kernel.FLAG_BITS
    np.testing.assert_array_equal(rows_, np.nonzero(cc | dc)[0])
    f = entries & 15
    np.testing.assert_array_equal(f & mv_kernel.CREATE_CONC > 0, cc[rows_])
    np.testing.assert_array_equal(f & mv_kernel.DELETE_CONC > 0, dc[rows_])
    np.testing.assert_array_equal(
        f & mv_kernel.CREATE_BEFORE > 0,
        clock._np_before(create, q)[rows_])
    np.testing.assert_array_equal(
        f & mv_kernel.DELETE_BEFORE > 0,
        clock._np_before(delete, q)[rows_])


def test_read_residue_reads_past_its_prefix_and_reports_overflow():
    entries = torch.arange(10, dtype=torch.int64) * 16 + 1
    res = torch.cat([torch.tensor([10]), entries.flip(0)])
    np.testing.assert_array_equal(mv_ops.read_residue(res, prefix=3),
                                  entries.numpy())
    full = torch.cat([torch.tensor([11]), entries])
    with pytest.raises(mv_ops.ResidueOverflow) as err:
        mv_ops.read_residue(full)
    assert err.value.count == 11


def test_plain_masked_round_is_the_round_over_visible_rows():
    rng = np.random.default_rng(4)
    n, e = 300, 5000
    src = torch.from_numpy(rng.integers(0, n, e).astype(np.int32))
    dst = torch.from_numpy(rng.integers(0, n, e).astype(np.int32))
    vis = torch.from_numpy(rng.random(e) < 0.6)
    bits = mv_ref.pack_bits(vis)
    a = bfs_ops.Rounds(n, torch.tensor([0, 7]))
    b = bfs_ops.Rounds(n, torch.tensor([0, 7]))
    for r in range(8):
        assert torch.equal(a.relax(src, dst, r, bits),
                           b.relax(src[vis], dst[vis], r))
        assert torch.equal(a.flags, b.flags)


# ---------------------------------------------------------------- the card


@pytest.mark.parametrize("n", [1, 1023, 1025, 100_003])
@pytest.mark.parametrize("c", [3, 5, 9, 17])
def test_card_residue_mode_matches_plain(n, c):
    """Card only: the residue mode's bits and list == ref.py's, bit for
    bit, on aligned rows and on views one row in (the staged path), and
    its bits == the visibility mode's bit form."""
    dev = card()
    rng = np.random.default_rng(n + c)
    q = rng.integers(0, 4, c).astype(np.int32)
    q[0] = 2

    def rows():
        r = rng.integers(0, 4, (n + 1, c)).astype(np.int32)
        r[:, 0] = q[0] + rng.integers(-1, 2, n + 1)
        r[rng.random(n + 1) < 0.2, 1:] = q[1:]
        r[rng.random(n + 1) < 0.2] = clock.NO_STAMP
        return torch.from_numpy(r)

    qt = torch.from_numpy(q)
    create, delete = rows(), rows()
    mv_kernel.reset_launches()
    for lo in (0, 1):
        cr, de = create[lo:lo + n], delete[lo:lo + n]
        cd, dd = cr.to(dev), de.to(dev)
        if lo:                          # unaligned views of one buffer
            cd = create.to(dev)[lo:lo + n]
            dd = delete.to(dev)[lo:lo + n]
        want_bits, want_entries = mv_ref.visibility_residue(
            cr.contiguous(), de.contiguous(), qt)
        res = torch.full((1 + n,), -5, dtype=torch.int64, device=dev)
        bits = mv_kernel.visibility_residue(cd, dd, qt.to(dev), res)
        assert torch.equal(bits.cpu(), want_bits)
        assert torch.equal(bits, mv_kernel.visibility(cd, dd, qt.to(dev),
                                                      bits=True))
        np.testing.assert_array_equal(mv_ops.read_residue(res),
                                      want_entries.numpy())
        small = torch.empty(1 + 2, dtype=torch.int64, device=dev)
        mv_kernel.visibility_residue(cd, dd, qt.to(dev), small)
        assert int(small[0]) == want_entries.numel()      # counts past cap
    torch.cuda.synchronize()
    assert mv_kernel.launches["visibility_residue"] == 4


@pytest.mark.parametrize("e", [1, 7, 2048, 2049, 100_003])
@pytest.mark.parametrize("share", [0.0, 0.5, 1.0])
def test_card_masked_round_matches_unmasked_over_visible_rows(e, share):
    """Card only: a masked round == the unmasked kernel's round over the
    visible rows alone (levels, mirrors, flags), on aligned arrays and
    on views one element in."""
    dev = card()
    rng = np.random.default_rng(e)
    n = 5_003
    src = torch.from_numpy(rng.integers(0, n, e + 1).astype(np.int32))
    dst = torch.from_numpy(np.sort(rng.integers(0, n, e + 1)).astype(
        np.int32))
    seen = torch.from_numpy(rng.random(e + 1) < share)
    cur = torch.from_numpy(rng.integers(0, 400, n).astype(np.int32))
    cur[torch.from_numpy(rng.random(n) < 0.4)] = bfs_kernel.INF
    sd, dd = src.to(dev), dst.to(dev)
    for lo in (0, 1):
        s, d, v = sd[lo:lo + e], dd[lo:lo + e], seen[lo:lo + e]
        bits = mv_ref.pack_bits(v).to(dev)
        out = []
        for masked in (True, False):
            c = cur.to(dev)
            m = torch.zeros(bfs_kernel.mirror_bytes(n), dtype=torch.uint8)
            m[:n] = bfs_kernel.code(cur)
            c8, n8 = m.to(dev), m.to(dev)
            nxt = c.clone()
            flags = torch.zeros(2, dtype=torch.int32, device=dev)
            if masked:
                bfs_kernel.relax_masked(s, d, bits, c, nxt, c8, n8, flags, 0)
            else:
                vd = v.to(dev)
                bfs_kernel.relax(s[vd].contiguous(), d[vd].contiguous(), c,
                                 nxt, c8, n8, flags, 0)
            out.append((nxt.cpu(), n8.cpu(), flags.cpu()))
        for a, b in zip(*out):
            assert torch.equal(a, b)


@pytest.mark.parametrize("seed", [31, 32])
def test_card_bfs_levels_at_matches_its_cpu_run(seed):
    """Card only: the whole query on the card == on the CPU (levels and
    bits), with one residue launch, one masked launch a round, no
    unmasked round and one oracle request."""
    dev = card()
    d_cpu, d_card = Deployment(seed), Deployment(seed, device=dev)
    at = d_cpu.query_stamp(1)
    assert at == d_card.query_stamp(1)
    root = 17
    lv_cpu, bits_cpu = analytics.bfs_levels_at(d_cpu.table, at, [root],
                                               TimelineOracle())
    mv_kernel.reset_launches()
    bfs_kernel.reset_launches()
    oracle = SpyOracle()
    rounds0 = obs.DATA_PLANE.counters.get("analytics.bfs_levels_at.rounds",
                                          0)
    lv, bits = analytics.bfs_levels_at(d_card.table, at, [root], oracle)
    rounds = obs.DATA_PLANE.counters["analytics.bfs_levels_at.rounds"] \
        - rounds0
    assert torch.equal(lv.cpu(), lv_cpu) and torch.equal(bits.cpu(),
                                                         bits_cpu)
    assert mv_kernel.launches["visibility_residue"] == 1
    assert sum(mv_kernel.launches.values()) == 1
    assert bfs_kernel.launches["bfs_round_masked"] == rounds
    assert bfs_kernel.launches["bfs_round"] == 0
    assert len(oracle.requests) == 1
    check_query(d_card.table, at, root)
    # a residue longer than the list: a second launch into a grown one
    mv_ops._residue[d_card.table.device] = torch.empty(
        1 + 4, dtype=torch.int64, device=dev)
    mv_kernel.reset_launches()
    lv2, bits2 = analytics.bfs_levels_at(d_card.table, at, [root],
                                         TimelineOracle())
    assert torch.equal(lv2, lv) and torch.equal(bits2, bits)
    assert mv_kernel.launches["visibility_residue"] == 2
    assert mv_ops.residue_buffer(d_card.table.device).numel() > 5


def test_chip_smoke_phase_rehearses_on_the_cpu():
    """``chip_smoke.py``'s phase 3f at 2**10 vertices on the CPU: the
    query, its residue and refined bits and its levels equal their plain
    versions (the launch counts and timings are the card's alone)."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    out = chip_smoke.phase_bfs_at(5, 2, scale=10, txs=16 * 40, device="cpu")
    assert out["visibility_residue"]["launches"] == 1
    assert out["bfs_round_masked"]["launches"] >= 2
    assert all(v["ms"] is None for v in out.values())
