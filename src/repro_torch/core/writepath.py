"""Group-commit write engine (paper §4.1/§4.4 commit protocol, batched).

This module is to the write side what :mod:`repro_torch.core.frontier` is to
the read side: PRs 1–3 columnarized snapshots, node programs and plan
maintenance, but transactions still flowed one at a time — one
gatekeeper ``_serve`` round per tx, one per-vertex ``last_update_of``
dict probe per write-set entry, one store round trip per tx and one
shard queue item per (tx, shard).  Write-optimized transactional graph
stores (LiveGraph's purely-sequential write path, GTX's delta-chain
group writes) batch exactly these four stages; this module provides the
data structures and vectorized kernels, and
:meth:`repro_torch.core.gatekeeper.Gatekeeper._at_store_batch` drives them.

Group-commit contract
---------------------
* **Admission** — transactions arriving at one gatekeeper within a
  configurable window (``WeaverConfig.write_group_commit`` seconds,
  capped at ``write_group_max`` transactions) are stamped in ONE
  ``_serve`` round.  Every transaction still receives its own fresh
  ``_tick()`` stamp, so per-tx ``(gk, ctr)`` identity — and therefore
  multi-version visibility — is exactly the per-tx path's.
* **Commit point / durability** — the batch commits at the backing
  store in ONE round trip (:meth:`repro_torch.core.store.BackingStore.
  apply_batch`): one group WAL record is the batch's single durability
  point, and each client reply is sent only after it (§4.4 part 2
  unchanged: the store is the commit point).
* **Intra-batch ordering** — a batch is applied in stamp order, which
  for one gatekeeper is admission order (the vector clock's own counter
  is monotone).  Same-vertex writers inside a batch therefore serialize
  by stamp with no validation traffic — the earlier stamp is strictly
  vector-before the later one — while independent writers commit
  together.  Logical errors (create of an existing vertex, …) abort
  only their own transaction; the rest of the batch commits.
* **Validation** — ``T_upd ≺ T_tx`` runs against
  :class:`LastUpdateTable`, a packed ``(N, G+1)`` int32 mirror of the
  store's per-vertex last-update stamps (same layout as
  ``PartitionColumns`` stamp matrices), with ONE vectorized compare for
  the entire batch's write-sets (the ``before_pairs`` CUDA kernel of
  ``repro_torch.kernels.mv_visibility`` on the table's device, its plain
  PyTorch version on the CPU).  Rows ordered AFTER the transaction stamp
  retry with a fresh stamp (rejoining the next window); the truly
  concurrent residue falls out to ONE batched timeline-oracle round
  trip (`refine_commit`), committing ``T_upd ≺ T_tx`` per pair exactly
  like the per-tx path and retrying the transaction on ``CycleError``.
* **Shard apply** — each destination shard receives ONE packed
  :class:`WriteBatch` queue item per window (mirroring the read side's
  packed ``Frontier``), applied into ``MVGraphPartition`` as bulk
  column appends (one patch-log extend + one stamp-matrix append per
  batch, see ``PartitionColumns.begin_batch``).  Snapshot/plan delta
  refresh sees the identical cursor contract, just with fewer, larger
  patch tails.

The per-tx path (``write_group_commit = 0``) is preserved untouched as
the oracle/fallback; ``tests/test_writepath.py`` asserts randomized
batched == per-tx equivalence.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..kernels.mv_visibility import ops as mv_ops
from .clock import NO_STAMP, Order, Stamp, compare, pack
from .mvgraph import VidIntern, _GrowRows
from .oracle import CycleError, TimelineOracle


# ---------------------------------------------------------------------------
# Redo log records (replayable WAL; see BackingStore)
# ---------------------------------------------------------------------------

@dataclass
class WalRecord:
    """One redo-log record in :attr:`repro_torch.core.store.BackingStore.wal`.

    ``kind`` is ``"tx"`` (one per-tx commit), ``"group"`` (one
    group-commit window — the window's single durability point), or
    ``"ckpt"`` (a checkpoint: the full per-shard redo stream at GC time,
    replacing all earlier records so the log stays bounded and replay
    agrees with the GC'd store).

    ``entries`` holds ``(stamp, txid, fwd)`` per committed transaction,
    where ``fwd`` is the transaction's forwarded ``(shard, op)`` list
    with each op dict carrying its commit stamp under ``"ts"`` — the
    exact redo stream a shard applies.  Only ``entries[:valid]`` are
    durable: a crash during the group append leaves a torn tail
    (``valid < len(entries)``) that replay MUST truncate."""

    kind: str
    entries: List[Tuple[Stamp, object, List[Tuple[int, dict]]]] = \
        field(default_factory=list)
    valid: int = 0
    ckpt: Optional[Dict[int, List[dict]]] = None


def wal_replay_shard(wal: Sequence[WalRecord], shard: int
                     ) -> Tuple[List[dict], int]:
    """Redo stream for one shard, up to the stable point.

    A ``ckpt`` record resets the stream (it subsumes everything before
    it); ``tx``/``group`` records contribute their durable prefix
    ``entries[:valid]`` in log order.  Returns ``(ops, torn)`` where
    ``torn`` counts the truncated torn-tail entries."""
    ops: List[dict] = []
    torn = 0
    for rec in wal:
        if rec.kind == "ckpt":
            ops = list(rec.ckpt.get(shard, ()))
            continue
        torn += len(rec.entries) - rec.valid
        for _, _, fwd in rec.entries[:rec.valid]:
            for sid, op in fwd:
                if sid == shard:
                    ops.append(op)
    return ops, torn


# ---------------------------------------------------------------------------
# Vectorized stamp-pair comparison (the batch analogue of clock.compare)
# ---------------------------------------------------------------------------

def _np_before_pairs(rows: np.ndarray, qs: np.ndarray) -> np.ndarray:
    """``rows[i] ≺ qs[i]`` elementwise over two (M, G+1) stamp matrices
    on the host.

    The pairwise form of :func:`repro_torch.core.clock._np_before` (there
    the query stamp is shared); absent rows (``NO_STAMP``) are never
    before."""
    is_no = rows[:, 0] == NO_STAMP
    lower = rows[:, 0] < qs[:, 0]
    same = rows[:, 0] == qs[:, 0]
    le = np.all(rows[:, 1:] <= qs[:, 1:], axis=1)
    eq = np.all(rows[:, 1:] == qs[:, 1:], axis=1)
    return np.where(is_no, False, lower | (same & le & ~eq))


def before_pairs(rows: np.ndarray, qs: np.ndarray,
                 device: str = "cuda") -> np.ndarray:
    """Elementwise ``rows[i] ≺ qs[i]`` as ONE ``before_pairs`` kernel
    launch on ``device`` in one host round trip (the ``mv_visibility``
    compare generalized to a per-row query stamp)."""
    return mv_ops.before_pairs_host(rows, qs, device)


# ---------------------------------------------------------------------------
# Last-update table
# ---------------------------------------------------------------------------

class LastUpdateTable:
    """Interned-vid-indexed packed last-update stamps (store-side).

    Replaces the gatekeeper commit path's per-vertex
    ``last_update_of`` dict walk: one row per vertex ever written, in
    the same ``[epoch, c_0..c_{G-1}]`` int32 layout as
    ``PartitionColumns`` stamp matrices, plus the original
    :class:`Stamp` objects for oracle refinement of truly concurrent
    rows.  :meth:`gather` materializes a batch's whole write-set as one
    (M, G+1) matrix for :func:`classify_write_sets`.

    The table mirrors ``StoredVertex.last_update`` exactly — it is
    updated at the same commit points (``BackingStore.apply`` /
    ``apply_batch``) over the same :meth:`BackingStore.write_set` vids;
    ``tests/test_writepath.py`` property-tests the equivalence.
    :meth:`collect` (driven by the store's GC hook) drops rows strictly
    before the global GC horizon — absence classifies identically, so
    the table stays bounded under churn instead of growing one row per
    vertex ever written.

    ``mutations`` is a monotone sequence number bumped at every
    :meth:`record` call: the gatekeeper's validate-at-commit loop
    snapshots it at admission-time classification and skips the second
    ``classify_write_sets`` pass at the durability instant when the
    table did not move in between (an unchanged table yields identical
    verdicts, and any already-refined residue is filtered by the
    caller's ``seen`` set).  :meth:`collect` deliberately does NOT bump
    it — GC only drops rows strictly before the global horizon, and
    absence classifies identically to the dropped row."""

    def __init__(self, intern: Optional[VidIntern] = None,
                 device: str = "cuda") -> None:
        self.intern = intern if intern is not None else VidIntern()
        self.device = device            # where classify_write_sets compares
        self.c = 0                      # row width, sized on first record
        self.rows: Optional[_GrowRows] = None
        self.stamps: List[Stamp] = []
        self.slot: Dict[int, int] = {}  # gid -> row
        self.mutations = 0              # monotone record() sequence number

    def _ensure(self, ts: Stamp) -> None:
        if self.rows is None:
            self.c = len(ts.clock) + 1
            self.rows = _GrowRows(self.c)

    def record(self, vids: Sequence[str], ts: Stamp) -> None:
        """Set the last-update stamp of every vid (post-commit)."""
        if not vids:
            return
        self.mutations += 1
        self._ensure(ts)
        row = pack(ts, len(ts.clock))
        for vid in vids:
            g = self.intern.intern(vid)
            s = self.slot.get(g)
            if s is None:
                self.slot[g] = self.rows.append(row)
                self.stamps.append(ts)
            else:
                self.rows.set(s, row)
                self.stamps[s] = ts

    def get(self, vid: str) -> Optional[Stamp]:
        g = self.intern.ids.get(vid)
        if g is None:
            return None
        s = self.slot.get(g)
        return None if s is None else self.stamps[s]

    def collect(self, horizon: Stamp) -> int:
        """GC hook: drop every row whose stamp is strictly vector-before
        the global GC horizon.  Any stamp a future transaction can carry
        dominates the horizon, so for a dropped row ``upd ≺ tx`` holds
        by transitivity — absence ("no last update") classifies as OK in
        :func:`classify_write_sets`, exactly like the kept row would.
        Bounds the table at O(recently-written vertices) instead of one
        row per vertex ever written.  Returns the dropped-row count."""
        if self.rows is None or self.rows.n == 0:
            return 0
        from .clock import _np_before
        q = pack(horizon, len(horizon.clock))
        view = self.rows.view()
        if view.shape[1] != q.size:     # different G: epoch-0 leftovers
            return 0
        drop = _np_before(view, q)
        n_drop = int(drop.sum())
        if n_drop == 0:
            return 0
        keep = np.nonzero(~drop)[0]
        gid_of_row = np.full(view.shape[0], -1, np.int64)
        for g, r in self.slot.items():
            gid_of_row[r] = g
        nu = _GrowRows(self.c)
        nu.extend(view[keep])
        keep_l = keep.tolist()
        self.stamps = [self.stamps[i] for i in keep_l]
        self.slot = {int(gid_of_row[r]): i for i, r in enumerate(keep_l)
                     if gid_of_row[r] >= 0}
        self.rows = nu
        return n_drop

    def gather(self, vids: Sequence[str]
               ) -> Tuple[np.ndarray, List[Optional[Stamp]]]:
        """(M, G+1) packed rows + Stamp objects for ``vids`` (all-
        ``NO_STAMP`` row / None for never-updated vertices)."""
        m = len(vids)
        c = self.c if self.c else 2
        out = np.full((m, c), NO_STAMP, np.int32)
        stamps: List[Optional[Stamp]] = [None] * m
        if self.rows is not None:
            view = self.rows.view()
            for i, vid in enumerate(vids):
                g = self.intern.ids.get(vid)
                s = None if g is None else self.slot.get(g)
                if s is not None:
                    out[i] = view[s]
                    stamps[i] = self.stamps[s]
        return out, stamps


#: per-tx validation verdicts
OK, RETRY = 0, 1


@dataclass
class TxVerdict:
    """Outcome of batched last-update validation for one transaction."""

    status: int                                  # OK | RETRY
    concurrent: List[Stamp] = field(default_factory=list)


def classify_write_sets(table: LastUpdateTable,
                        write_sets: Sequence[Sequence[str]],
                        stamps: Sequence[Stamp]) -> Tuple[List[TxVerdict], int]:
    """Validate an entire batch's write-sets in one vectorized pass.

    For every (tx, written vid) pair, compare the vid's last-update
    stamp against the tx stamp — the batched form of the per-tx path's
    ``compare(upd, stamp)`` dict walk:

    * ``upd ≺ tx``  (or no last update)  -> row passes;
    * ``tx ≺ upd``                       -> the tx must RETRY with a
      fresh stamp (it was stamped behind an already-executed write);
    * truly concurrent                   -> the ``upd`` stamp joins the
      tx's refinement residue, resolved by ONE batched oracle round
      trip (:func:`refine_commit`).

    Returns (per-tx verdicts, rows checked).  Intra-batch overlaps need
    no rows here: batches are applied in stamp order and one
    gatekeeper's stamps are totally ordered, so an earlier tx's write
    is strictly before a later tx's stamp by construction.
    """
    flat: List[str] = []
    tx_of: List[int] = []
    for i, ws in enumerate(write_sets):
        for vid in ws:
            flat.append(vid)
            tx_of.append(i)
    verdicts = [TxVerdict(OK) for _ in write_sets]
    if not flat:
        return verdicts, 0
    rows, row_stamps = table.gather(flat)
    # pack once per TX, gather per row (write sets share their tx stamp)
    q_tx = np.stack([pack(s, len(s.clock)) for s in stamps])
    qs = q_tx[np.asarray(tx_of)]
    if rows.shape[1] != qs.shape[1]:    # table not sized yet (all absent)
        rows = np.full(qs.shape, NO_STAMP, np.int32)
    present = rows[:, 0] != NO_STAMP
    before = before_pairs(rows, qs, table.device)   # upd ≺ tx (kernel)
    # tx ≺ upd (rare residue, np); an absent row is "no last update",
    # never after — NO_STAMP in the target position must not read as
    # "later than everything"
    after = present & _np_before_pairs(qs, rows)
    conc = present & ~before & ~after   # incl. equal vectors, other gk
    for i in np.nonzero(after)[0].tolist():
        verdicts[tx_of[i]].status = RETRY
    for i in np.nonzero(conc)[0].tolist():
        v = verdicts[tx_of[i]]
        s = row_stamps[i]
        # packed rows carry no gatekeeper id, so equal vectors land here;
        # confirm true concurrency on the Stamp (EQUAL-same-gk passes,
        # matching clock.compare exactly) — the residue is tiny
        if v.status == OK and s is not None and compare(
                s, stamps[tx_of[i]]) is Order.CONCURRENT:
            v.concurrent.append(s)
    return verdicts, len(flat)


def refine_commit(oracle: TimelineOracle,
                  pending: Sequence[Tuple[int, Stamp, List[Stamp]]]
                  ) -> List[int]:
    """Commit ``upd ≺ tx`` for every concurrent residue pair, batched.

    ``pending`` holds ``(tx_index, tx_stamp, [upd stamps...])``; the
    whole residue ships to the oracle as ONE round trip (the caller
    charges a single ``oracle_rtt``), mirroring the per-tx path's
    ``create_event + assert_order`` semantics per pair.  Returns the tx
    indices whose commitment closed a cycle — those retry with a fresh
    stamp, exactly like the per-tx path's ``CycleError`` branch."""
    failed: List[int] = []
    for idx, tx_stamp, upds in pending:
        try:
            for upd in upds:
                oracle.create_event(upd)
                oracle.create_event(tx_stamp)
                oracle.assert_order(upd.key(), tx_stamp.key())
        except CycleError:
            failed.append(idx)
    return failed


# ---------------------------------------------------------------------------
# Packed shard delivery
# ---------------------------------------------------------------------------

class WriteBatch:
    """One gatekeeper window's committed writes for ONE shard.

    ``items`` is ``[(stamp, ops), ...]`` in commit-stamp order; the
    batch travels as a single sequence-numbered queue item (stamp = the
    first/lowest stamp, which is what the shard's head-ordering loop
    keys on) and applies via ``MVGraphPartition.apply_batch`` — the
    write-side mirror of the read side's packed ``Frontier``."""

    __slots__ = ("items",)

    def __init__(self, items: List[Tuple[Stamp, List[dict]]]):
        self.items = items

    def __len__(self) -> int:
        return len(self.items)

    @property
    def stamp(self) -> Stamp:
        return self.items[0][0]

    def n_ops(self) -> int:
        return sum(len(ops) for _, ops in self.items)

    def nbytes(self) -> int:
        """Simulated wire size: one header + packed per-op payload."""
        return 64 + 16 * len(self.items) + 48 * self.n_ops()
