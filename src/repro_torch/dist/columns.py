"""Device-resident columnar data plane: every partition's stamp blocks in
one device tensor, visibility evaluated with ONE kernel launch.

The host-global engines (``core.analytics.SnapshotEngine``,
``core.frontier.ShardPlan``) gather each partition's stamp tables and
compare them per call.  This plane keeps a *committed* copy of every
partition's packed stamp tables resident on the deployment's device and
answers "row ≺ q" for ALL shards with a single ``before`` kernel launch;
only the boolean masks travel back to the host, and the concurrent
residue still takes the engines' existing single batched oracle trip
(refinement patches the host masks in place).

Layout invariants:

* each shard owns one block ``(TABLES=4, B, C)`` — v_create, v_delete,
  e_create, e_delete stacked under ONE uniform capacity ``B`` (next
  pow2 of the largest table + slack), so the whole deployment is one
  dense int32 tensor ``(S, 4, B, C)`` and the launch needs no
  raggedness;
* unused rows are ``NO_STAMP`` — the compare maps them to False, so
  padding never flips a mask;
* maintenance follows the partitions' ``cursor()``/``CompactionEvent``
  contract: appends and in-place stamp patches become row scatters
  (``index_copy_``, O(changed)); a compaction remap re-uploads that
  shard's block (same O(live) cost class as the host engines' remap).

The host-global path stays the equivalence oracle — see
``WeaverConfig.device_shard_columns``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.analytics import to_device
from ..core.clock import NO_STAMP
from ..kernels.mv_visibility import ops as mv_ops

TABLES = 4            # v_create, v_delete, e_create, e_delete
_MIN_BLOCK = 64


def _pow2(n: int) -> int:
    return 1 << max(0, int(n - 1)).bit_length() if n > 1 else 1


class DeviceColumnPlane:
    """Device-resident stamp blocks + one visibility launch.

    One plane per deployment (``Weaver.device_plane``); both the
    snapshot engine and per-shard plan builds feed from it.  Blocks are
    keyed by column-table identity (``id(cols)`` with a strong ref), so
    dead shards, promoted backups and engine rebuilds never confuse
    block assignment.
    """

    def __init__(self, n_gk: int, device: str = "cuda",
                 min_block: int = _MIN_BLOCK):
        self.n_gk = n_gk
        self.c = n_gk + 1
        self.device = torch.device(device)
        self.min_block = min_block
        self._idx: Dict[int, int] = {}     # id(cols) -> block index
        self._cols: List[object] = []      # block index -> cols (strong ref)
        self._consumed: List[Optional[List[int]]] = []  # per-block cursor
        self._cap = 0                      # B: rows per (table, block)
        self._blocks: Optional[torch.Tensor] = None   # (S, 4, B, C) int32
        self._masks: Optional[np.ndarray] = None      # (S, 4, B) bool
        self._masks_q: Optional[bytes] = None
        self.stats = {"rebuilds": 0, "row_updates": 0, "block_uploads": 0,
                      "launches": 0}

    # ---- residency maintenance -------------------------------------------

    def sync(self, shard_cols: Sequence) -> None:
        """Bring resident blocks up to date with each partition's change
        feed.  O(changed) for appends/patches; a compaction (or an unseen
        partition / capacity overflow) re-uploads or rebuilds."""
        live = [c for c in shard_cols if c is not None]
        need = self._cap
        fresh = self._blocks is None
        for cols in live:
            bi = self._idx.get(id(cols))
            if bi is None or self._cols[bi] is not cols:
                fresh = True
            need = max(need, cols.n_v, cols.n_e)
        if fresh or need > self._cap:
            for cols in live:
                bi = self._idx.get(id(cols))
                if bi is None or self._cols[bi] is not cols:
                    self._idx[id(cols)] = len(self._cols)
                    self._cols.append(cols)
                    self._consumed.append(None)
            self._rebuild(need)
            return
        for cols in live:
            self._sync_one(self._idx[id(cols)], cols)

    def _rebuild(self, need_rows: int) -> None:
        self._cap = _pow2(max(self.min_block, need_rows + need_rows // 4))
        host = np.full((len(self._cols), TABLES, self._cap, self.c),
                       NO_STAMP, np.int32)
        for bi, cols in enumerate(self._cols):
            self._fill_block(host[bi], cols)
        self._blocks = to_device(host, self.device)
        for bi, cols in enumerate(self._cols):
            self._consumed[bi] = cols.cursor()
        self._masks = None
        self.stats["rebuilds"] += 1

    @staticmethod
    def _fill_block(block: np.ndarray, cols) -> None:
        nv, ne = cols.n_v, cols.n_e
        if nv:
            block[0, :nv] = cols.v_create.view()
            block[1, :nv] = cols.v_delete.view()
        if ne:
            block[2, :ne] = cols.e_create.view()
            block[3, :ne] = cols.e_delete.view()

    def _sync_one(self, bi: int, cols) -> None:
        cur = self._consumed[bi]
        tgt = cols.cursor()
        if cur == tgt:
            return
        if cur is None or tgt[4] != cur[4]:
            # compaction remap (or never-synced block): the slot space
            # changed wholesale — re-upload this shard's live rows
            self._upload_block(bi, cols)
            self._consumed[bi] = tgt
            return
        nv0, ne0, lv0, le0, _ = cur
        ups: List[Tuple[int, np.ndarray, np.ndarray]] = []
        for t0, n0, n1, patch, p0, cview, dview in (
                (0, nv0, cols.n_v, cols.v_patch, lv0,
                 cols.v_create.view(), cols.v_delete.view()),
                (2, ne0, cols.n_e, cols.e_patch, le0,
                 cols.e_create.view(), cols.e_delete.view())):
            slots = {s for s in patch[p0:] if s < n0}
            if n1 > n0:
                slots.update(range(n0, n1))
            if not slots:
                continue
            idx = np.fromiter(sorted(slots), np.int64, len(slots))
            ups.append((t0, idx, cview[idx]))
            ups.append((t0 + 1, idx, dview[idx]))
        if ups:
            self._scatter(bi, ups)
        self._consumed[bi] = tgt
        self._masks = None

    def _scatter(self, bi: int,
                 ups: List[Tuple[int, np.ndarray, np.ndarray]]) -> None:
        for t, idx, rows in ups:
            self._blocks[bi, t].index_copy_(
                0, torch.from_numpy(idx).to(self.device),
                to_device(rows, self.device))
            self.stats["row_updates"] += idx.size

    def _upload_block(self, bi: int, cols) -> None:
        host = np.full((TABLES, self._cap, self.c), NO_STAMP, np.int32)
        self._fill_block(host, cols)
        self._blocks[bi].copy_(torch.from_numpy(host))
        self._masks = None
        self.stats["block_uploads"] += 1

    # ---- the launch --------------------------------------------------------

    def before_all(self, q: np.ndarray) -> None:
        """ONE ``before`` kernel launch answering ``row ≺ q`` for every
        resident block over the flattened ``(S·4·B, C)`` rows; host-side
        masks cached until the next mutation or query change.  Call
        after :meth:`sync`."""
        q = np.asarray(q, np.int32)
        if self._masks is not None and self._masks_q == q.tobytes():
            return
        rows = self._blocks.view(-1, self.c)
        out = mv_ops.before_mask(rows, to_device(q, self.device))
        self._masks = out.view(self._blocks.shape[:-1]).cpu().numpy()
        self._masks_q = q.tobytes()
        self.stats["launches"] += 1

    def masks_for(self, cols) -> Tuple[np.ndarray, np.ndarray,
                                       np.ndarray, np.ndarray]:
        """(v_create≺q, v_delete≺q, e_create≺q, e_delete≺q) boolean masks
        for one partition, trimmed to its synced row counts."""
        bi = self._idx[id(cols)]
        cur = self._consumed[bi]
        m = self._masks[bi]
        nv, ne = cur[0], cur[1]
        return m[0, :nv], m[1, :nv], m[2, :ne], m[3, :ne]

    def has(self, cols) -> bool:
        bi = self._idx.get(id(cols))
        return (bi is not None and self._cols[bi] is cols
                and self._masks is not None)
