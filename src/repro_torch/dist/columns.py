"""Device-resident columnar data plane: every partition's stamp blocks
spread over a list of devices, visibility evaluated with one ``before``
launch per device.

The host-global engines (``core.analytics.SnapshotEngine``,
``core.frontier.ShardPlan``) gather each partition's stamp tables and
compare them per call.  This plane keeps a *committed* copy of every
partition's packed stamp tables resident on the devices of
:func:`repro_torch.launch.mesh.make_columns_mesh` (every card present by
default) and answers "row ≺ q" for ALL shards in one round over the
devices; only its bit form (one bit per resident row) travels back to
the host, each partition's masks are unpacked from it on demand, and the
concurrent residue still takes the engines' existing single batched
oracle trip (refinement patches the unpacked host masks in place).

Layout invariants (the reference's, ``repro.dist.columns``):

* each shard owns one block ``(TABLES=4, B, C)`` — v_create, v_delete,
  e_create, e_delete stacked under ONE uniform capacity ``B`` (next
  pow2 of the largest table + slack), so the launches need no
  raggedness;
* a rebuild lays out the LIVE partitions only and sizes ``B`` from
  their largest table, pow2(max(min_block, 1.25·rows)); a partition the
  deployment replaced (a killed shard's, after its promotion) is
  dropped with :meth:`DeviceColumnPlane.retire`.  This departs from the
  reference (``repro/dist/columns.py:97``), which keeps every partition
  it has seen and starts a rebuild's size at the current ``B``, so each
  fresh rebuild doubles ``B`` though no table grew; masks, records and
  ``launches`` are the reference's either way;
* devices own contiguous block ranges: with ``spd = ceil(S / n_dev)``
  blocks per device, block ``bi`` lives on device ``bi // spd`` at slot
  ``bi % spd`` of that device's ``(spd, 4, B, C)`` int32 tensor;
* unused rows and blocks are ``NO_STAMP`` — the compare maps them to
  False, so padding never flips a mask;
* a device's rows number ``spd·4·B``, a multiple of 32 (``B`` >= 8), so
  the devices' bit words concatenate into one bit stream over the
  flattened ``(n_dev·spd, 4, B)`` rows;
* maintenance follows the partitions' ``cursor()``/``CompactionEvent``
  contract: appends and in-place stamp patches become row scatters on
  the owning device (``index_copy_``, O(changed)); a compaction remap
  re-uploads that shard's block (same O(live) cost class as the host
  engines' remap).

The host-global path stays the equivalence oracle — see
``WeaverConfig.device_shard_columns``.
"""

from __future__ import annotations

import contextlib
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


def _on(dev: torch.device):
    """``dev`` current for the block, for a card; nothing for the CPU."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


class DeviceColumnPlane:
    """Device-resident stamp blocks + one ``before`` launch per device.

    One plane per deployment (``Weaver.device_plane``); both the
    snapshot engine and per-shard plan builds feed from it.  Blocks are
    keyed by column-table identity (``id(cols)`` with a strong ref), so
    dead shards, promoted backups and engine rebuilds never confuse
    block assignment; :meth:`retire` drops a replaced partition's block
    at the next rebuild.  ``devices`` defaults to
    ``launch.mesh.make_columns_mesh()``: every card present.  A device
    may be listed more than once (each entry then holds its own blocks).
    """

    def __init__(self, n_gk: int, devices: Optional[Sequence] = None,
                 min_block: int = _MIN_BLOCK):
        if min_block < 8:
            raise ValueError(f"min_block must be at least 8 (a block's "
                             f"rows fill whole bit words), got {min_block}")
        from ..launch.mesh import columns_devices
        self.n_gk = n_gk
        self.c = n_gk + 1
        self.devices = columns_devices(devices)
        self.n_dev = len(self.devices)
        self.min_block = min_block
        self._idx: Dict[int, int] = {}     # id(cols) -> block index
        self._cols: List[object] = []      # block index -> cols (strong
        #                                    ref; None once retired, until
        #                                    the next rebuild drops it)
        self._consumed: List[Optional[List[int]]] = []  # per-block cursor
        self._cap = 0                      # B: rows per (table, block)
        self._spd = 0                      # blocks (shards) per device
        self._dev: List[torch.Tensor] = []  # per-device (spd, 4, B, C) int32
        # the query stamp on its way to every device, and every device's
        # bit words on their way back: pinned where a card takes part,
        # so the copies neither wait nor run one card after another
        self._pinned = any(d.type == "cuda" for d in self.devices)
        self._q_host = torch.empty((self.c,), dtype=torch.int32,
                                   pin_memory=self._pinned)
        self._host = torch.empty((0,), dtype=torch.int32)
        # the last round's bit words as bytes: bit k = row k of the
        # flattened (n_dev·spd, 4, B) rows, least significant bit first
        self._bits: Optional[np.ndarray] = None
        self._masks_q: Optional[bytes] = None
        self.stats = {"rebuilds": 0, "row_updates": 0, "block_uploads": 0,
                      "launches": 0}

    # ---- residency maintenance -------------------------------------------

    def sync(self, shard_cols: Sequence) -> None:
        """Bring resident blocks up to date with each partition's change
        feed.  O(changed) per device for appends/patches; a compaction
        re-uploads, and an unseen partition or a table past ``B``
        rebuilds."""
        live = [c for c in shard_cols if c is not None]
        need = 0
        fresh = not self._dev
        for cols in live:
            if not self._holds(cols):
                fresh = True
            need = max(need, cols.n_v, cols.n_e)
        if fresh or need > self._cap:
            for cols in live:
                if not self._holds(cols):
                    self._idx[id(cols)] = len(self._cols)
                    self._cols.append(cols)
                    self._consumed.append(None)
            self._rebuild()
            return
        for cols in live:
            self._sync_one(self._idx[id(cols)], cols)

    def _holds(self, cols) -> bool:
        bi = self._idx.get(id(cols))
        return bi is not None and self._cols[bi] is cols

    def retire(self, cols) -> None:
        """Forget a partition the deployment replaced (a shard's, when a
        backup or a replica takes its place).  Its block stays in the
        layout, still padding the bit stream, until the next rebuild,
        which leaves it out; so a retire alone neither rebuilds nor
        invalidates the cached bits."""
        if cols is None or not self._holds(cols):
            return
        bi = self._idx.pop(id(cols))
        self._cols[bi] = None
        self._consumed[bi] = None

    def live_blocks(self) -> List[Tuple[int, object, List[int]]]:
        """(block index, partition, synced cursor) of each block that
        holds a current partition, in block order.  A retired block keeps
        its place until the next rebuild so that the other blocks' bits
        stay valid: a retire followed by another shard's ``sync`` and a
        repeated query launches nothing, as in the reference."""
        return [(bi, c, cur) for bi, (c, cur)
                in enumerate(zip(self._cols, self._consumed))
                if c is not None]

    def _rebuild(self) -> None:
        """Lay the live blocks out anew, one device at a time, under
        ``B`` = pow2(max(min_block, 1.25 x their largest table)): the
        device's tensor is filled with ``NO_STAMP`` on the device and
        each of its blocks' synced rows copied in, so the host holds no
        staging copy."""
        self._cols = [c for c in self._cols if c is not None]
        self._idx = {id(c): bi for bi, c in enumerate(self._cols)}
        need = max((max(c.n_v, c.n_e) for c in self._cols), default=0)
        s = len(self._cols)
        self._spd = max(1, -(-s // self.n_dev))
        self._cap = _pow2(max(self.min_block, need + need // 4))
        self._dev = []                      # free the old blocks first
        for d, dev in enumerate(self.devices):
            blk = torch.full((self._spd, TABLES, self._cap, self.c),
                             NO_STAMP, dtype=torch.int32, device=dev)
            for j in range(self._spd):
                bi = d * self._spd + j
                if bi < s:
                    self._fill_block(blk[j], self._cols[bi])
            self._dev.append(blk)
        words = self.n_dev * self._spd * TABLES * self._cap // 32
        self._host = torch.empty((words,), dtype=torch.int32,
                                 pin_memory=self._pinned)
        self._consumed = [c.cursor() for c in self._cols]
        self._bits = None
        self.stats["rebuilds"] += 1

    @staticmethod
    def _fill_block(block: torch.Tensor, cols) -> None:
        """Copy ``cols``' synced rows into ``block`` (4, B, C), whose
        other rows already hold ``NO_STAMP``."""
        nv, ne = cols.n_v, cols.n_e
        for t, n, tbl in ((0, nv, cols.v_create), (1, nv, cols.v_delete),
                          (2, ne, cols.e_create), (3, ne, cols.e_delete)):
            if n:
                block[t, :n].copy_(torch.from_numpy(tbl.view()))

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
        self._bits = None

    def _scatter(self, bi: int,
                 ups: List[Tuple[int, np.ndarray, np.ndarray]]) -> None:
        d, j = divmod(bi, self._spd)
        dev, blk = self.devices[d], self._dev[d]
        for t, idx, rows in ups:
            blk[j, t].index_copy_(0, torch.from_numpy(idx).to(dev),
                                  to_device(rows, dev))
            self.stats["row_updates"] += idx.size

    def _upload_block(self, bi: int, cols) -> None:
        d, j = divmod(bi, self._spd)
        block = self._dev[d][j]
        block.fill_(NO_STAMP)
        self._fill_block(block, cols)
        self._bits = None
        self.stats["block_uploads"] += 1

    # ---- the launches ------------------------------------------------------

    def before_all(self, q: np.ndarray) -> None:
        """``row ≺ q`` for every resident block in one round over the
        devices: under each device in turn ``q`` goes in and the
        ``before`` kernel's bit form launches on the device's current
        stream; then each device's words are queued for its slice of the
        pinned host buffer; only then does the host wait, once per card,
        so the cards compare at the same time.  S·4·B / 8 bytes come back
        (8x fewer than a bool per row); the bits are cached until the
        next mutation or query change.  Call after :meth:`sync`."""
        q = np.asarray(q, np.int32)
        if self._bits is not None and self._masks_q == q.tobytes():
            return
        self._copy_back(self._launch_all(q))
        self._wait()
        self._bits = self._host.numpy().view(np.uint8)
        self._masks_q = q.tobytes()
        self.stats["launches"] += 1

    def _launch_all(self, q: np.ndarray) -> List[torch.Tensor]:
        """Each device's bit words of ``rows ≺ q``, launched in turn and
        not waited for."""
        self._q_host.numpy()[:] = q
        out = []
        for dev, blk in zip(self.devices, self._dev):
            with _on(dev):
                qd = self._q_host.to(dev, non_blocking=True)
                out.append(mv_ops.before_mask(blk.view(-1, self.c), qd,
                                              bits=True))
        return out

    def _copy_back(self, words: List[torch.Tensor]) -> None:
        """Queue each device's words into its slice of the host buffer."""
        per = self._host.numel() // self.n_dev
        for d, (dev, w) in enumerate(zip(self.devices, words)):
            with _on(dev):
                self._host[d * per:(d + 1) * per].copy_(w, non_blocking=True)

    def _wait(self) -> None:
        """Wait once for each distinct card."""
        for dev in dict.fromkeys(self.devices):
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()

    def _unpack(self, bi: int, table: int, n: int) -> np.ndarray:
        """The first ``n`` rows of block ``bi``'s ``table`` as bools."""
        lo = (bi * TABLES + table) * self._cap
        raw = np.unpackbits(self._bits[lo // 8:(lo + n + 7) // 8],
                            bitorder="little")
        return raw[lo % 8:lo % 8 + n].view(bool)

    def masks_for(self, cols) -> Tuple[np.ndarray, np.ndarray,
                                       np.ndarray, np.ndarray]:
        """(v_create≺q, v_delete≺q, e_create≺q, e_delete≺q) boolean masks
        for one partition, unpacked for its synced row counts only."""
        bi = self._idx[id(cols)]
        nv, ne = self._consumed[bi][:2]
        return tuple(self._unpack(bi, t, n)
                     for t, n in enumerate((nv, nv, ne, ne)))

    def has(self, cols) -> bool:
        return self._holds(cols) and self._bits is not None
