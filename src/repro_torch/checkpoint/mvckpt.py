"""Multi-version checkpoint store tagged with refinable timestamps.

The paper's technique applied to the training substrate: checkpoints are
*versions* stamped exactly like Weaver transactions —
``(epoch, vector-of-writer-counters)`` — so

* concurrent async checkpoint writers (one per data-parallel host group)
  order by vector-clock happens-before; truly concurrent saves are
  refined through a timeline oracle, exactly as shard servers refine
  conflicting transactions;
* restart picks the max stamp that is *complete* (all writer shards
  present) — a torn checkpoint is never restored (atomic pointer flip);
* failure bumps the epoch (cluster-manager barrier semantics), so every
  post-restart save orders after every pre-failure save;
* leaves are saved whole, so a restore may put them on another device
  than the one that saved them (card to CPU and back).

Storage layout: ``<dir>/v_e<EPOCH>_<CTRS>/<leaf-path>.npy`` + a
``MANIFEST.json`` written last (the commit point).  A state is a tree of
nested dicts, lists, tuples and NamedTuples of tensors; a leaf's file is
named by its path as the reference names it (``jax.tree_util`` paths:
dict keys, sequence indices, ``.field`` for a NamedTuple field, joined
by ``__``, dict keys in sorted order), so a directory written by either
package restores in the other.  bf16 leaves are saved as fp32.
"""

from __future__ import annotations

import json
import os
import shutil
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.clock import Order, Stamp, compare
from repro_torch.core.oracle import KIND_TX, TimelineOracle
from repro_torch.models.layers import map_tree


def _path_str(path: Tuple[str, ...]) -> str:
    return "__".join(path)


def _host_array(leaf) -> np.ndarray:
    """A leaf as a numpy array; dtypes numpy lacks (bf16) as fp32."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        return t.cpu().numpy()
    arr = np.asarray(leaf)
    if arr.dtype.kind not in "biufc":
        arr = arr.astype(np.float32)
    return arr


@dataclass
class CheckpointInfo:
    stamp: Stamp
    step: int
    path: str
    complete: bool


class MVCheckpointStore:
    def __init__(self, directory: str, n_writers: int = 1,
                 writer_id: int = 0, keep: int = 3):
        self.dir = directory
        self.n_writers = n_writers
        self.writer_id = writer_id
        self.keep = keep
        self.clock = [0] * n_writers
        self.epoch = 0
        self.oracle = TimelineOracle()
        os.makedirs(directory, exist_ok=True)
        # recover clock from existing checkpoints (restart path)
        for info in self.list_checkpoints():
            st = info.stamp
            self.epoch = max(self.epoch, st.epoch)
            for i, c in enumerate(st.clock):
                self.clock[i] = max(self.clock[i], c)

    # ---- stamping --------------------------------------------------------
    def _tick(self) -> Stamp:
        self.clock[self.writer_id] += 1
        return Stamp(self.epoch, tuple(self.clock), self.writer_id,
                     self.clock[self.writer_id])

    def merge_remote_clock(self, clock: Tuple[int, ...]) -> None:
        """Announce handling (writers gossip clocks like gatekeepers)."""
        self.clock = [max(a, b) for a, b in zip(self.clock, clock)]

    def bump_epoch(self) -> None:
        """Failure barrier: all post-failure saves order after all
        pre-failure saves (paper §4.3)."""
        self.epoch += 1
        self.clock = [0] * self.n_writers

    # ---- save (atomic: manifest written last) ------------------------------
    def save(self, params, step: int, extra: Optional[dict] = None) -> Stamp:
        stamp = self._tick()
        tag = f"v_e{stamp.epoch}_" + "_".join(map(str, stamp.clock))
        path = os.path.join(self.dir, tag)
        tmp = path + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        names = []

        def write(kp, leaf):
            names.append(_path_str(kp))
            np.save(os.path.join(tmp, names[-1] + ".npy"), _host_array(leaf))

        map_tree(write, params)
        manifest = {
            "stamp": {"epoch": stamp.epoch, "clock": list(stamp.clock),
                      "gk": stamp.gk, "ctr": stamp.ctr},
            "step": step,
            "leaves": names,
            "writer": self.writer_id,
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, path)          # commit point
        self._gc()
        return stamp

    # ---- list / order -------------------------------------------------------
    def list_checkpoints(self) -> List[CheckpointInfo]:
        out = []
        if not os.path.isdir(self.dir):
            return out
        for tag in sorted(os.listdir(self.dir)):
            if tag.endswith(".tmp"):
                continue
            mf = os.path.join(self.dir, tag, "MANIFEST.json")
            if not os.path.exists(mf):
                continue                          # torn save: ignore
            with open(mf) as f:
                m = json.load(f)
            st = Stamp(m["stamp"]["epoch"], tuple(m["stamp"]["clock"]),
                       m["stamp"]["gk"], m["stamp"]["ctr"])
            out.append(CheckpointInfo(st, m["step"],
                                      os.path.join(self.dir, tag), True))
        return out

    def latest(self) -> Optional[CheckpointInfo]:
        infos = self.list_checkpoints()
        if not infos:
            return None
        best = infos[0]
        for info in infos[1:]:
            o = compare(best.stamp, info.stamp)
            if o is Order.BEFORE:
                best = info
            elif o is Order.CONCURRENT:
                # refine: identical to Weaver's conflicting-transaction
                # path — commit an order at the oracle, reuse forever
                chain = self.oracle.order_events(
                    [best.stamp, info.stamp], [KIND_TX, KIND_TX])
                if chain[-1] == info.stamp.key():
                    best = info
        return best

    # ---- restore -------------------------------------------------------------
    def restore(self, like_tree, info: Optional[CheckpointInfo] = None,
                device=None):
        """The checkpoint ``info`` (the latest when None) in the structure,
        shapes and dtypes of ``like_tree``'s tensors, each on ``device``
        (None: the device of its ``like_tree`` leaf)."""
        info = info or self.latest()
        if info is None:
            raise FileNotFoundError("no checkpoint found")

        def load(kp, leaf):
            name = _path_str(kp)
            arr = np.load(os.path.join(info.path, name + ".npy"))
            if arr.shape != tuple(leaf.shape):
                raise ValueError(f"{name}: saved {arr.shape}, expected "
                                 f"{tuple(leaf.shape)}")
            return torch.from_numpy(arr).to(
                device=leaf.device if device is None else device,
                dtype=leaf.dtype)

        return map_tree(load, like_tree), info

    def _gc(self) -> None:
        infos = self.list_checkpoints()
        if len(infos) <= self.keep:
            return
        # total order (refine where needed) then drop the oldest
        infos.sort(key=lambda i: (i.stamp.epoch, sum(i.stamp.clock)))
        for info in infos[:-self.keep]:
            shutil.rmtree(info.path, ignore_errors=True)
