"""Dynamic-graph training pipeline: Weaver store -> snapshot-consistent
minibatches (the paper technique as a first-class training feature).

Writers apply update transactions to the Weaver store while the trainer
pulls batches; each batch is materialized *at a refinable timestamp* via
``analytics.snapshot_arrays``, so a long epoch of GNN steps sees one
coherent graph version per batch no matter how fast writers mutate the
graph — exactly the long-read/concurrent-write isolation the paper
builds refinable timestamps for.

Batches ride the columnar snapshot engine: the first batch pays a cold
columnar build, every later batch is a **delta refresh** that only
re-evaluates the stamps the writers touched since the previous batch
(O(changed), see ``analytics.SnapshotEngine``).  Edges are emitted in
the snapshot's **CSC (dst-major) orientation** with the padding
sentinel (``pad_nodes - 1``, the maximum index) appended last, so
``edge_dst`` is globally non-decreasing and every dst-keyed segment
reduction downstream can claim ``indices_are_sorted=True`` — flip it on
for the whole model with
``repro_torch.models.mp.set_sorted_indices(True)`` when training
exclusively from this pipeline.  ``snapshot_stats()``
exposes the engine's cold/delta counters for monitoring the hit rate
under a write workload.

Features and labels come from Python's ``hash(vid)``, as in the
reference, so they are salted per process (``PYTHONHASHSEED``): two
processes give different features for one vertex, while the port and
the reference agree inside one process.  Batches are numpy arrays;
:func:`batch_to_torch` moves one onto a device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from repro_torch.core import analytics
from repro_torch.core.clock import Stamp
from repro_torch.core.weaver import Weaver


@dataclass
class SnapshotBatch:
    x: np.ndarray
    edge_src: np.ndarray
    edge_dst: np.ndarray
    labels: np.ndarray
    label_mask: np.ndarray
    graph_ids: np.ndarray
    n_graphs: int
    stamp: Stamp
    n_real_nodes: int


class DynamicGraphPipeline:
    def __init__(self, weaver: Weaver, d_feat: int, n_classes: int,
                 pad_nodes: int, pad_edges: int, seed: int = 0,
                 feature_fn: Optional[Callable] = None):
        self.weaver = weaver
        self.d_feat = d_feat
        self.n_classes = n_classes
        self.pad_nodes = pad_nodes
        self.pad_edges = pad_edges
        self.rng = np.random.default_rng(seed)
        self.feature_fn = feature_fn
        self._feat_cache: dict = {}

    def _features(self, vid: str) -> np.ndarray:
        if self.feature_fn is not None:
            return self.feature_fn(vid)
        f = self._feat_cache.get(vid)
        if f is None:
            h = abs(hash(vid)) % (2 ** 31)
            f = np.random.default_rng(h).normal(
                size=(self.d_feat,)).astype(np.float32)
            self._feat_cache[vid] = f
        return f

    def snapshot_stats(self) -> dict:
        """Cold/delta/noop counters of the weaver's snapshot engine."""
        eng = getattr(self.weaver, "_snapshot_engine", None)
        return dict(eng.stats) if eng is not None else {}

    def snapshot_batch(self) -> SnapshotBatch:
        """One snapshot-consistent full-graph batch at a fresh stamp."""
        # take a fresh stamp by running a trivially small node program:
        # its stamp is the snapshot point (ordered after all committed
        # writes, §4.2)
        vids = list(self.weaver.store.vertices.keys())
        probe = vids[0] if vids else None
        if probe is None:
            raise RuntimeError("empty graph")
        _, stamp, _ = self.weaver.run_program("count_edges", [(probe, None)])
        ga = analytics.snapshot_arrays(self.weaver, stamp)
        n = ga.n_nodes
        assert n <= self.pad_nodes and len(ga.edge_src) <= self.pad_edges, \
            (n, len(ga.edge_src), self.pad_nodes, self.pad_edges)
        x = np.zeros((self.pad_nodes, self.d_feat), np.float32)
        for i, vid in enumerate(ga.vids):
            x[i] = self._features(vid)
        labels = np.zeros((self.pad_nodes,), np.int32)
        for i, vid in enumerate(ga.vids):
            labels[i] = abs(hash(vid + "|y")) % self.n_classes
        mask = np.zeros((self.pad_nodes,), np.float32)
        mask[:n] = 1.0
        pe = self.pad_edges - len(ga.edge_src)
        dead = self.pad_nodes - 1
        # CSC orientation + max-index padding tail => dst is sorted
        src = np.concatenate([ga.csc_src,
                              np.full(pe, dead, np.int32)])
        dst = np.concatenate([ga.csc_dst,
                              np.full(pe, dead, np.int32)])
        return SnapshotBatch(
            x=x, edge_src=src, edge_dst=dst, labels=labels,
            label_mask=mask, graph_ids=np.zeros((self.pad_nodes,), np.int32),
            n_graphs=1, stamp=stamp, n_real_nodes=n)

    def batches(self, mutate_between: Optional[Callable] = None
                ) -> Iterator[dict]:
        while True:
            if mutate_between is not None:
                mutate_between(self.weaver)
            sb = self.snapshot_batch()
            yield {
                "x": sb.x, "edge_src": sb.edge_src, "edge_dst": sb.edge_dst,
                "labels": sb.labels, "label_mask": sb.label_mask,
                "graph_ids": sb.graph_ids, "n_graphs": sb.n_graphs,
            }


def batch_to_torch(batch: dict, device) -> dict:
    """The arrays of a ``batches()`` dict as tensors on ``device``
    (``n_graphs`` stays an int)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            if isinstance(v, np.ndarray) else v for k, v in batch.items()}
