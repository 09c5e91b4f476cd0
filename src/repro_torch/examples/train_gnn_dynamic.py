"""Train a GIN on a LIVE Weaver graph: writers mutate the graph while the
trainer pulls snapshot-consistent minibatches at refinable timestamps —
the paper's long-read/concurrent-write isolation as a training feature.

    PYTHONPATH=src python -m repro_torch.examples.train_gnn_dynamic
    PYTHONPATH=src python -m repro_torch.examples.train_gnn_dynamic --device cpu

The store, the writer and the 30 steps are the reference example's
(``examples/train_gnn_dynamic.py``).  The store's stamp compares and the
model both run on ``--device`` (the card by default).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Iterator, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core import Weaver, WeaverConfig
from repro_torch.data.pipeline import DynamicGraphPipeline, batch_to_torch
from repro_torch.models import gnn, mp
from repro_torch.optim import AdamWConfig, adamw, make_train_step


def build_store(device: str) -> Weaver:
    """A 24-vertex store with ~60 random edges, committed in one tx."""
    w = Weaver(WeaverConfig(n_gatekeepers=2, n_shards=3, seed=3,
                            device=device))
    tx = w.begin_tx()
    for i in range(24):
        tx.create_vertex(f"v{i}")
    rng = np.random.default_rng(0)
    for _ in range(60):
        a, b = rng.integers(0, 24, 2)
        if a != b:
            tx.create_edge(f"v{a}", f"v{b}")
    if not w.run_tx(tx).ok:
        raise RuntimeError("seeding the store failed")
    return w


def make_writer(first: int = 24):
    """Concurrent mutator: adds a vertex + edge between batches."""
    counter = {"i": first}

    def writer(wv: Weaver) -> None:
        tx = wv.begin_tx()
        vid = tx.create_vertex(f"v{counter['i']}")
        tx.create_edge(vid, f"v{counter['i'] % 24}")
        counter["i"] += 1
        if not wv.run_tx(tx).ok:
            raise RuntimeError("writer tx failed")

    return writer


def config() -> gnn.GNNConfig:
    return dataclasses.replace(get_arch("gin-tu").config, n_layers=2,
                               d_hidden=16, d_feat=8, n_classes=3)


def batches(device: str) -> Iterator[dict]:
    """The example's stream of snapshot batches (numpy arrays)."""
    pipe = DynamicGraphPipeline(build_store(device), d_feat=8, n_classes=3,
                                pad_nodes=64, pad_edges=256)
    return pipe.batches(mutate_between=make_writer())


def train(device: str, steps: int = 30, model: Optional[gnn.GNN] = None,
          log_every: int = 10) -> List[float]:
    """Run ``steps`` AdamW steps of the example's GIN on ``device`` over
    :func:`batches`; returns the losses.  ``model`` defaults to a fresh
    model (seed 0)."""
    cfg = config()
    if model is None:
        model = gnn.init_model(cfg, torch.Generator().manual_seed(0))
    model = model.to(device)
    stream = batches(device)
    step = make_train_step(lambda m, b: gnn.gnn_loss(m, b, cfg),
                           AdamWConfig(lr=1e-2, warmup_steps=2,
                                       total_steps=30))
    opt = adamw.init(dict(model.named_parameters()))
    losses = []
    for i in range(steps):
        b = next(stream)
        model, opt, m = step(model, opt, batch_to_torch(b, device))
        losses.append(float(m["loss"]))
        if log_every and (i + 1) % log_every == 0:
            live = int(b["label_mask"].sum())
            print(f"step {i+1:3d}  loss {losses[-1]:.4f}  "
                  f"(snapshot had {live} live nodes)")
    return losses


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the store's compares and the model run")
    ap.add_argument("--steps", type=int, default=30)
    args = ap.parse_args(argv)
    # pipeline batches are CSC-sorted (dst-major): claim sorted segment ids
    mp.set_sorted_indices(True)
    train(args.device, args.steps)
    print(f"done — every batch was a consistent snapshot while "
          f"{args.steps} writers committed concurrently")
    return 0


if __name__ == "__main__":
    sys.exit(main())
