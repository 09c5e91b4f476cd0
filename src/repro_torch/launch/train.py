"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--device cuda|cpu] ...``.

It runs REDUCED configs (``reduced_config``: the same code path as the
full config, at the widths the CPU tests and the serving launcher use)
through ``runtime.Trainer`` on the card, or on the CPU with ``--device
cpu``; an LM or SASRec parameter tree trains as one
``layers.ParamTree``.  Prints the final loss, as the reference's
launcher does.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile

import numpy as np


def reduced_config(spec):
    cfg = spec.config
    if spec.family == "lm":
        moe = cfg.moe
        if moe is not None:
            moe = dataclasses.replace(moe, n_experts=4,
                                      top_k=min(moe.top_k, 2), d_expert=32)
        return dataclasses.replace(
            cfg, n_layers=2, d_model=64, n_heads=4,
            n_kv=max(1, cfg.n_kv * 4 // cfg.n_heads), d_head=16, d_ff=128,
            vocab=512, moe=moe, dtype="float32")
    if spec.family == "gnn":
        return dataclasses.replace(cfg, d_hidden=32, d_feat=16, n_classes=4)
    return dataclasses.replace(cfg, n_items=1000, seq_len=16, d_embed=32)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core.analytics import check_device
    from repro_torch.data import graphs as G, synth
    from repro_torch.models import gnn, sasrec, transformer
    from repro_torch.models.layers import ParamTree
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import Trainer, TrainerConfig

    check_device(args.device)
    spec = get_arch(args.arch)
    cfg = reduced_config(spec)
    rng = np.random.default_rng(args.seed)

    if spec.family == "lm":
        model = ParamTree(transformer.init_params(cfg, seed=args.seed,
                                                  device=args.device))
        loss_fn = lambda m, b: transformer.lm_loss(m.tree(), b, cfg)  # noqa: E731

        def batches():
            while True:
                yield synth.lm_batch(rng, cfg.vocab, args.batch, args.seq)
    elif spec.family == "gnn":
        n, e = 256, 1024
        src, dst = G.random_graph(rng, n, e)
        if cfg.kind == "dimenet":
            tin, tout = G.build_triplets(src, dst, max_per_edge=4)
            base = {"species": rng.integers(0, 8, n).astype(np.int32),
                    "pos": rng.normal(size=(n, 3)).astype(np.float32),
                    "edge_src": src, "edge_dst": dst,
                    "trip_in": tin, "trip_out": tout,
                    "graph_ids": np.zeros(n, np.int32), "n_graphs": 1,
                    "labels": np.asarray([0.5], np.float32)}
        else:
            base = {"x": rng.normal(size=(n, cfg.d_feat)).astype(np.float32),
                    "edge_src": src, "edge_dst": dst,
                    "graph_ids": np.zeros(n, np.int32), "n_graphs": 1,
                    "labels": rng.integers(0, cfg.n_classes,
                                           n).astype(np.int32)}
        model = gnn.init_model(
            cfg, torch.Generator().manual_seed(args.seed)).to(args.device)
        loss_fn = lambda m, b: gnn.gnn_loss(m, b, cfg)  # noqa: E731

        def batches():
            while True:
                yield base
    else:
        model = ParamTree(sasrec.init_params(cfg, seed=args.seed,
                                             device=args.device))
        loss_fn = lambda m, b: sasrec.bce_loss(m.tree(), b, cfg)  # noqa: E731

        def batches():
            while True:
                yield synth.sasrec_batch(rng, cfg.n_items, args.batch,
                                         cfg.seq_len)

    trainer = Trainer(
        loss_fn, model,
        AdamWConfig(lr=args.lr, warmup_steps=5, total_steps=args.steps),
        TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                      ckpt_dir=args.ckpt_dir, log_every=10))
    if args.resume and trainer.try_resume():
        print(f"resumed at step {trainer.step}")
    hist = trainer.fit(batches())
    print(f"final loss {hist[-1]['loss']:.4f} after {trainer.step} steps")
    return 0


if __name__ == "__main__":
    sys.exit(main())
