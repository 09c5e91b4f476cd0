"""Serving launcher: ``python -m repro_torch.launch.serve --mode
<graph|lm|rec>``, on the card by default (``--device cpu`` runs the
kernels' plain versions on the CPU).

graph (the default): boot the paper's Weaver deployment, load a synthetic
social graph, serve the TAO read/write mix (the paper's native serving
workload) through ``GraphQueryServer``; the deployment's stamp compares
run on ``--device``.
lm / rec: batched model serving on reduced configs.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch


def serve_graph(args) -> int:
    from repro_torch.configs import PAPER_DEPLOYMENT
    from repro_torch.core import Weaver
    from repro_torch.data import synth
    from repro_torch.runtime import GraphQueryServer

    w = Weaver(dataclasses.replace(PAPER_DEPLOYMENT, device=args.device))
    rng = np.random.default_rng(args.seed)
    edges = synth.social_graph(rng, n_users=args.users, avg_degree=8)
    vertices = sorted({v for e in edges for v in e})
    # bulk load in chunks of transactions
    for i in range(0, len(vertices), 64):
        tx = w.begin_tx()
        for v in vertices[i:i + 64]:
            tx.create_vertex(v)
        if not w.run_tx(tx).ok:
            raise RuntimeError("loading the graph's vertices failed")
    for i in range(0, len(edges), 64):
        tx = w.begin_tx()
        for s, d in edges[i:i + 64]:
            tx.create_edge(s, d)
        if not w.run_tx(tx).ok:
            raise RuntimeError("loading the graph's edges failed")

    server = GraphQueryServer(w)
    ops = synth.tao_workload(rng, args.requests, read_frac=0.998,
                             vertices=vertices)
    t0 = w.sim.now
    for op in ops:
        if op["type"] in ("get_edges", "count_edges", "get_node"):
            server.submit("prog", (op["type"], [(op["v"], None)]))
        elif op["type"] == "create_edge":
            tx = w.begin_tx()
            tx.create_edge(op["v"], op["u"])
            server.submit("tx", tx)
        else:
            ed = w.read_vertex(op["v"])
            if ed and ed["edges"]:
                tx = w.begin_tx()
                tx.delete_edge(op["v"], next(iter(ed["edges"])))
                server.submit("tx", tx)
    server.drain(timeout=30.0)
    dt = w.sim.now - t0
    done = len(server.completed)
    print(f"served {done}/{len(ops)} requests in {dt:.3f}s simulated "
          f"-> {done / max(dt, 1e-9):,.0f} req/s")
    c = w.counters()
    print(f"oracle calls: {c['oracle_calls']}, announce msgs: "
          f"{c['announce_messages']}, committed tx: {c['tx_committed']}")
    return 0


def serve_lm(args) -> int:
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import reduced_config
    from repro_torch.models import transformer
    from repro_torch.runtime import LMServer

    spec = get_arch(args.arch or "gemma3-1b")
    cfg = reduced_config(spec)
    params = transformer.init_params(cfg, seed=0, device=args.device)
    rng = np.random.default_rng(args.seed)
    srv = LMServer(params, cfg, batch=args.batch, max_len=64,
                   device=args.device)
    prompts = rng.integers(0, cfg.vocab, (args.batch, 16))
    first = srv.prefill_batch(prompts)
    toks = srv.decode(first, steps=16)
    print(f"decoded {toks.shape} tokens for {args.batch} sessions on "
          f"{args.device}")
    return 0


def serve_rec(args) -> int:
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import reduced_config
    from repro_torch.models import sasrec
    from repro_torch.runtime import RecServer

    cfg = reduced_config(get_arch("sasrec"))
    params = sasrec.init_params(cfg, seed=0, device=args.device)
    rng = np.random.default_rng(args.seed)
    srv = RecServer(params, cfg, device=args.device)
    hist = rng.integers(1, cfg.n_items + 1, (args.batch, cfg.seq_len))
    top = srv.top_k(hist, k=10)
    print(f"top-10 recommendations for {args.batch} users: {top.shape} on "
          f"{args.device}")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["graph", "lm", "rec"],
                    default="graph")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--users", type=int, default=200)
    ap.add_argument("--requests", type=int, default=500)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device} needs a CUDA device and "
                           f"none is available; pass --device cpu")
    return {"graph": serve_graph, "lm": serve_lm,
            "rec": serve_rec}[args.mode](args)


if __name__ == "__main__":
    sys.exit(main())
