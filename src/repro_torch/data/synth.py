"""Synthetic data generators: token streams, recsys interactions, the
social-network and blockchain graphs and the TAO request mix used by the
paper's benchmarks.  Each draws from a numpy ``Generator`` exactly as the
reference's does, so one seed gives the reference's arrays and lists and
leaves the generator in the same state."""

from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np


def token_batches(rng: np.random.Generator, vocab: int, batch: int,
                  seq: int) -> Iterator[dict]:
    """Zipfian token stream with next-token labels."""
    ranks = np.arange(1, vocab + 1)
    probs = 1.0 / ranks
    probs /= probs.sum()
    while True:
        toks = rng.choice(vocab, size=(batch, seq + 1), p=probs)
        yield {"tokens": toks[:, :-1].astype(np.int32),
               "labels": toks[:, 1:].astype(np.int32)}


def lm_batch(rng: np.random.Generator, vocab: int, batch: int,
             seq: int) -> dict:
    toks = rng.integers(0, vocab, size=(batch, seq + 1))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def sasrec_batch(rng: np.random.Generator, n_items: int, batch: int,
                 seq: int) -> dict:
    hist = rng.integers(1, n_items + 1, size=(batch, seq)).astype(np.int32)
    pos = rng.integers(1, n_items + 1, size=(batch, seq)).astype(np.int32)
    neg = rng.integers(1, n_items + 1, size=(batch, seq)).astype(np.int32)
    return {"hist": hist, "pos": pos, "neg": neg}


# ---------------------------------------------------------------- paper data
def social_graph(rng: np.random.Generator, n_users: int,
                 avg_degree: int) -> List[Tuple[str, str]]:
    """Power-law follower graph (LiveJournal-flavoured)."""
    n_edges = n_users * avg_degree
    w = 1.0 / np.arange(1, n_users + 1) ** 0.8
    w /= w.sum()
    src = rng.choice(n_users, size=n_edges, p=w)
    dst = rng.choice(n_users, size=n_edges, p=w)
    return [(f"u{s}", f"u{d}") for s, d in zip(src, dst) if s != d]


def blockchain(rng: np.random.Generator, n_blocks: int,
               tx_per_block_fn=None) -> List[dict]:
    """Synthetic Bitcoin-like chain: block vertices pointing at their
    transactions, transactions pointing at output addresses.

    tx counts per block grow with height like the real chain (Fig. 7)."""
    chain = []
    addr_pool = [f"addr{i}" for i in range(max(64, n_blocks * 4))]
    for h in range(n_blocks):
        if tx_per_block_fn is not None:
            n_tx = max(1, int(tx_per_block_fn(h)))
        else:
            n_tx = max(1, int((h + 1) ** 1.2 / 2) + int(rng.integers(0, 3)))
        txs = []
        for t in range(n_tx):
            n_out = int(rng.integers(1, 4))
            outs = list(rng.choice(addr_pool, size=n_out, replace=False))
            txs.append({"id": f"tx_{h}_{t}",
                        "value": float(rng.random() * 10),
                        "outputs": outs})
        chain.append({"height": h, "id": f"block_{h}", "txs": txs})
    return chain


def tao_workload(rng: np.random.Generator, n: int, read_frac: float,
                 vertices: List[str]) -> List[dict]:
    """The paper's Table 1 mix scaled to ``read_frac`` reads.

    Reads:  get_edges 59.4%, count_edges 11.7%, get_node 28.9% (of reads)
    Writes: create_edge 80%, delete_edge 20%            (of writes)
    """
    ops = []
    for _ in range(n):
        v = vertices[int(rng.integers(0, len(vertices)))]
        if rng.random() < read_frac:
            r = rng.random()
            if r < 0.594:
                ops.append({"type": "get_edges", "v": v})
            elif r < 0.594 + 0.117:
                ops.append({"type": "count_edges", "v": v})
            else:
                ops.append({"type": "get_node", "v": v})
        else:
            if rng.random() < 0.8:
                u = vertices[int(rng.integers(0, len(vertices)))]
                ops.append({"type": "create_edge", "v": v, "u": u})
            else:
                ops.append({"type": "delete_edge", "v": v})
    return ops
