"""CoinGraph (paper §5.1): a Bitcoin blockchain explorer on Weaver.

Ingests a synthetic chain transactionally (blocks arrive as atomic
transactions — forks/reorgs would replace a block's graph atomically),
then serves block-render queries as node programs.

    PYTHONPATH=src python -m repro_torch.examples.coingraph
    PYTHONPATH=src python -m repro_torch.examples.coingraph --device cpu

The reference example's (``examples/coingraph.py``) chain, queries and
reorg; the store's stamp compares run on ``--device`` (the card by
default).
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np

from repro_torch.configs import PAPER_DEPLOYMENT
from repro_torch.core import Weaver
from repro_torch.data import synth
from repro_torch.examples.common import build_chain_in_weaver, device_args


def main(argv=None) -> int:
    args = device_args(__doc__.splitlines()[0], argv)
    rng = np.random.default_rng(7)
    chain = synth.blockchain(rng, n_blocks=16)
    w = Weaver(dataclasses.replace(PAPER_DEPLOYMENT, device=args.device))
    build_chain_in_weaver(w, chain)
    print(f"ingested {len(chain)} blocks, "
          f"{sum(len(b['txs']) for b in chain)} transactions")

    for h in (1, 8, 15):
        block = chain[h]
        res, stamp, lat = w.run_program("block_render",
                                        [(block["id"], {"hop": 0})])
        total = sum(r["value"] for r in res)
        print(f"block {h:3d}: {len(res):3d} txs, total value "
              f"{total:8.2f} BTC, {lat*1e3:6.2f} ms "
              f"({lat/max(len(res),1)*1e3:.3f} ms/tx)")

    # a reorg: atomically replace the tip block's transaction set
    tip = chain[-1]
    tx = w.begin_tx()
    for eid in list(w.read_vertex(tip["id"])["edges"]):
        tx.delete_edge(tip["id"], eid)
    replacement = tx.create_vertex("tx_reorg_0")
    tx.create_edge(tip["id"], replacement)
    print("reorg commit:", w.run_tx(tx).ok)
    res, _, _ = w.run_program("get_edges", [(tip["id"], None)])
    print(f"tip now has {len(res)} edge(s) — swapped atomically")
    return 0


if __name__ == "__main__":
    sys.exit(main())
