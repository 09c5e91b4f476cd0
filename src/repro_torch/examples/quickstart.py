"""Quickstart: a Weaver graph store in 40 lines — transactions, node
programs, snapshot isolation.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

The reference example's (``examples/quickstart.py``) store and requests;
the store's stamp compares run on ``--device`` (the card by default).
"""

from __future__ import annotations

import sys

from repro_torch.core import Weaver, WeaverConfig
from repro_torch.examples.common import device_args


def main(argv=None) -> int:
    args = device_args(__doc__.splitlines()[0], argv)
    w = Weaver(WeaverConfig(n_gatekeepers=2, n_shards=3, seed=42,
                            device=args.device))

    # 1. strictly serializable transactions (paper Fig. 2 style)
    tx = w.begin_tx()
    user = tx.create_vertex("user")
    photo = tx.create_vertex("photo")
    own = tx.create_edge(user, photo)
    tx.set_edge_prop(own, "rel", "OWNS")
    for friend in ("ana", "bob"):
        tx.create_vertex(friend)
        e = tx.create_edge(photo, friend)
        tx.set_edge_prop(e, "rel", "VISIBLE")
    result = w.run_tx(tx)
    print(f"commit ok={result.ok} stamp={result.stamp}")

    # 2. node programs: traversal on a consistent snapshot
    reachable, stamp, latency = w.run_program("traverse",
                                              [("user", {"depth": 0})])
    print(f"reachable from user: {reachable}  "
          f"({latency*1e3:.2f} ms simulated)")

    # 3. snapshot isolation: a concurrent delete does not tear the read
    tx2 = w.begin_tx()
    tx2.delete_edge(own)
    boxes = []
    w.submit_tx(tx2, boxes.append)
    w.submit_program("traverse", [("user", {"depth": 0})],
                     lambda r, s, l: boxes.append(r))
    w.sim.run(until=w.sim.now + 0.1)
    print(f"after concurrent delete: tx ok={boxes[0].ok}, "
          f"traversal saw {boxes[1]} (all-or-nothing, never a torn path)")
    print("counters:", {k: v for k, v in w.counters().items() if v})
    return 0


if __name__ == "__main__":
    sys.exit(main())
