"""End-to-end serving driver (the paper's kind of system): boot a Weaver
deployment, bulk-load a social graph, serve the TAO read/write mix with
batched concurrent requests — and keep serving through a shard failure.

    PYTHONPATH=src python -m repro_torch.examples.social_serve
    PYTHONPATH=src python -m repro_torch.examples.social_serve --device cpu

The reference example's (``examples/social_serve.py``) deployment, graph,
requests and shard kill; the store's stamp compares run on ``--device``
(the card by default).
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np

from repro_torch.configs import PAPER_DEPLOYMENT
from repro_torch.core import Weaver
from repro_torch.data import synth
from repro_torch.examples.common import (ClosedLoopDriver, device_args,
                                         load_weaver_graph)


def main(argv=None) -> int:
    args = device_args(__doc__.splitlines()[0], argv)
    rng = np.random.default_rng(0)
    w = Weaver(dataclasses.replace(PAPER_DEPLOYMENT, device=args.device))
    edges = synth.social_graph(rng, n_users=300, avg_degree=6)
    vertices = load_weaver_graph(w, edges)
    print(f"loaded {len(vertices)} users, {len(edges)} follows")

    ops = synth.tao_workload(rng, 3000, read_frac=0.998, vertices=vertices)
    kill_at = 1500
    resubmits = {"n": 0}

    def issue(cid, idx, done):
        if idx == kill_at:                      # mid-serve shard failure
            w.kill("shard2")
            print(f"!! killed shard2 at request {idx} "
                  f"(epoch bumps; backup recovers from the backing store; "
                  f"in-flight programs are RESUBMITTED by the client, "
                  f"§4.3)")
        op = ops[idx % len(ops)]
        t0 = w.sim.now
        state = {"done": False}

        def _done(*_):
            if not state["done"]:
                state["done"] = True
                done(w.sim.now - t0)

        def attempt():
            if state["done"]:
                return
            if op["type"] in ("get_edges", "count_edges", "get_node"):
                w.submit_program(op["type"], [(op["v"], None)],
                                 lambda r, s, l: _done())
            else:
                tx = w.begin_tx()
                if op["type"] == "create_edge":
                    tx.create_edge(op["v"], op["u"])
                else:
                    v = w.read_vertex(op["v"])
                    if v and v["edges"]:
                        tx.delete_edge(op["v"], next(iter(v["edges"])))
                    else:
                        tx.set_vertex_prop(op["v"], "touch", idx)
                w.submit_tx(tx, lambda r: _done())

            # client-side timeout + resubmission with a fresh timestamp
            def retry():
                if not state["done"]:
                    resubmits["n"] += 1
                    attempt()
            w.sim.schedule(0.08, retry)

        attempt()

    drv = ClosedLoopDriver(w.sim, n_clients=48, n_requests=3000, issue=issue)
    res = drv.run(timeout=120.0)
    print(f"served {res['completed']} requests at "
          f"{res['throughput_per_s']:,.0f} req/s (simulated)")
    print(f"latency p50={res['p50_ms']:.2f}ms p99={res['p99_ms']:.2f}ms")
    print(f"epoch after failure: {w.manager.epoch} "
          f"(failures handled: {w.manager.failures_handled}, "
          f"client resubmissions: {resubmits['n']})")
    c = w.counters()
    print(f"oracle calls {c['oracle_calls']}, announces "
          f"{c['announce_messages']}, committed {c['tx_committed']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
