"""Benchmark of ``repro_torch``'s whole-graph analytics over live snapshots.

One run is one cell of ``BENCHMARK.json`` (a configuration under a traffic
mix)::

    python3 weaverbench/run.py --workload urand_s22.bfs --seed 7 \\
        --seconds 30 --trace 0

The run builds the configuration's graph on the card from the seed,
applies one write window to it before every query, calls the port's
traversal entry in a closed loop of one client for ``--seconds``, checks
a sample of the answers against the plain reference in
``weaverbench/reference`` and prints one JSON line.  Everything that
belongs to one configuration, traffic mix or metric is a file of its own,
found by the name ``BENCHMARK.json`` gives it:

* ``configs/<name>.json``: the deployment (generator and sizes);
* ``traffic/<name>.json``: the query mix (kind, parameters, write window);
* ``metrics/<name>.py``: a reader ``read(run) -> float | None``;
* ``generators/<name>.py``: ``build(cfg, seed, device) -> graphs.Graph``,
  named by a configuration's ``generator`` (and optionally its own
  ``LiveGraph``, the write window, in place of ``graphs.LiveGraph``);
* ``kinds/<name>.py``: a query kind's ``Query``, named by a traffic mix's
  ``query``.
"""
