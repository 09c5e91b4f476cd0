"""``launches_per_round`` (``metrics/launches_per_round.py``) read on ``urand_s22_mv4.bfs_at``, the
cell its accepted entry does not list."""

from weaverbench.metrics.launches_per_round import read  # noqa: F401
