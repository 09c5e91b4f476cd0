"""``launches_per_round`` (``metrics/launches_per_round.py``) read on ``urand_s22.pagerank``, the
cell its accepted entry does not list."""

from weaverbench.metrics.launches_per_round import read  # noqa: F401
