"""``device_idle_pct`` (``metrics/device_idle_pct.py``) read on ``urand_s22.pagerank``, the
cell its accepted entry does not list."""

from weaverbench.metrics.device_idle_pct import read  # noqa: F401
