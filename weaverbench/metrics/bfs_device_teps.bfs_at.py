"""``bfs_device_teps`` (``metrics/bfs_device_teps.py``) read on ``urand_s22_mv4.bfs_at``, the
cell its accepted entry does not list."""

from weaverbench.metrics.bfs_device_teps import read  # noqa: F401
