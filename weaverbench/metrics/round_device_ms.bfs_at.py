"""``round_device_ms`` (``metrics/round_device_ms.py``) read on ``urand_s22_mv4.bfs_at``, the
cell its accepted entry does not list."""

from weaverbench.metrics.round_device_ms import read  # noqa: F401
