"""The queries' least bytes (``work.pagerank_least_bytes``) at the card's
peak HBM bandwidth, over their device time in the traced window, in %."""

from weaverbench import work


def read(run):
    peak = work.HBM_BYTES_PER_S.get(run.device_name)
    if (peak is None or run.trace is None or not run.trace.query_device_s
            or any("least_bytes" not in w for w in run.work)):
        return None
    least = sum(w["least_bytes"] for w in run.work)
    return 100.0 * least / peak / run.trace.query_device_s
