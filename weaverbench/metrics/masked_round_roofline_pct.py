"""The masked BFS rounds' least bytes (``work_mv.masked_round_least_bytes``:
8 bytes of ends and one visibility bit a row a round) at the card's peak
HBM bandwidth, over the device time of the masked relax kernel
(``masked_relax_kernel``) in the traced window, in %."""

from weaverbench import work, work_mv

KERNEL = "masked_relax_kernel"


def read(run):
    peak = work.HBM_BYTES_PER_S.get(run.device_name)
    if (peak is None or run.trace is None
            or any("masked_round_bytes" not in w for w in run.work)):
        return None
    secs = work_mv.kernel_seconds(run.trace, KERNEL)
    if not secs:
        return None
    return (100.0 * sum(w["masked_round_bytes"] for w in run.work) / peak
            / secs)
