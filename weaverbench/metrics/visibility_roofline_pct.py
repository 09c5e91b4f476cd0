"""The visibility passes' least bytes (``work_mv.visibility_least_bytes``:
both stamp rows of every row read, one bit a row written) at the card's
peak HBM bandwidth, over the device time of the ``mv_visibility``
kernel's residue mode (``visibility_residue_kernel``) in the traced
window, in %."""

from weaverbench import work, work_mv

KERNEL = "visibility_residue_kernel"


def read(run):
    peak = work.HBM_BYTES_PER_S.get(run.device_name)
    if (peak is None or run.trace is None
            or any("visibility_bytes" not in w for w in run.work)):
        return None
    secs = work_mv.kernel_seconds(run.trace, KERNEL)
    if not secs:
        return None
    return 100.0 * sum(w["visibility_bytes"] for w in run.work) / peak / secs
