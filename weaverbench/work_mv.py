"""The yardstick's counts for the multi-version cells (``bfs_at``): the
least bytes of a query's visibility pass and of its masked rounds, from
the query's inputs alone (the rows the table holds, the stamp width,
the rounds its answer implies), and the device time of one kernel by
name in a traced window."""

from __future__ import annotations

from weaverbench.work import INDEX_BYTES

STAMP_WORD_BYTES = 4    # an int32 word of a packed stamp row


def bit_bytes(rows: int) -> int:
    """One bit a row, in whole bytes."""
    return -(-rows // 8)


def visibility_least_bytes(rows: int, c: int) -> int:
    """The visibility pass reads each row's create and delete stamps (C
    int32 words each; every word can decide a row whose epoch ties the
    query's) and writes one bit a row."""
    return rows * 2 * c * STAMP_WORD_BYTES + bit_bytes(rows)


def masked_round_least_bytes(rows: int, rounds):
    """A masked round reads each row's two ends and its visibility bit;
    ``rounds`` may be a 0-d tensor (read after the window)."""
    return rounds * (rows * 2 * INDEX_BYTES + bit_bytes(rows))


def kernel_seconds(trace, name: str) -> float:
    """Device seconds of the kernels whose name holds ``name`` among the
    traced window's operations (``devtrace.Summary.device_ops``, the
    longest ten by name); 0 where none is there."""
    return sum(s for op, s in trace.device_ops if name in op)
