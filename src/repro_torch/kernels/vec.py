"""Launch-shape rules of the gather kernels (``csrc/vec.cuh``, used by
``embedding_bag.cu`` and ``segment_mp.cu``): how wide each lane's load
is and how many lanes serve one row.  Pure functions of shapes and
addresses, so the CPU tests check them and a wrapper reads nothing back
from the card to pick them."""

from __future__ import annotations


def vec_bytes(row_bytes: int, elem_bytes: int, *ptrs: int) -> int:
    """Bytes per lane load: the widest of 16, 8 and 4 that divides the row
    stride in bytes and every pointer's address, else one element."""
    for v in (16, 8, 4):
        if row_bytes % v == 0 and all(p % v == 0 for p in ptrs):
            return v
    return elem_bytes


def group_lanes(n_vec: int) -> int:
    """Lanes serving one row: the power of two at or above the row's
    vector count, between 4 and 32 (wider rows take slices of 32)."""
    g = 4
    while g < min(n_vec, 32):
        g *= 2
    return g
