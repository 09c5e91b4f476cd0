"""Plain PyTorch versions of the multi-version visibility kernels.

Stamp rows are ``[epoch, c_0..c_{G-1}]`` int32 in the ``(N, C)``
row-major layout the partitions hold; a row whose epoch is INT32_MAX
means "no stamp" (never deleted).  Visible at q  <=>  create ≺ q  and
not (delete ≺ q), with ``≺`` the epoch-then-vector-clock happens-before
(see ``repro_torch.core.clock``).  These are what the CPU path runs and
what the CUDA kernels are held against on the card.
"""

from __future__ import annotations

import torch

NO_STAMP = 2**31 - 1


def before_pairs(rows: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """``rows[i] ≺ qs[i]``: (N, C) int32 against (N, C) or (1, C) -> (N,)
    bool."""
    is_no = rows[:, 0] == NO_STAMP
    lower = rows[:, 0] < qs[:, 0]
    same = rows[:, 0] == qs[:, 0]
    le = (rows[:, 1:] <= qs[:, 1:]).all(dim=1)
    eq = (rows[:, 1:] == qs[:, 1:]).all(dim=1)
    return ~is_no & (lower | (same & le & ~eq))


def before(rows: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``rows[i] ≺ q``: (N, C) int32, q (C,) int32 -> (N,) bool."""
    return before_pairs(rows, q.unsqueeze(0))


def visibility(create: torch.Tensor, delete: torch.Tensor,
               q: torch.Tensor) -> torch.Tensor:
    """create/delete (N, C) int32, q (C,) int32 -> (N,) bool."""
    return before(create, q) & ~before(delete, q)
