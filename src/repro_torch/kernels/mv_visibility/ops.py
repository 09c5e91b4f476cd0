"""Public wrappers of the stamp-compare kernels.

They take the ``(N, C)`` row-major int32 layout that
``repro_torch.core.clock.pack_many`` and the partition columns hold.  A
CUDA tensor goes to the CUDA kernel (which launches or raises); a CPU
tensor goes to the plain PyTorch version in :mod:`.ref`.  Nothing else
chooses the route: the caller picks it by where its tensors live.
"""

from __future__ import annotations

import torch

from . import kernel, ref


def _on_cpu(t: torch.Tensor) -> bool:
    return isinstance(t, torch.Tensor) and t.device.type == "cpu"


def before_mask(rows: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(N, C) stamp rows + (C,) query -> (N,) bool ``row ≺ q`` mask."""
    if _on_cpu(rows):
        kernel.check((rows,), q, per_row=False)
        return ref.before(rows, q)
    return kernel.before(rows, q)


def visibility_mask(create_rows: torch.Tensor, delete_rows: torch.Tensor,
                    q: torch.Tensor) -> torch.Tensor:
    """(N, C) create/delete rows + (C,) query -> (N,) bool visibility."""
    if _on_cpu(create_rows):
        kernel.check((create_rows, delete_rows), q, per_row=False)
        return ref.visibility(create_rows, delete_rows, q)
    return kernel.visibility(create_rows, delete_rows, q)


def before_pairs(rows: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """(N, C) rows + (N, C) per-row queries -> (N,) bool ``rows[i] ≺
    qs[i]``."""
    if _on_cpu(rows):
        kernel.check((rows,), qs, per_row=True)
        return ref.before_pairs(rows, qs)
    return kernel.before_pairs(rows, qs)
