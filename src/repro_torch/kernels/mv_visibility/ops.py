"""Public wrappers of the stamp-compare kernels.

They take the ``(N, C)`` row-major int32 layout that
``repro_torch.core.clock.pack_many`` and the partition columns hold.  A
CUDA tensor goes to the CUDA kernel (which launches or raises); a CPU
tensor goes to the plain PyTorch version in :mod:`.ref`.  Nothing else
chooses the route: the caller picks it by where its tensors live.

The host entries (:func:`before_host`, :func:`before_pairs_host`,
:func:`visibility_host`) take numpy rows and return a numpy mask; the
caller's ``device`` string picks the route: ``"cpu"`` runs the plain
version, a CUDA device the kernel's one-round-trip host entry
(``kernel.before_host`` and its siblings).
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernel, ref


def _on_cpu(t: torch.Tensor) -> bool:
    return isinstance(t, torch.Tensor) and t.device.type == "cpu"


def before_mask(rows: torch.Tensor, q: torch.Tensor,
                bits: bool = False) -> torch.Tensor:
    """(N, C) stamp rows + (C,) query -> (N,) bool ``row ≺ q`` mask, or
    with ``bits`` its (ceil(N / 32),) int32 words (bit k = row k, least
    significant bit first)."""
    if _on_cpu(rows):
        kernel.check((rows,), q, per_row=False)
        mask = ref.before(rows, q)
        return ref.pack_bits(mask) if bits else mask
    return kernel.before(rows, q, bits=bits)


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


def _plain_host(plain, tables, q: np.ndarray, per_row: bool) -> np.ndarray:
    kernel.check_host(tables, q, per_row)
    return plain(*(torch.from_numpy(np.ascontiguousarray(a, np.int32))
                   for a in (*tables, q))).numpy()


def before_host(rows: np.ndarray, q: np.ndarray, device: str) -> np.ndarray:
    """(N, C) host stamp rows + (C,) query -> (N,) numpy bool ``row ≺ q``
    on ``device``."""
    if torch.device(device).type == "cpu":
        return _plain_host(ref.before, (rows,), q, per_row=False)
    return kernel.before_host(rows, q, device)


def before_pairs_host(rows: np.ndarray, qs: np.ndarray,
                      device: str) -> np.ndarray:
    """(N, C) host rows + (N, C) per-row queries -> (N,) numpy bool
    ``rows[i] ≺ qs[i]`` on ``device``."""
    if torch.device(device).type == "cpu":
        return _plain_host(ref.before_pairs, (rows,), qs, per_row=True)
    return kernel.before_pairs_host(rows, qs, device)


def visibility_host(create: np.ndarray, delete: np.ndarray, q: np.ndarray,
                    device: str) -> np.ndarray:
    """(N, C) host create/delete rows + (C,) query -> (N,) numpy bool
    visibility on ``device``."""
    if torch.device(device).type == "cpu":
        return _plain_host(ref.visibility, (create, delete), q,
                           per_row=False)
    return kernel.visibility_host(create, delete, q, device)
