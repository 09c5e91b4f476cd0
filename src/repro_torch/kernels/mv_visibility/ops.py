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

:func:`visibility_residue` keeps the bits on the tensors' device and
lists the rows whose stamps are concurrent with the query (the residue a
query refines through the timeline oracle); :func:`read_residue` brings
that list to the host in one copy.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import kernel, ref

#: entries of the residue list a card keeps room for at first (it grows
#: when a launch overflows it)
RESIDUE_CAP = 4096
#: entries read with the count in :func:`read_residue`'s one copy
RESIDUE_READ = 1024

_residue: Dict[torch.device, torch.Tensor] = {}


class ResidueOverflow(Exception):
    """The residue had more rows than the list held; ``count`` says how
    many."""

    def __init__(self, count: int):
        super().__init__(f"{count} concurrent rows overflow the residue "
                         f"list")
        self.count = count


def residue_buffer(device, need: int = RESIDUE_CAP) -> torch.Tensor:
    """The residue list on ``device``: an int64 tensor of ``1 + cap``
    entries, made at first use and grown (doubling) to hold ``need``."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    buf = _residue.get(dev)
    if buf is None or buf.numel() - 1 < need:
        cap = max(need, 2 * (buf.numel() - 1) if buf is not None else 0,
                  RESIDUE_CAP)
        buf = _residue[dev] = torch.empty(1 + cap, dtype=torch.int64,
                                          device=dev)
    return buf


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


def visibility_residue(create_rows: torch.Tensor, delete_rows: torch.Tensor,
                       q: torch.Tensor, res: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(bits, res)``: the (ceil(N / 32),) int32 visibility words, and
    the residue list ``res`` (int64: the count of rows whose create or
    delete stamp is concurrent with q, then their entries ``row <<
    kernel.FLAG_BITS | flags``), both on the rows' device.  On a card one
    launch of the residue mode into ``res`` (default
    :func:`residue_buffer`); on the CPU the plain version, with ``res``
    made to fit."""
    if _on_cpu(create_rows):
        kernel.check((create_rows, delete_rows), q, per_row=False)
        bits, entries = ref.visibility_residue(create_rows, delete_rows, q)
        count = torch.tensor([entries.numel()], dtype=torch.int64)
        return bits, torch.cat([count, entries])
    if res is None:
        res = residue_buffer(create_rows.device)
    return kernel.visibility_residue(create_rows, delete_rows, q, res), res


def read_residue(res: torch.Tensor, prefix: int = RESIDUE_READ
                 ) -> np.ndarray:
    """The residue list's entries on the host, sorted (so by row): one
    device-to-host copy of the count and the first ``prefix`` entries,
    and a second one only for entries beyond them.  Raises
    :class:`ResidueOverflow` where the launch counted more rows than
    ``res`` holds."""
    head = res[:1 + min(prefix, res.numel() - 1)].cpu().numpy()
    count = int(head[0])
    if count > res.numel() - 1:
        raise ResidueOverflow(count)
    if count < head.size:
        entries = head[1:1 + count]
    else:
        entries = np.concatenate([head[1:],
                                  res[head.size:1 + count].cpu().numpy()])
    return np.sort(entries)


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
