"""Static cost of one step: the reference's ``launch/hlo_cost.py`` on the
port, which lowers no HLO.

:func:`analyze_fn` replaces the reference's ``analyze(hlo_text)``: it
runs the step once, eagerly, on fake tensors (``input_specs``: shapes
only, no memory, no card) and fills the same :class:`CostReport`:

* ``flops``: ``torch.utils.flop_counter.FlopCounterMode`` (2 * M * N * K
  per product, batched products and attention included); a layer that
  rematerialises counts its recomputed forward, as the reference's HLO
  does;
* ``bytes_accessed``: every op's input and output bytes
  (:class:`ByteCounter`), with the reference's rules: views and ops that
  move no data cost nothing, a gather or index reads only what it
  selects, a scatter touches only its update region (twice);
* ``collective_bytes`` / ``collective_counts``: ``dist.counts`` over the
  same run (the bytes each collective is handed on this rank, backward
  passes included), under the reference's five names.

Python's layer loop runs every layer, so the ``while`` bodies that the
reference multiplies by their trip counts do not arise: ``while_trips``
stays empty.  Counts are this rank's (the process group's rank, a fake
one in ``launch/dryrun``).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch import dist

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

#: the port's collective ops (``dist.counts``' keys) by reference name
_OP_NAMES = {"psum": "all-reduce", "pmax": "all-reduce",
             "all_gather": "all-gather", "psum_scatter": "reduce-scatter",
             "all_to_all": "all-to-all"}


@dataclass
class CostReport:
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: Dict[str, float] = field(default_factory=dict)
    collective_counts: Dict[str, float] = field(default_factory=dict)
    while_trips: Dict[str, int] = field(default_factory=dict)

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


def _nbytes(t) -> int:
    return t.numel() * t.element_size() \
        if isinstance(t, torch.Tensor) else 0


_aten = torch.ops.aten
# ops that allocate or relabel without reading or writing data
_FREE = {_aten.empty.memory_format, _aten.empty_strided.default,
         _aten.empty_like.default, _aten.new_empty.default,
         _aten.new_empty_strided.default, _aten.detach.default,
         _aten.lift_fresh.default, _aten._local_scalar_dense.default}
# gathers: read only the selected rows (as many as they write)
_GATHERS = {_aten.index.Tensor, _aten.gather.default,
            _aten.index_select.default, _aten.embedding.default}
# scatters: touch only the update region; value -> its argument index
_SCATTERS = {_aten.index_put.default: 2, _aten.index_put_.default: 2,
             _aten._index_put_impl_.default: 2,
             _aten.scatter.src: 3, _aten.scatter_.src: 3,
             _aten.scatter_add.default: 3, _aten.scatter_add_.default: 3,
             _aten.scatter_reduce.two: 3, _aten.scatter_reduce_.two: 3,
             _aten.index_add.default: 3, _aten.index_add_.default: 3,
             _aten.index_copy.default: 3, _aten.index_copy_.default: 3,
             _aten.slice_scatter.default: 1,
             _aten.select_scatter.default: 1}


def op_bytes(func, args, kwargs, out) -> int:
    """Bytes one op reads and writes (module docstring's rules)."""
    if func in _FREE or getattr(func, "is_view", False) \
            or getattr(func, "namespace", "") == "prim":    # metadata
        return 0
    out_b = sum(_nbytes(t) for t in tree_leaves(out))
    if func in _GATHERS:
        return 2 * out_b
    if func in _SCATTERS:
        i = _SCATTERS[func]
        upd = _nbytes(args[i]) if len(args) > i else out_b
        return 2 * min(upd, out_b)
    seen, in_b = set(), 0
    for t in tree_leaves((args, kwargs)):
        if isinstance(t, torch.Tensor) and id(t) not in seen:
            seen.add(id(t))
            in_b += _nbytes(t)
    return in_b + out_b


class ByteCounter(TorchDispatchMode):
    """Sums :func:`op_bytes` over every op dispatched under it."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.bytes += op_bytes(func, args, kwargs, out)
        return out


def collectives(sent: dict) -> Tuple[Dict[str, float], Dict[str, float]]:
    """``dist.counts``-shaped {op@axes: {calls, bytes}} -> (bytes, calls)
    under the reference's collective names."""
    nbytes = {c: 0.0 for c in COLLECTIVES}
    calls = {c: 0.0 for c in COLLECTIVES}
    for key, c in sent.items():
        name = _OP_NAMES[key.split("@")[0].split(".")[0]]
        nbytes[name] += c["bytes"]
        calls[name] += c["calls"]
    return nbytes, calls


def count(fn, *args):
    """Run ``fn(*args)`` once under the counters, inside the fake-tensor
    mode its arguments live in (if any): ``(CostReport, output, the
    collectives it ran as dist.counts)``."""
    from torch._guards import detect_fake_mode
    from torch.utils.flop_counter import FlopCounterMode

    mode = detect_fake_mode(args)
    before = dict(dist.counts)
    bc = ByteCounter()
    fc = FlopCounterMode(display=False)
    with (mode if mode is not None else contextlib.nullcontext()), fc, bc:
        out = fn(*args)
    sent = {}
    for key, c in dist.counts.items():
        b = before.get(key, {"calls": 0, "bytes": 0})
        if c != b:
            sent[key] = {"calls": c["calls"] - b["calls"],
                         "bytes": c["bytes"] - b["bytes"]}
    nbytes, calls = collectives(sent)
    rep = CostReport(flops=float(fc.get_total_flops()),
                     bytes_accessed=float(bc.bytes),
                     collective_bytes=nbytes, collective_counts=calls)
    return rep, out, sent


def analyze_fn(fn, *args) -> CostReport:
    """The :class:`CostReport` of one run of ``fn(*args)``."""
    return count(fn, *args)[0]

