"""Mesh factories and a local launcher for ranks on one host.

A mesh needs the process group up first (one process per rank:
``torch.distributed.init_process_group`` with an address, the world size
and the rank, as ``torchrun`` or :func:`run_local` gives them).  Single
pod: (data=16, model=16) = 256 ranks.  Multi-pod: (pod=2, data=16,
model=16) = 512 ranks; the 'pod' axis is pure data parallelism whose
gradient all-reduce crosses the slow link once per step.
:func:`make_columns_mesh` is the exception: the column plane is one
process driving a list of devices, so it needs no process group.
"""

from __future__ import annotations

import datetime
import math
import os
import tempfile

import torch

from repro_torch import dist


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    import torch.distributed as tdist
    world = tdist.get_world_size() if tdist.is_initialized() else 0
    if world != n:
        raise RuntimeError(
            f"mesh {shape} needs a world of {n} ranks but the process "
            f"group has {world} — launch {n} processes (one per rank), or "
            f"for a dry run in one process init the 'fake' backend with "
            f"world_size={n}")
    return dist.make_mesh(shape, axes)


def make_smoke_mesh(shape=(1, 1), axes=("data", "model")):
    """1-rank mesh for smoke tests of the sharded step functions (the
    process group must have one rank)."""
    return dist.make_mesh(shape, axes)


def _plane_device(d) -> torch.device:
    """``d`` as a device the column plane can hold blocks on: the CPU, or
    a card that is present, with its index.  Raises otherwise; it never
    falls back to another device."""
    dev = torch.device(d)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"the column plane runs on cuda or cpu, got {dev}")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have == 0:
        raise RuntimeError(f"device={str(dev)!r} needs a CUDA device and "
                           f'none is available; pass device="cpu" to run '
                           f"on the CPU")
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    if idx >= have:
        raise RuntimeError(f"the column plane's device {dev} is not present "
                           f"({have} card(s))")
    return torch.device("cuda", idx)


def make_columns_mesh(n_devices=None, device="cuda"):
    """The device list of the device-resident column plane
    (``repro_torch.dist.columns``), the counterpart of the reference's
    1-D ``("data",)`` mesh over the local devices.

    ``"cuda"``: every visible card, or the first ``n_devices``; a card
    named with its index (``"cuda:1"``) is that card alone.  Raises when
    no card is present or more are asked for than are present; it never
    falls back to the CPU.  ``"cpu"``: ``n_devices`` entries of the CPU
    device (default 1), standing in for the reference's forced host
    devices.  No process group is involved: one process drives every
    device, as the reference's plane does."""
    if n_devices is not None and int(n_devices) < 1:
        raise ValueError(f"n_devices must be at least 1, got {n_devices}")
    dev = torch.device(device)
    if dev.type == "cpu":
        return [dev] * (1 if n_devices is None else int(n_devices))
    if dev.index is not None:
        if n_devices not in (None, 1):
            raise RuntimeError(f"{dev} is one card, not n_devices="
                               f"{n_devices}")
        return [_plane_device(dev)]
    _plane_device(torch.device(dev.type, 0))     # raises without a card
    have = torch.cuda.device_count()
    n = have if n_devices is None else int(n_devices)
    if n > have:
        raise RuntimeError(f"the column plane asks for {n} cards but "
                           f"{have} are present")
    return [torch.device("cuda", i) for i in range(n)]


def columns_devices(devices=None) -> list:
    """The column plane's device list: :func:`make_columns_mesh`'s (every
    card) for ``None``, else ``devices`` as torch devices, each card with
    its index; raises for a card that is not present.  A device may be
    listed more than once."""
    if devices is None:
        return make_columns_mesh()
    out = [_plane_device(d) for d in devices]
    if not out:
        raise ValueError("the column plane needs at least one device")
    return out


def _rank_main(rank, fn, world, backend, out_dir, timeout_s):
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    args = torch.load(os.path.join(out_dir, "args.pt"), weights_only=False)
    import torch.distributed as tdist
    tdist.init_process_group(
        backend, init_method="file://" + os.path.join(out_dir, "store"),
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        result = fn(rank, world, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.set_mesh(None)
        tdist.destroy_process_group()


def run_local(fn, world: int, backend: str, args=(), timeout_s=600):
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes on
    this host, each with an initialised process group of ``backend``
    (rendezvous through a file in a fresh temporary directory, so no
    port is shared with other launches on the host), and return the
    ranks' results in rank order.  ``fn`` must be importable by its module path.  If a
    rank fails, the others are stopped and the error is raised here;
    a collective waits at most ``timeout_s``.  ``args`` go to the ranks
    through a file: a spawned child reads its pipe only after importing
    the main module, so large arguments on the pipe would start the
    ranks one after another."""
    import torch.multiprocessing as tmp
    with tempfile.TemporaryDirectory() as out_dir:
        torch.save(tuple(args), os.path.join(out_dir, "args.pt"))
        tmp.start_processes(
            _rank_main, args=(fn, world, backend, out_dir, timeout_s),
            nprocs=world, join=True, start_method="spawn")
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
