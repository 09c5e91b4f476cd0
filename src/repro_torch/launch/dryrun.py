"""Multi-pod dry run on fake tensors: for every (arch x shape x mesh)
cell, one step of the port on each rank's share of it, counted by
``launch/hlo_cost`` (FLOPs, bytes, collective bytes) with roofline terms
for an NVIDIA H100 — the reference's ``launch/dryrun.py``, which
compiles each cell on 256 or 512 forced host devices.

The mesh is ``launch/mesh.make_production_mesh`` on the fake process
group (``torch.testing._internal.distributed.fake_pg``, world 256 or 512)
in one process: this process is rank 0, every collective returns at
once, and the arguments are fake tensors (``launch/input_specs``), so a
cell allocates nothing and needs no card.

What a cell counts is what the port runs on one rank: the dense parts
and the activations whole (the port keeps them whole on every rank), the
experts' and the split-K cache's blocks where a variant shards them, and
``dist.counts`` for the wire.  ``useful_flops_fraction`` (the model's
FLOPs over the FLOPs every rank runs) therefore shows the port's
redundancy: a dense cell on 256 ranks reads ~1/256.  There is no
``memory_analysis()``: ``memory`` gives the argument and output bytes of
the fake tensors, ``temp_bytes`` and ``alias_bytes`` are null, and the
peak estimate counts only the arguments and the outputs that are not
arguments.

The fake tensors lie on the card by default; ``--device cpu`` puts them
on the CPU, which a PyTorch built without CUDA needs (its indexing
refuses even a fake CUDA tensor).  The counts are the same on either
(gemma3-1b's train step at 8 x 4,096: the same FLOPs and bytes, and the
same bytes op by op at 2 layers, on an H100 and with CPU fake tensors).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b \\
      --shape long_500k --mesh single --variant window_cache
Results accumulate under
results/dryrun_torch/<arch>__<shape>__<mesh>__<variant>.json
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

# NVIDIA H100 SXM (NVIDIA's data sheet): dense bf16 tensor-core rate, HBM3
# rate, and NVLink 4's 900 GB/s per card counted both ways, 450 GB/s each
PEAK_FLOPS = 989e12          # bf16 FLOP/s per card
HBM_BW = 3.35e12             # bytes/s per card
NVLINK_BW = 450e9            # bytes/s per card, one direction


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   coll_bytes_per_dev: float) -> dict:
    tc = flops_per_dev / PEAK_FLOPS
    tm = bytes_per_dev / HBM_BW
    tn = coll_bytes_per_dev / NVLINK_BW
    dom = max((tc, "compute"), (tm, "memory"), (tn, "collective"))[1]
    return {"compute_s": tc, "memory_s": tm, "collective_s": tn,
            "dominant": dom,
            "step_s_lower_bound": max(tc, tm, tn)}


@contextlib.contextmanager
def fake_world(n: int):
    """A fake process group of ``n`` ranks (this process is rank 0) for
    the duration."""
    import torch.distributed as tdist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    tdist.init_process_group("fake", store=FakeStore(), rank=0,
                             world_size=n)
    try:
        yield
    finally:
        tdist.destroy_process_group()


def _tensors(tree):
    """The tensors in ``tree`` (dicts, lists, tuples, modules'
    parameters)."""
    if isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def tensor_bytes(tree, skip=()) -> int:
    """Bytes of the tensors in ``tree``, each storage once, leaving out
    the tensors whose storages are those of ``skip``'s tensors."""
    seen = {t.untyped_storage()._cdata for t in _tensors(skip)}
    total = 0
    for t in _tensors(tree):
        key = t.untyped_storage()._cdata
        if key not in seen:
            seen.add(key)
            total += t.numel() * t.element_size()
    return total


def count_cell(low, n_chips: int) -> dict:
    """Run one :class:`input_specs.Lowerable` under the counters: the
    cell's memory, cost, collectives, roofline and FLOP fractions."""
    from repro_torch.launch import hlo_cost
    t0 = time.time()
    rep, out, sent = hlo_cost.count(low.fn, *low.args)
    arg_b = tensor_bytes(low.args)
    out_b = tensor_bytes(out)
    fresh_b = tensor_bytes(out, skip=low.args)
    flops = rep.flops
    terms = roofline_terms(flops, rep.bytes_accessed,
                           rep.total_collective_bytes)
    model_flops = low.meta.get("model_flops", 0.0)
    return {
        "count_s": round(time.time() - t0, 2),
        "memory": {
            "argument_bytes": arg_b,
            "output_bytes": out_b,
            "temp_bytes": None,
            "alias_bytes": None,
            "peak_estimate_bytes": arg_b + fresh_b,
            "peak_estimate_note": "arguments + outputs that are not "
                                  "arguments; temporaries not counted",
        },
        "cost": {"flops_per_device": flops,
                 "bytes_accessed_per_device": rep.bytes_accessed},
        "collectives": {"bytes": rep.collective_bytes,
                        "counts": rep.collective_counts,
                        "total_bytes": rep.total_collective_bytes,
                        "while_trips": rep.while_trips,
                        "by_op": sent},
        "roofline": terms,
        "model_flops": model_flops,
        "useful_flops_fraction": model_flops / max(flops * n_chips, 1.0),
    }


def count_on_mesh(shape, axes, build) -> dict:
    """:func:`count_cell` of ``build(mesh)`` (a ``Lowerable``) on a mesh
    of ``shape`` over a fake world of its size, the mesh installed while
    the cell is built and run: a cell of any config and size (with its
    ``meta``)."""
    from repro_torch import dist
    n = int(np.prod(shape))
    with fake_world(n):
        mesh = dist.make_mesh(shape, axes)
        dist.set_mesh(mesh)
        try:
            low = build(mesh)
            return dict(count_cell(low, n), meta=low.meta)
        finally:
            dist.set_mesh(None)


def run_cell(arch: str, shape: str, mesh_kind: str, variant: str,
             outdir: Path, device: str = "cuda") -> dict:
    from repro_torch import dist
    from repro_torch.configs import get_arch
    from repro_torch.launch import input_specs
    from repro_torch.launch.mesh import make_production_mesh

    spec = get_arch(arch)
    sh = spec.shapes[shape]
    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
           "variant": variant, "status": "ok", "device": device}
    if sh.skip:
        rec["status"] = "skipped"
        rec["skip_reason"] = sh.skip
        return rec
    t0 = time.time()
    multi = mesh_kind == "multi"
    with fake_world(512 if multi else 256):
        mesh = make_production_mesh(multi_pod=multi)
        n_chips = int(np.prod(list(mesh.shape.values())))
        dist.set_mesh(mesh)
        try:
            low = input_specs.build(arch, shape, mesh, variant, device)
            t_build = time.time() - t0
            rec.update(n_chips=n_chips, build_s=round(t_build, 2),
                       **count_cell(low, n_chips), meta=low.meta)
        finally:
            dist.set_mesh(None)
    outdir.mkdir(parents=True, exist_ok=True)
    fn = outdir / f"{arch}__{shape}__{mesh_kind}__{variant}.json"
    fn.write_text(json.dumps(rec, indent=1, default=str))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi",
                                                       "both"])
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--outdir", default="results/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="device of the fake tensors: the card by default; "
                    "cpu on a PyTorch built without CUDA (the counts are "
                    "the same; nothing runs on either)")
    args = ap.parse_args(argv)

    from repro_torch.configs import ARCHS

    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]
    outdir = Path(args.outdir)
    cells = []
    for aid, spec in ARCHS.items():
        if args.arch and aid != args.arch:
            continue
        for sname in spec.shapes:
            if args.shape and sname != args.shape:
                continue
            for mk in meshes:
                cells.append((aid, sname, mk))

    failures = 0
    for aid, sname, mk in cells:
        tag = f"{aid}/{sname}/{mk}/{args.variant}"
        fn = outdir / f"{aid}__{sname}__{mk}__{args.variant}.json"
        if args.skip_existing and fn.exists():
            prev = json.loads(fn.read_text())
            if prev.get("status") in ("ok", "skipped"):
                print(f"[skip-existing] {tag}")
                continue
        t0 = time.time()
        try:
            rec = run_cell(aid, sname, mk, args.variant, outdir,
                           args.device)
            if rec["status"] == "skipped":
                print(f"[SKIP] {tag}: {rec['skip_reason']}")
                outdir.mkdir(parents=True, exist_ok=True)
                fn.write_text(json.dumps(rec, indent=1))
            else:
                r = rec["roofline"]
                peak = rec["memory"]["peak_estimate_bytes"] / 2 ** 30
                print(f"[ok] {tag}: {time.time() - t0:.2f}s "
                      f"flops/dev {rec['cost']['flops_per_device']:.3e} "
                      f"dom={r['dominant']} peak_mem {peak:.2f} GiB")
        except Exception as e:
            failures += 1
            print(f"[FAIL] {tag}: {type(e).__name__}: {e}")
            traceback.print_exc(limit=4)
            outdir.mkdir(parents=True, exist_ok=True)
            fn.write_text(json.dumps(
                {"arch": aid, "shape": sname, "mesh": mk,
                 "variant": args.variant, "status": "fail",
                 "error": f"{type(e).__name__}: {e}"}, indent=1))
        sys.stdout.flush()
    print(f"done: {len(cells)} cells, {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
