#!/usr/bin/env python3
"""Hold chip_smoke.py's phase-2 stamp-compare checks to broken copies of
``src/repro_torch/csrc/mv_visibility.cu``, on one NVIDIA card.

Each mutant is the source with one fault written in (a text
replacement), built with nvcc into a temporary directory (the checkout
is not touched; ``gather_mutants.build_variant``) and bound in place of
the stamp-compare library.  For the unbroken kernels (the control) and
each mutant, a process of its own runs phase 2's checks
(``chip_smoke.stamp_edge_cases``: both output forms of ``before``,
``before_pairs`` and ``visibility`` and their three host entries against
their plain versions at C in (3, 9), N in ``STAMP_NS`` and the full size,
and the unaligned views).  A process of its own, because a fault on the
card (a misaligned load, or the kernel's trap when a slot's bytes never
all arrive) ends the process's CUDA context: the checks it did not reach
count as failed.

The script prints each variant's failing checks and exits 0 only when
the control passes every check and every mutant fails at least one.

Run from the root of a checkout: ``python3 scripts/stamp_mutants.py
[--kernel-n N] [--out file.json]``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke as cs  # noqa: E402
from gather_mutants import build_variant  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.mv_visibility import kernel as mvk  # noqa: E402

TAIL = "const bool p = r < rem &&"
BALLOT = "word[j] = __ballot_sync(0xffffffffu, p);"
TIED_LE = "le &= row[j] <= q[j];"
VEC = ("const bool vec = aligned16(rows) && (kTables == 1 || "
       "aligned16(other));")
DELETE = "&& !staged_before<kC>(row2, q, c);"
EXPECT = "hopper::mbar_expect_tx(bar + slot, kTables * bytes);"

# name -> (text of csrc/mv_visibility.cu, its replacement)
MUTANTS = {
    "tail mask off by one (the row past the end evaluated)": (
        TAIL, "const bool p = r <= rem &&"),
    "last row of each tile dropped": (
        TAIL, "const bool p = r < rem && r != kTile - 1 &&"),
    "ballot bit order reversed": (
        BALLOT, "word[j] = __brev(__ballot_sync(0xffffffffu, p));"),
    "<= taken as < on a tied epoch": (TIED_LE, "le &= row[j] < q[j];"),
    "unaligned rows take the 16-byte loads": (VEC, "const bool vec = true;"),
    "visibility: the delete tile read from the create tile's region": (
        DELETE, "&& !staged_before<kC>(row, q, c);"),
    "visibility: && ! taken as &&": (
        DELETE, "&& staged_before<kC>(row2, q, c);"),
    "visibility: the delete copy left out of the slot's expected bytes": (
        EXPECT, "hopper::mbar_expect_tx(bar + slot, (kMode == "
                "Mode::kVisibility ? 1 : kTables) * bytes);"),
}


def child(lib: str, seed: int, big_n: int) -> dict:
    """Phase 2's stamp checks with ``lib`` bound (the built source when
    empty): check label -> rows or words that differ (-1: wrong dtype or
    shape); "error" holds the exception that stopped the run, if any."""
    if lib:
        mvk.bind(ctypes.CDLL(lib))
    out = {}
    try:
        for (n, c, off), _, checks in cs.stamp_edge_cases(seed, "cuda",
                                                          big_n):
            for label, bad in checks.items():
                out[f"{label} N={n} C={c} offset {off}"] = bad
    except Exception as e:                 # noqa: BLE001 - reported
        first = (str(e).strip().splitlines() or [""])[0]
        out["error"] = f"{type(e).__name__}: {first[:300]}"
    return out


def run_variant(lib: str, seed: int, big_n: int) -> dict:
    proc = subprocess.run(
        [sys.executable, __file__, "--child", lib, "--seed", str(seed),
         "--kernel-n", str(big_n)], capture_output=True, text=True,
        timeout=1800)
    lines = proc.stdout.strip().splitlines()
    try:
        return json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        return {"error": f"exit {proc.returncode}: "
                         f"{proc.stderr.strip()[-400:]}"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernel-n", type=int, default=cs.LIVEJOURNAL_EDGES)
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the results as JSON here")
    ap.add_argument("--child", default=None,
                    help="run one variant's checks in this process with "
                         "this library ('' for the built source)")
    args = ap.parse_args(argv)
    if args.child is not None:
        print(json.dumps(child(args.child, args.seed, args.kernel_n)))
        return 0
    if not torch.cuda.is_available():
        print("stamp_mutants: no CUDA device", file=sys.stderr)
        return 2
    print(f"device: {cs.smi_line()}", flush=True)
    original = (build.CSRC / f"{mvk.SOURCE}.cu").read_text()
    for name, (old, _) in MUTANTS.items():
        if original.count(old) != 1:
            raise SystemExit(f"mutant {name!r}: its text is not in "
                             f"{mvk.SOURCE}.cu exactly once")
    results, good = {}, True
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(len(MUTANTS) + 1) as ex:
            unbroken = ex.submit(build.build, mvk.SOURCE)
            paths = dict(zip(MUTANTS, ex.map(
                lambda item: build_variant(
                    original.replace(*item[1]), Path(tmp) / f"m{item[0]}.so"),
                enumerate(MUTANTS.values()))))
            unbroken.result()
        for name in ["control", *MUTANTS]:
            lib = "" if name == "control" else str(paths[name])
            r = run_variant(lib, args.seed, args.kernel_n)
            results[name] = r
            failed = [k for k, v in r.items() if k != "error" and v != 0]
            fails = bool(failed or "error" in r)
            good &= not fails if name == "control" else fails
            n_checks = len([k for k in r if k != "error"])
            print(f"{name}: {len(failed)} of {n_checks} checks reached "
                  f"fail{'; stopped by ' + r['error'] if 'error' in r else ''}",
                  flush=True)
            for k in failed[:12]:
                print(f"  FAIL {k}: {r[k]}", flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(results, indent=1))
    print(json.dumps({"ok": good}))
    return 0 if good else 1


if __name__ == "__main__":
    sys.exit(main())
