#!/usr/bin/env python3
"""Time chip_smoke.py's phase 3 (the main deployment: the card run, with
its CPU twin in a worker as chip_smoke runs it) and phase 3b (gin-tu on
the deployment's live snapshot) for two checkouts, in turns on one
NVIDIA card: A, B, B, A.

Each turn is a process of its own that imports ``chip_smoke.py`` from
its checkout, builds that checkout's kernels and runs the two phases at
chip_smoke's defaults, checks included.  The script prints the card line,
each turn's host seconds (the card run of phase 3, its CPU twin, phase
3b and phase 3b's own split), the card run's calls and seconds in each
stamp-compare entry point (``chip_smoke.BoundaryClock``, read from
``run_on``'s line) and, last, one JSON object of all turns.
Compare a change with its parent by unpacking the parent beside it
(``git archive``) into a directory that ``.gitignore`` lists.

Run from the root of a checkout:
``python3 scripts/ab_phase3.py A_ROOT B_ROOT [--out file.json]``.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

SEED, USERS, N_PROG, N_TX, GNN_STEPS = 0, 100_000, 50, 300, 12
TWIN = re.compile(r"^main device=cpu \(worker process, concurrent\): .* in "
                  r"([0-9.]+) s host wall clock")
ENTRY = re.compile(r"(\w+) (\d+) calls ([0-9.]+) s(?: \(median ([0-9.]+) us\))?")


def entry_points(line: str) -> dict:
    """``run_on``'s entry-point line -> {name: calls, seconds, median µs
    per call where the line has it}."""
    return {name: {"calls": int(calls), "s": float(secs),
                   "median_us": float(us) if us else None}
            for name, calls, secs, us in ENTRY.findall(line)}


def turn(root: Path) -> dict:
    """Phases 3 and 3b of the checkout at ``root``, in this process."""
    sys.path.insert(0, str(root))
    import torch
    import chip_smoke as cs

    card, entries = {}, {}
    run_on = cs.run_on

    def timed_run_on(device, *args):
        t0 = time.perf_counter()
        out = run_on(device, *args)
        card[device] = time.perf_counter() - t0
        entries[device] = entry_points(out[4])
        return out

    cs.run_on = timed_run_on
    cs.build.build_all()
    w = cs.deployment("main", SEED, USERS, plane=True, n_prog=N_PROG,
                      n_tx=N_TX, oracle=False, keep=True)[1]
    cs.smpk.reset_launches()
    t0 = time.perf_counter()
    gnn = cs.phase_gnn(w, SEED, GNN_STEPS)
    torch.cuda.synchronize()
    return {"root": str(root), "main_card_s": card["cuda"],
            "main_entry_points": entries["cuda"],
            "gnn_s": time.perf_counter() - t0, "gnn_secs": gnn["secs"],
            "gnn_launches": dict(cs.smpk.launches)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", type=Path, nargs="*")
    ap.add_argument("--turn", type=Path, default=None,
                    help="run one turn in this process (used by the script)")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if args.turn is not None:
        print(json.dumps(turn(args.turn.resolve())), flush=True)
        return 0
    if len(args.roots) != 2:
        ap.error("give two checkouts, A and B")
    import torch
    if not torch.cuda.is_available():
        print("ab_phase3: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"device: {smi}", flush=True)
    a, b = (r.resolve() for r in args.roots)
    turns = []
    for label, root in (("A", a), ("B", b), ("B", b), ("A", a)):
        proc = subprocess.run([sys.executable, __file__, "--turn", str(root)],
                              capture_output=True, text=True)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            print(f"ab_phase3: turn {label} ({root}) failed with exit "
                  f"{proc.returncode}", file=sys.stderr)
            return 1
        r = {"turn": label, **json.loads(lines[-1])}
        twin = [float(m.group(1)) for m in map(TWIN.match, lines) if m]
        r["main_twin_s"] = twin[0] if twin else None
        turns.append(r)
        print(f"turn {label} {root.name}: phase 3 card {r['main_card_s']:.2f}"
              f" s (CPU twin {r['main_twin_s']} s), phase 3b "
              f"{r['gnn_s']:.2f} s {r['gnn_secs']}, launches "
              f"{r['gnn_launches']}; phase 3 card entry points "
              f"{json.dumps(r['main_entry_points'])}", flush=True)
    out = {"device": smi, "turns": turns}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
