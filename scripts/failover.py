#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 3e alone on the cards of this host, at
the sizes the whole script gives it (``chip_smoke.run_phase_3e``): the
paper deployment's layout with the column plane over every card, run A
(replicas, pods, read windows, tracing, change-feed faults, two replica
promotions) and run B (WAL recovery under a torn tail, a gatekeeper and
two shard crashes, a burst of transactions), each against the same
stream on the CPU with the plane off in a worker process.  Prints each
card's name and power limit first; exits non-zero on any failure.  From
the root of a checkout, on a host with a card:

    python3 scripts/failover.py
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("failover: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=index,name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    # the phase's kernels built first, as the whole script builds them,
    # so that run A's seconds hold no compile
    chip_smoke.build.build("mv_visibility")
    print(f"failover: kernels built in {time.perf_counter() - t0:.2f} s",
          flush=True)
    t0 = time.perf_counter()
    chip_smoke.run_phase_3e()
    print(f"failover: {time.perf_counter() - t0:.2f} s host wall clock",
          flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except chip_smoke.PhaseError as e:
        print(f"failover: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
