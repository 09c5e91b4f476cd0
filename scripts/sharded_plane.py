#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 3d alone on the cards of this host, at
the sizes the whole script gives it (``chip_smoke.run_phase_3d``): the
column plane sharded over device lists (every card, ``cuda:0`` listed 2
and 4 times, and 2 and 4 real cards where present) at SNAP
soc-LiveJournal1's size, held to the plain ``before`` and timed, then the
paper deployment's layout with the plane over 4 entries against the plane
off.  Prints each card's name and power limit first; exits non-zero on
any failure.  From the root of a checkout, on a host with a card:

    python3 scripts/sharded_plane.py
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("sharded_plane: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=index,name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    chip_smoke.run_phase_3d()
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except chip_smoke.PhaseError as e:
        print(f"sharded_plane: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
