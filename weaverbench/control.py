"""Readings behind the check's limits, on the card at a cell's own size:
the numbers the check compares for the program on many seeds, and for
the control in the program's place (``Query.control`` of
``kinds/<query>.py``) on others, in one process.  Each run is the cell's
own run cut to as many queries as the check compares, so every answer is
compared.

    python3 weaverbench/control.py --workload urand_s22.pagerank \\
        --seeds 101 102 103 --control-seeds 201 202 203

Prints one JSON line a run: the seed, which side ran, ``correct`` and the
numbers compared.  The benchmark's own runs do not run the control.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args()
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from weaverbench import harness
    queries = harness.load_cell(ROOT, args.workload).traffic["check_queries"]
    t0 = time.perf_counter()
    runs = [("program", s) for s in args.seeds]
    runs += [("control", s) for s in args.control_seeds]
    for impl, seed in runs:
        r = harness.run(ROOT, args.workload, seed, float("inf"), False,
                        "cuda:0", lambda: time.perf_counter() - t0,
                        impl=impl, max_queries=queries)
        print(json.dumps({"workload": args.workload, "side": impl,
                          "seed": seed, "correct": r["correct"],
                          "check": r["check"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
