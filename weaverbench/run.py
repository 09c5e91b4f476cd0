"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 weaverbench/run.py --workload <cell> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

Run from the root of a checkout.  The last line of standard output is the
result (JSON); the numbers the check compared, each beside its limit,
are the last lines of standard error.  Exits non-zero, with no result,
without a CUDA device, or if ``jax``, ``jaxlib``, ``flax`` or ``repro``
was loaded.
"""

import os
import time


def _process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    return (time.clock_gettime(time.CLOCK_BOOTTIME)
            - start_ticks / os.sysconf("SC_CLK_TCK"))


AGE0, T0 = _process_age_s(), time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    # build and kernel caches at fixed paths inside the checkout
    cache = ROOT / ".weaverbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    sys.path[0] = str(ROOT)     # not this folder: its names are not top-level
    sys.path.insert(1, str(ROOT / "src"))

    import torch
    torch.set_num_threads(1)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = next((w["chips"] for w in bench["workloads"]
                  if w["name"] == args.workload), 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    from weaverbench import harness
    result = harness.run(
        ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
        "cuda:0", lambda: AGE0 + time.perf_counter() - T0)
    leaked = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if leaked:
        print(f"loaded {', '.join(leaked)}: the benchmark runs the port "
              "alone", file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
