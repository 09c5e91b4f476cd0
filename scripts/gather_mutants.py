#!/usr/bin/env python3
"""Hold chip_smoke.py's embedding_bag and segment_mp checks to broken
copies of the two gather kernels, on one NVIDIA card.

Each mutant is ``src/repro_torch/csrc/embedding_bag.cu`` or
``segment_mp.cu`` with one fault written in, built with nvcc into a
temporary directory (the checkout is not touched) and bound in place of
that kernel's library, or (kind ``py``) a wrong rule patched into the
segment_mp wrapper.  For the unbroken kernels (the control) and each
mutant, the script runs:

* phase 2b's checks: every case of ``MP_CASES`` against the fp64 truth
  (``chip_smoke.mp_check``) and the gather order each launched against
  ``chip_smoke.mp_order``;
* phase 2d's checks: every case of ``BAG_CASES`` (``bag_check``) and the
  four full-size forms over sasrec's 1M-row table;
* phase 5 (``chip_smoke.phase_rec``, SASRec serving held against direct
  indexing) for the control and the mutants whose fault its one-index
  sum lookups reach.

Phase 3b is not run here: it needs the main deployment's live Weaver.
The script prints every failing check and exits 0 only when the control
passes every check and every mutant fails phase 2b or 2d and, where its
fault reaches phase 5, phase 5 too.

Run from the root of a checkout: ``python3 scripts/gather_mutants.py``.
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

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.embedding_bag import kernel as ebk  # noqa: E402
from repro_torch.kernels.embedding_bag import ops as ebops  # noqa: E402
from repro_torch.kernels.segment_mp import kernel as smpk  # noqa: E402

BAG_WT = "const float wt = s_w[j0 + u];"
BAG_FMA = "acc[e] = fmaf(rows[u].get(e), wt, acc[e]);"
BAG_MEAN = "if (kMean) wsum += wt;"
MP_ADD = "if (j0 + u < cnt && col_ok) {"
MP_CHUNK_END = "const int64_t hi = lo + chunk < end ? lo + chunk : end;"
MP_K_LOOP = "for (int k0 = 0; k0 < k; k0 += kBK) {"
MP_PARTIALS = "(partial, width, nullptr, c0, c1, c,"


def reversed_order(d: int, f: int, dtype: torch.dtype) -> str:
    """select_order with its comparison turned round."""
    return "transform" if f * 4 > d * dtype.itemsize else "aggregate"


# name -> (source, text of it, the replacement, whether phase 5's path
# reaches the fault).  Source "py" patches kernel.select_order instead.
MUTANTS = {
    "bag: last row of each unrolled batch dropped": (
        "embedding_bag", BAG_WT,
        "const float wt = u == kUnroll - 1 ? 0.f : s_w[j0 + u];", True),
    "bag: the last element of a row's last vector skipped": (
        "embedding_bag", BAG_FMA,
        "acc[e] = c == nv - 1 && e == kE - 1 ? acc[e] : "
        "fmaf(rows[u].get(e), wt, acc[e]);", True),
    "bag: mean counts pads": (
        "embedding_bag", BAG_MEAN,
        "if (kMean) wsum += s_r[j0 + u] < 0 ? 1.f : wt;", False),
    "mp: last edge of each unrolled batch dropped": (
        "segment_mp", MP_ADD,
        "if (j0 + u < cnt && col_ok && u != kU - 1) {", False),
    "mp: chunk boundary off by one": (
        "segment_mp", MP_CHUNK_END,
        "const int64_t hi = lo + chunk - 1 < end ? lo + chunk - 1 : end;",
        False),
    "mp: a hub's last partial left out": (
        "segment_mp", MP_PARTIALS,
        "(partial, width, nullptr, c0, c1 - 1, c,", False),
    "mp: K tile skipped in the product pass": (
        "segment_mp", MP_K_LOOP,
        MP_K_LOOP + "\n    if (k0 == kBK) continue;", False),
    "mp: select_order comparison reversed": ("py", "", "", False),
}


def build_variant(src: str, out: Path) -> Path:
    cu = out.with_suffix(".cu")
    cu.write_text(src)
    cmd = [build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
           str(out), str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {cu.name}:\n{proc.stderr}")
    return out


def run_checks(seed: int, table, runs: dict, rec_args: tuple) -> dict:
    """Phase 2b's and 2d's checks, and phase 5 when ``rec_args``."""
    dev = torch.device("cuda")
    out = {"2b": {}, "2d": {}}
    for case, _, (ok, err, _), order in cs.mp_edge_cases(seed, dev):
        n, e, d, f, dt, _, _ = case
        want = cs.mp_order(d, f, dt)
        out["2b"][str(case)] = {"ok": ok and order == want,
                                "max_abs_err": err, "order": order,
                                "expected_order": want}
    for case, _, (ok, err, _) in cs.bag_edge_cases(seed, dev):
        out["2d"][str(case)] = {"ok": ok, "max_abs_err": err}
    for label, (idx, mode, kind) in runs.items():
        got = ebops.embedding_bag(table, idx, mode=mode)
        ok, err, _ = cs.bag_check(got, table, idx, None, mode, kind)
        out["2d"][label] = {"ok": ok, "max_abs_err": err}
        del got
    torch.cuda.empty_cache()
    if rec_args:
        try:
            rec = cs.phase_rec(seed, *rec_args)
            out["5"] = {"ok": True, "score_err": rec["score_err"]}
        except cs.PhaseError as e:
            out["5"] = {"ok": False, "error": str(e)[:400]}
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rec-batch", type=int, default=512)
    ap.add_argument("--rec-cands", type=int, default=1_000_000)
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the results as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gather_mutants: no CUDA device", file=sys.stderr)
        return 2
    print(f"device: {cs.smi_line()}", flush=True)
    originals = {n: (build.CSRC / f"{n}.cu").read_text()
                 for n in ("embedding_bag", "segment_mp")}
    sources = {}
    for name, (source, old, new, _) in MUTANTS.items():
        if source == "py":
            continue
        if originals[source].count(old) != 1:
            raise SystemExit(f"mutant {name!r}: its text is not in "
                             f"{source}.cu exactly once")
        sources[name] = originals[source].replace(old, new)
    select_order = smpk.select_order
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(len(sources) + 1) as ex:
            unbroken = ex.submit(build.build_all)
            paths = dict(zip(sources, ex.map(
                lambda item: build_variant(item[1],
                                           Path(tmp) / f"m{item[0]}.so"),
                enumerate(sources.values()))))
            unbroken.result()
        table, runs = cs.bag_full_runs(args.seed, dev,
                                       get_arch("sasrec").config)
        rec_args = (args.rec_batch, args.rec_cands)
        results, good = {}, True
        for name in ["control", *MUTANTS]:
            ebk._bound = smpk._bound = None       # the unbroken libraries
            smpk.select_order = select_order
            reaches_rec = name == "control" or MUTANTS[name][3]
            if name != "control":
                source = MUTANTS[name][0]
                if source == "py":
                    smpk.select_order = reversed_order
                else:
                    lib = ctypes.CDLL(str(paths[name]))
                    (ebk if source == "embedding_bag" else smpk).bind(lib)
            r = run_checks(args.seed, table, runs,
                           rec_args if reaches_rec else ())
            results[name] = r
            failed = {ph: [c for c, x in r[ph].items() if not x["ok"]]
                      for ph in ("2b", "2d")}
            rec_ok = r.get("5", {}).get("ok", True)
            if name == "control":
                good &= not failed["2b"] and not failed["2d"] and rec_ok
            else:
                good &= bool(failed["2b"] or failed["2d"]) and \
                    (not reaches_rec or not rec_ok)
            print(f"{name}: phase 2b fails {len(failed['2b'])} of "
                  f"{len(r['2b'])} checks, phase 2d {len(failed['2d'])} of "
                  f"{len(r['2d'])}", flush=True)
            for ph in ("2b", "2d"):
                for case in failed[ph]:
                    print(f"  {ph} FAIL {case}: {r[ph][case]}", flush=True)
            if "5" in r:
                print(f"  phase 5: {r['5']}", flush=True)
        ebk._bound = smpk._bound = None
        smpk.select_order = select_order
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(results, indent=1))
    print(json.dumps({"ok": good}))
    return 0 if good else 1


if __name__ == "__main__":
    sys.exit(main())
