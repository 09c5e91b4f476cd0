#!/usr/bin/env python3
"""Hold chip_smoke.py's flash_attention checks to broken copies of its
kernels, on one NVIDIA card.

Each mutant is one of the attention sources (``src/repro_torch/csrc/``:
``flash_attention_tc.cu``, the bf16 ``wgmma`` prefill; ``flash_decode.cu``,
the split-KV decode; ``flash_attention.cu``, the fp32 CUDA-core variant)
with one fault written in.  It is built with nvcc into a temporary
directory (the checkout is not touched) and bound in place of that
variant's library.  For the unbroken sources (the control) and each
mutant, the script runs:

* phase 2c's checks (``chip_smoke.flash_check``): every case of
  ``FLASH_CASES``, phase 4's shapes among them, and the full-size inputs
  at gemma3-1b's heads (prefill of 32,768 tokens, global and window 512;
  decode at batch 128 over a 32,768-slot cache);
* phase 4 (``chip_smoke.phase_lm``): gemma3-1b serving in lockstep with
  its plain twin, held to ``LM_LOGIT_TOL``, and each of its attention
  calls held to its plain version (``flash_check``), for the control and
  the mutants whose fault phase 4's path can reach.

It prints every error beside its limit and exits 0 only when the control
passes every check and every mutant fails phase 2c and, where the fault
reaches phase 4's path, phase 4 too.

Run from the root of a checkout: ``python3 scripts/flash_mutants.py``.
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
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fak  # noqa: E402

BLIND = "if (hi_first <= lo_first || hi_last <= lo_last) {"
FIRST_ROW = "if (hi_first <= lo_first) {"
TC_TILE = """      mbar_wait(&full[st], (i / C::kStages) & 1);

      // S = Q K^T"""
TC_VALID = "(!p.causal || key <= qp)"
DEC_VALID = "(!p.causal || key <= my_qp)"
SIMT_VALID = "(!causal || key <= qpos[i])"
WEIGHT = "const float wt = exp2f("
# name -> (variant, text of its source, the replacement, whether phase 4's
# path reaches the fault).  Phase 4 has no row without a valid key, its
# decode has one row per sequence (the key after it is past kv_len) and it
# never runs the fp32 variant.
MUTANTS = {
    "tc: key tile skipped in the wgmma loop": (
        "tc", TC_TILE,
        TC_TILE.replace("\n\n", "\n      if (i == 0 && n_tiles > 1) {\n"
                        "        mbar_arrive(&empty[st]);\n"
                        "        continue;\n      }\n\n"), True),
    "tc: causal mask drops the own key": (
        "tc", TC_VALID, "(!p.causal || key < qp)", True),
    "tc: causal mask sees one future key": (
        "tc", TC_VALID, "(!p.causal || key <= qp + 1)", True),
    "tc: only the first row tested for no valid key": (
        "tc", BLIND, FIRST_ROW, False),
    "decode: causal mask drops the own key": (
        "decode", DEC_VALID, "(!p.causal || key < my_qp)", True),
    "decode: causal mask sees one future key": (
        "decode", DEC_VALID, "(!p.causal || key <= my_qp + 1)", False),
    "decode: only the first row tested for no valid key": (
        "decode", BLIND, FIRST_ROW, False),
    "decode: one split dropped in the combine": (
        "decode", WEIGHT,
        "const float wt = s / kWarps == 1 ? 0.f : exp2f(", True),
    "simt: causal mask drops the own key": (
        "simt", SIMT_VALID, "(!causal || key < qpos[i])", False),
    "simt: causal mask sees one future key": (
        "simt", SIMT_VALID, "(!causal || key <= qpos[i] + 1)", False),
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


def run_checks(seed: int, runs: dict, lm_args: tuple) -> dict:
    """Phase 2c's checks and phase 4 on the bound library."""
    dev = torch.device("cuda")
    out = {"cases": {}, "full": {}}
    for case, _, (ok, err, rel, _) in cs.flash_edge_cases(seed, dev):
        out["cases"][str(case)] = {"ok": ok, "max_abs_err": err,
                                   "row_err_2^-8": rel / 2 ** -8}
    for label, (q, k, v, window, kv_len) in runs.items():
        got = fak.flash_attention(q, k, v, causal=True, window=window,
                                  kv_len=kv_len)
        ok, err, rel, _ = cs.flash_check(got, q, k, v, True, window, kv_len,
                                         "plain")
        out["full"][label] = {"ok": ok, "max_abs_err": err,
                              "row_err_2^-8": rel / 2 ** -8}
        del got
    torch.cuda.empty_cache()
    if lm_args:
        try:
            lm = cs.phase_lm(seed, *lm_args)
            out["lm"] = {"ok": True, "max_logit_err": max(lm["errors"]),
                         "attention_err_2^-8": lm["attention_errors"]}
        except cs.PhaseError as e:
            out["lm"] = {"ok": False, "error": str(e)[:400]}
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--flash-seq", type=int, default=cs.LM_SEQ)
    ap.add_argument("--decode-batch", type=int, default=cs.DECODE_BATCH)
    ap.add_argument("--lm-batch", type=int, default=8)
    ap.add_argument("--lm-prompt", type=int, default=1024)
    ap.add_argument("--lm-steps", type=int, default=32)
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the results as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_mutants: no CUDA device", file=sys.stderr)
        return 2
    print(f"device: {cs.smi_line()}", flush=True)
    originals = {v: (build.CSRC / f"{n}.cu").read_text()
                 for v, n in fak.SOURCES.items()}
    sources = {}
    for name, (variant, old, new, _) in MUTANTS.items():
        src = originals[variant]
        if src.count(old) != 1:
            raise SystemExit(f"mutant {name!r}: its text is not in "
                             f"{fak.SOURCES[variant]}.cu exactly once")
        sources[name] = src.replace(old, new)
    names = ["control", *sources]
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(len(sources) + 1) as ex:
            unbroken = ex.submit(build.build_all)
            paths = dict(zip(sources, ex.map(
                lambda item: build_variant(item[1],
                                           Path(tmp) / f"m{item[0]}.so"),
                enumerate(sources.values()))))
            unbroken.result()
        runs = cs.flash_full_runs(args.seed, args.flash_seq,
                                  args.decode_batch, torch.device("cuda"))
        lm_args = (args.lm_batch, args.lm_prompt, args.lm_steps)
        results, good = {}, True
        for name in names:
            fak._bound.clear()             # the unbroken libraries
            if name != "control":
                fak.bind(MUTANTS[name][0], ctypes.CDLL(str(paths[name])))
            reaches_lm = name == "control" or MUTANTS[name][3]
            r = run_checks(args.seed, runs, lm_args if reaches_lm else ())
            results[name] = r
            failed = [c for c, x in {**r["cases"], **r["full"]}.items()
                      if not x["ok"]]
            if name == "control":
                good &= not failed and r["lm"]["ok"]
            else:
                good &= bool(failed) and (not reaches_lm or not r["lm"]["ok"])
            print(f"{name}: phase 2c fails at {len(failed)} of "
                  f"{len(r['cases']) + len(r['full'])} checks", flush=True)
            for label, x in r["full"].items():
                print(f"  {label}: {'pass' if x['ok'] else 'FAIL'}, max |err| "
                      f"{x['max_abs_err']:.4g}, {x['row_err_2^-8']:.4g} * 2^-8 "
                      f"of |want| + row rms (limit "
                      f"{cs.FLASH_ROW_TOL / 2 ** -8:g})", flush=True)
            for case, x in r["cases"].items():
                if not x["ok"] or case.endswith("'kv_past')"):
                    print(f"  {case}: {'pass' if x['ok'] else 'FAIL'}, max "
                          f"|err| {x['max_abs_err']:.4g}, "
                          f"{x['row_err_2^-8']:.4g} * 2^-8", flush=True)
            if "lm" in r:
                print(f"  phase 4: {r['lm']}", flush=True)
        fak._bound.clear()
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(results, indent=1))
    print(json.dumps({"ok": good}))
    return 0 if good else 1


if __name__ == "__main__":
    sys.exit(main())
