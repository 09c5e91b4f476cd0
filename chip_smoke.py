#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port of Weaver (``src/repro_torch``) on one
NVIDIA card and check it.

Phases, in order; any failure exits non-zero and prints no result line:

1. Device and build: the card's name and power limit, and the build of
   every CUDA source of the port (one ``nvcc`` per source, in parallel).
2. Kernels against their plain versions: ``before``, ``before_pairs``
   and ``visibility`` in both output forms (a byte per row, and a bit per
   row packed in int32 words, held against ``ref.pack_bits``) and their
   host entries (``before_host``, ``before_pairs_host``,
   ``visibility_host``: numpy in and out, one round trip), on seeded
   int32 stamp matrices (NO_STAMP rows, mixed epochs, equal vectors) at
   C in {3, 9} and N in {1, 31, 32, 33, 1023, 1025, 68,993,773}, through
   row views whose address is not 16-byte aligned, and at C = 17 and 40
   (widths read at run time, blocks of fewer warps); each must be
   bit-identical to its plain PyTorch version.  At the largest N each
   device-facing form is timed with CUDA events beside its bound and its
   whole tables' bytes, beside ``rows.clone()`` of the same table; then
   the host entries' µs per warm call at N 64 and 1,024 (and
   ``visibility_host`` at phase 3's snapshot size, 1,398,769 rows),
   beside the split of the same compare made through the device-tensor
   wrapper.  ``scripts/stamp_mutants.py`` shows that broken copies of
   the kernel fail these checks.
2b. ``segment_mp`` (fused message passing) against its plain version in
   fp64 on the card: the reference tests' cases (fp32, bf16, the 17x3
   ragged case), hubs spanning several chunks, gat-cora's D = 1433, each
   gather order (``kernel.select_order``, held to this script's own
   statement of the rule, ``mp_order``) with F not a multiple of 4,
   mostly empty rows, bf16 x and the tie D * s = F * 4; both wrappers
   under ``torch.cuda.set_sync_debug_mode("error")``; then one case at
   ogb-products' shape (N = 2,449,029, E = 61,859,140, D = 100, F = 64,
   power-law, transform first), timed beside its plain version and
   ``torch.sparse.mm(A, x) @ w``, with each pass's device time from
   ``torch.profiler``.
3. The system end to end: a port ``Weaver`` on the card with the
   device-resident column plane and group commit loads a seeded social
   graph through ``begin_tx``/``run_tx`` and runs a seeded mix of
   transactions, node programs, GC, snapshots and ``visible_edges_at``.
   The same stream runs through a port ``Weaver(device="cpu")`` in a
   worker process at the same time; results, counters and snapshot
   arrays must be identical.  Its serving steps (``serve_loops``) go
   through the package's ``GraphQueryServer``: a closed loop of 64
   clients over 20,000 TAO requests (``synth.tao_workload``, read share
   0.998), one of 16 clients over 4,000 at 0.75, and an open loop of
   5,000 at half the first loop's simulated throughput; each loop's
   returned dict and every request's ok flag and simulated latency must
   be identical between card and twin, and ``before`` and
   ``before_pairs`` must both launch inside them (counts set to 0 just
   before the serving steps and read just after).  Then the card run's
   column plane answers its last query in the byte and the bit form,
   timed part by part (``plane_mask_forms``); the two forms' masks must
   be equal.
3c. Snapshot traversals on the card: on phase 3's card Weaver, over
   ``snapshot_arrays`` at a fresh program stamp, ``bfs_levels_ga`` from
   u0, ``reachable``, ``connected_components_ga``, ``pagerank_ga``,
   ``sssp_weighted`` (seeded integer weights 1-9 as fp32) and
   ``clustering_coefficients_padded`` (max_deg 256), each held to a host
   oracle (scipy's BFS, components and Dijkstra exactly; an fp64 numpy
   power iteration for pagerank to rtol 1e-4, atol 1e-9; the reference's
   per-edge table build and a numpy count for clustering, exactly, at
   2,000 sampled vertices and the 20 of largest degree) and timed with
   CUDA events beside its bound.
3b. GNN training over the live snapshot: the main deployment's card
   Weaver feeds ``DynamicGraphPipeline`` batches (a writer tx commits
   between batches); each batch goes through ``mp.propagate_matmul`` on
   the kernel at gin-tu's widths (held against the plain version in
   fp64) and through AdamW steps of gin-tu at its published width
   (5 layers, d = 64) on the card and, in lockstep in this process on
   the same batches, on the CPU; logits, losses and parameters must
   agree at every step.  Then a smaller deployment without the column
   plane repeats phase 3, and its final snapshot is also held against
   the per-object Python snapshot oracle.  Last, the database's entry
   points (``launch.serve --mode graph`` and the examples ``quickstart``,
   ``social_serve`` and ``coingraph``) run with ``--device cuda`` and
   ``--device cpu`` in this process: each exits 0, the card's calls
   launch the stamp compares, and both print the same text.
2c. ``flash_attention`` against its plain version in fp32 on the card,
   each of its three variants (bf16 ``wgmma`` prefill, split-KV decode,
   fp32 CUDA-core prefill) at every kind of case: the reference tests'
   cases, causal Sq > Sk (rows with no valid key), ragged Sq and Sk,
   n_rep 1 to 16, D up to 256, per-row kv_len over a strided cache
   (windows wholly past a full cache among them), constant v, phase 4's
   shapes; then gemma3-1b's heads (4 query heads, 1 KV head, D = 256,
   bf16) at the LM shapes' 32k: prefill of one prompt (global and window
   512, the prefill variant) and decode at batch 128 with per-row kv_len
   (the decode variant), timed beside the plain version and
   ``scaled_dot_product_attention``.  bf16 results are held to each
   output row's own scale (``FLASH_ROW_TOL``); ``scripts/flash_mutants.py``
   shows that broken copies of the kernel fail these checks and
   phase 4's.  Last, the fp32 CUDA-core variant (on no model's path) at
   gemma3-1b's heads, causal prefill of 8,192 tokens, timed beside its
   plain version and fp32 ``scaled_dot_product_attention``.
2d. ``embedding_bag`` against its plain version: the reference tests'
   cases, all-pad bags (sum and fused mean: exactly 0), mean mode with
   weights in bf16, one-index bags (bit for bit), odd D, L not a
   multiple of the rows in flight, several bags per group, int64
   indices; both wrappers under ``set_sync_debug_mode("error")``; an
   index past the table in a subprocess, which must raise a CUDA error
   at the next ``torch.cuda.synchronize()``; then sasrec's table
   (1,000,032 x 50 fp32) at train_batch (65,536 bags of 50, 20 % pads,
   sum and mean) and at phase 5's one-index bags (512 x 50 histories,
   1,000,000 candidates), timed beside the plain version and
   ``F.embedding_bag``.  ``scripts/gather_mutants.py`` shows that broken
   copies of this kernel and of ``segment_mp`` fail phases 2b, 2d or 5.
4. LM serving: gemma3-1b at its published width and depth (26 layers,
   bf16, random weights from a seed) behind ``LMServer``: batch 8 of
   1,024-token prompts, then 32 greedy decode steps; the same weights on
   the plain twin (``set_use_kernel(False)``) in lockstep on the kernel
   path's tokens; logits must agree at every step and flash_attention
   must launch 26 x (1 + 32) times: 26 prefill launches of its prefill
   variant and 26 x 32 of its decode variant.  A second, untimed pass
   over the same prompts and tokens holds each of those attention calls
   to its plain version, as phase 2c does.
5. SASRec serving at its published config behind ``RecServer``: top-10
   over the 1M-item catalog for 512 users and 1,000,000 candidate scores
   for one user, held against direct indexing; embedding_bag must launch.
   Then item ids past the table and -1 must raise ``IndexError`` from the
   live server, and its next top-10 must equal its earlier answer.
6. Training (the LM and SASRec training slice, through the package's
   ``Trainer``, ``launch.train`` and ``LMServer``; each phase prints its
   cuts on its first line and its wall clock; no kernel may launch on a
   grad path):
6a. gemma3-1b at full width, depth cut to 6 (one 5:1 local/global
   period), fp32, batch 2 x 128, 3 steps on the card and on the CPU in
   lockstep: per step the losses, grad norms, each tensor's Adam moments'
   step share and the card's update against AdamW in fp64 must agree.
6b. gemma3-1b at full width and depth, bf16 parameters with fp32
   moments, loss_chunks 16, remat per layer, seq 4,096 x batch 8
   (train_4k's batch cut from 256), 10 steps of Zipfian tokens with a
   checkpoint every 5 in a temporary directory: the loss must fall; ms
   per step, tokens/s, peak memory, checkpoint bytes and save seconds.
   Then the step-10 save is torn, ``on_failure`` restores step 5 and
   steps 6-10 rerun: their losses must equal the uninterrupted run's.
   Then lm_loss under no_grad with the flash seam on and off must agree,
   with 26 flash_attention launches, each held against its plain version
   as phase 4 holds them.  Last, one more step under
   ``torch.profiler``: device ms over its kernels (the idle share) and the
   operators with the most device time.
6c. moonshot-v1-16b-a3b at full width, depth cut 48 -> 2: an fp32
   lockstep at 128 tokens over 2 steps, bf16 training at 1 x 4,096 over 4
   steps (loss, aux loss, share of (token, slot) pairs over capacity),
   then ``LMServer`` (2 x 256 prompts, 8 greedy steps) on the trained
   weights against its plain twin, as phase 4 (18 flash launches).
6d. SASRec at its published config: 65,536 sequences per step, 5 steps
   through Trainer; a lockstep at batch 512; bce_loss under no_grad with
   the bag seam on and off must be equal (3 embedding_bag launches).
6e. ``python -m repro_torch.launch.train`` for gemma3-1b, gin-tu and
   sasrec (reduced configs) and ``examples/train_lm.py``, each with
   ``--device cuda`` and ``--device cpu`` in this process: each exits 0
   and the final losses agree; each device's checkpoint resumes on the
   other.
   The sizes of 6a-6d are ``TRAIN_SIZES[--train-sizes]``: ``full`` (the
   default) as above, ``rehearsal`` a quick pass.
7. Distribution (``dist/`` on ``torch.distributed``, ``phase_dist``): the
   single-card references run first in this process, then ranks are
   spawned (``launch.mesh.run_local``); each rank prints its backend,
   world size, device, seconds and counted collective bytes, and a
   failing check in any rank fails the run.
7a. qwen3-moe-235b-a22b's MoE layer at full width (128 experts top-8,
   d 4,096, d_expert 1,536, bf16), 4 x 4,096 tokens, on (data 2, model
   4): 8 gloo ranks on the card, each holding its 32 experts, through
   ``moe_block(moe_impl="a2a")`` against the single-card scatter path at
   the reference tests' 2e-4 (ample capacity, and 1.25, where pairs
   drop); the exact-sized wire buffer (``moe_alltoall_exact_c_dev``)
   bit for bit against the static one.  Then moonshot-v1-16b-a3b (depth
   2, a2a) behind ``LMServer`` on (model 4): prefill on ``flash_tc`` and
   8 greedy steps, tokens and logits (2e-4) against the single-card
   server's, every attention call held to its plain version.
7b. gemma3-1b split-K decode on (model 4), 4 gloo ranks each holding its
   8,192-position block of a 32k cache: 8 x 1,024 prompts and 32 greedy
   steps through ``LMServer``, logits against the single-card server
   (gather decode on ``flash_decode``) per step in bf16 at 26 layers
   and in fp32 at 6, every prefill attention call held to its plain
   version; per layer and step only the partials' bytes cross.
7c. ``grad_sync`` and ``cross_pod_allreduce`` on (pod 2, data 2, model
   2) over SASRec's parameter tree (1,000,032 x 50 table), a different
   tree per rank, against their fp64 mean (plain and int8 across pods);
   replicated input is the identity.
7d. A world of one on NCCL: 7a's path and 7c's syncs on (1, 1) meshes
   give the single-device results exactly; with two cards or more, 7a
   also runs on NCCL across them.  ``DIST_SIZES[--dist-sizes]`` holds
   the sizes (``rehearsal``: reduced configs; with ``device="cpu"`` the
   phase runs on the CPU, 7d on gloo).
7e. Backward through the collectives, on the same spawns: 7a's layer
   once more with a backward at both capacity factors (forward and
   backward seconds and counted bytes side by side; x's and the router's
   gradients and each expert's, through a seeded projection, against the
   single-card scatter path's); moonshot-v1-16b-a3b at full width, depth
   2, its MoE layers on the all-to-all on (model 4): ``lm_loss`` and
   every gradient against the single-card scatter path, fp32 at 1 x 128
   tokens and bf16 at 1 x 4,096, and the whole tree's gradient norm over
   the held expert blocks; one ``Trainer`` step of the same LM in fp32 at
   1 x 128 with its vocabulary cut to 32,768 (four ranks' AdamW state at
   the full vocabulary does not fit one card) against the single-card
   step: loss, grad norm, every first moment, each rank's update against
   AdamW in fp64; ``sasrec.topk_catalog`` (the reference's
   ``_rec_serve`` top-100) at SASRec's published config for 512 users on
   (data 2, model 4) against dense ``score_catalog`` and a sort, its
   encode's embedding_bag held against the plain twin.
8. The dry run against the card: ``python -m repro_torch.launch.dryrun
   --arch --shape --mesh both`` for one cell of each shape kind
   (``DRYRUN_CELLS``), each in a subprocess, all at once (fake tensors,
   host CPU only), every cell ok (the whole grid stays with the CLI);
   cells shaped as 7a's layer and 7b's decode step count exactly the
   bytes those phases counted; the fake-tensor FLOP count of phase 6b's
   step equals ``FlopCounterMode`` over one real step on the card, whose
   ms is printed beside the dry run's lower bound.
9. One JSON line per the kernels table, the card's name and power limit,
   and last the result line.

Run from the root of a checkout: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import io
import json
import math
import multiprocessing
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import core  # noqa: E402
from repro_torch.core import analytics  # noqa: E402
from repro_torch.core.clock import NO_STAMP  # noqa: E402
from repro_torch.data import graphs, synth  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.mv_visibility import kernel as mvk  # noqa: E402
from repro_torch.kernels.mv_visibility import ops as mvops  # noqa: E402
from repro_torch.kernels.mv_visibility import ref as mvref  # noqa: E402
from repro_torch.kernels.segment_mp import kernel as smpk  # noqa: E402
from repro_torch.kernels.segment_mp import ops as smpops  # noqa: E402
from repro_torch.kernels.segment_mp import ref as smpref  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fak  # noqa: E402
from repro_torch.kernels.flash_attention import ops as faops  # noqa: E402
from repro_torch.kernels.embedding_bag import kernel as ebk  # noqa: E402
from repro_torch.kernels.embedding_bag import ops as ebops  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
INT32_OPS_PER_S = 67e12        # H100 SXM non-tensor 32-bit rate (fp32 row)
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
LIVEJOURNAL_EDGES = 68_993_773  # SNAP soc-LiveJournal1
OGB_PRODUCTS = (2_449_029, 61_859_140, 100, 64)  # N, E, d_feat, gin width

KERNELS = {           # name -> what it replaces
    "before": "src/repro/kernels/mv_visibility/kernel.py:75",
    "visibility": "src/repro/kernels/mv_visibility/kernel.py:104",
    "before_pairs": "src/repro/core/writepath.py:144",
    "segment_mp": "src/repro/kernels/segment_mp/kernel.py:82",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:99",
    "flash_decode": "src/repro/kernels/flash_attention/kernel.py:99",
    "embedding_bag": "src/repro/kernels/embedding_bag/kernel.py:61",
}
# GC every simulated second and a WAL checkpoint every 4096 records
# (defaults 0.05 s / 256): both rewrite O(store) state in the pure-Python
# simulator, which at this scale would dominate the run; neither changes
# what a read or a commit guarantees
GC_PERIOD = 1.0
WAL_CHECKPOINT_EVERY = 4096
PROGRAMS = ("traverse", "reachable", "sssp", "get_edges", "clustering",
            "count_edges")


class PhaseError(Exception):
    pass


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def stamp_rows(rng: np.random.Generator, n: int, q: np.ndarray) -> np.ndarray:
    """(n, C) int32 rows around q: epochs q-1/q/q+1, ~10% equal vectors,
    ~20% NO_STAMP rows."""
    c = q.size
    rows = rng.integers(0, 6, size=(n, c), dtype=np.int32)
    rows[:, 0] = q[0] + rng.integers(-1, 2, size=n, dtype=np.int32)
    rows[rng.random(n, dtype=np.float32) < 0.1, 1:] = q[1:]
    rows[rng.random(n, dtype=np.float32) < 0.2] = NO_STAMP
    return rows


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds per call over ``reps`` CUDA-event-timed calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# N of the small stamp cases: the tails of a 32-row bit word and of a
# kernel's 128-row tile
STAMP_NS = (1, 31, 32, 33, 1023, 1025)
# (N, C, offset) cases beyond those: views starting `offset` rows into a
# longer table (at C = 3 and 9 an address that is not 16-byte aligned),
# and widths the kernel reads at run time (C = 17), in blocks of fewer
# warps (C = 40)
STAMP_EXTRA = ((1025, 3, 1), (100_000, 3, 1), (1025, 9, 1), (1025, 17, 0),
               (1025, 17, 1), (3000, 40, 0))
# raw edge rows of phase 3's snapshots (visible_edges_at's N)
SNAPSHOT_ROWS = 1_398_769


def stamp_case(rng, n: int, c: int, dev, offset: int = 0) -> dict:
    """Seeded stamps around a query q (``stamp_rows``): host create and
    delete rows, q and per-row query stamps qs (half of them a later
    epoch), and their device tensors; with ``offset`` the device tables
    are views starting ``offset`` rows into longer tables."""
    q = rng.integers(0, 6, size=c, dtype=np.int32)
    q[0] = 1
    create = stamp_rows(rng, n, q)
    delete = stamp_rows(rng, n, q)
    qs = np.repeat(q[None], n, axis=0)
    qs[rng.random(n, dtype=np.float32) < 0.5, 0] += 1

    def up(a):
        t = torch.empty((n + offset, c), dtype=torch.int32, device=dev)
        t = t[offset:]
        t.copy_(torch.from_numpy(a))
        return t
    return {"host": (create, delete, q, qs),
            "dev": (up(create), up(delete), torch.from_numpy(q).to(dev),
                    up(qs))}


def stamp_checks(case: dict) -> dict:
    """Every stamp-compare form and entry against its plain version on
    the case's inputs: label -> rows (bit form: words) that differ, -1
    for a wrong dtype or shape.  Each label is one launch."""
    create, delete, q, qs = case["host"]
    rows, dele, qt, qst = case["dev"]
    want_b = mvref.before(rows, qt)
    want_p = mvref.before_pairs(rows, qst)
    want_v = mvref.visibility(rows, dele, qt)
    pairs = {
        "before": (mvops.before_mask(rows, qt), want_b),
        "before bits": (mvk.before(rows, qt, bits=True),
                        mvref.pack_bits(want_b)),
        "before_pairs": (mvops.before_pairs(rows, qst), want_p),
        "before_pairs bits": (mvk.before_pairs(rows, qst, bits=True),
                              mvref.pack_bits(want_p)),
        "visibility": (mvops.visibility_mask(rows, dele, qt), want_v),
        "visibility bits": (mvk.visibility(rows, dele, qt, bits=True),
                            mvref.pack_bits(want_v)),
        "before_host": (torch.from_numpy(mvk.before_host(create, q)),
                        want_b.cpu()),
        "before_pairs_host": (torch.from_numpy(
            mvk.before_pairs_host(create, qs)), want_p.cpu()),
        "visibility_host": (torch.from_numpy(
            mvk.visibility_host(create, delete, q)), want_v.cpu()),
    }
    torch.cuda.synchronize()
    out = {}
    for label, (got, want) in pairs.items():
        if got.dtype != want.dtype or got.shape != want.shape:
            out[label] = -1
        else:
            out[label] = int((got != want.to(got.device)).sum())
    return out


def stamp_edge_cases(seed: int, dev, big_n: int = 0):
    """Yield ((N, C, offset), case, stamp_checks) for C in (3, 9) and N in
    STAMP_NS (and ``big_n``), then the cases of STAMP_EXTRA."""
    rng = np.random.default_rng(seed)
    shapes = [(n, c, 0) for c in (3, 9)
              for n in (*STAMP_NS, *((big_n,) if big_n else ()))]
    for n, c, off in shapes + list(STAMP_EXTRA):
        case = stamp_case(rng, n, c, dev, off)
        if off and case["dev"][0].data_ptr() % 16 == 0:
            raise PhaseError(f"stamp view N={n} C={c} is 16-byte aligned")
        yield (n, c, off), case, stamp_checks(case)
        del case
        mvk.free_staging()
        torch.cuda.empty_cache()


def needed_words(name: str, args) -> int:
    """int32 words the compare must read for THIS data: every row's
    epoch, its other components only where the epoch ties with the query
    (the compare decides on the epoch alone otherwise), and for
    ``visibility`` the delete row only where the create row is before q.
    Two compares (<=, ==) per component word read."""
    if name == "before_pairs":
        rows, qs = args
        tie = int((rows[:, 0] == qs[:, 0]).sum())
        return 2 * rows.shape[0] + 2 * tie * (rows.shape[1] - 1)
    rows, q = args[0], args[-1]
    c = rows.shape[1]
    words = rows.shape[0] + int((rows[:, 0] == q[0]).sum()) * (c - 1) + c
    if name == "visibility":
        dele = args[1][mvref.before(rows, q)]
        words += dele.shape[0] + int((dele[:, 0] == q[0]).sum()) * (c - 1)
    return words


DEVICE_WRAPPERS = {"before": mvops.before_mask,
                   "before_pairs": mvops.before_pairs,
                   "visibility": mvops.visibility_mask}


def device_route_split(name: str, tables: tuple, q: np.ndarray,
                       reps: int = 200) -> dict:
    """Median host µs of each part of one ``name`` compare made through
    the device-tensor wrapper from host arrays: the pageable uploads of
    ``tables`` and ``q`` (``analytics.to_device``), the wrapper's checks,
    the rest of the wrapper (output allocation and launch) and the
    blocking read-back (``.cpu().numpy()``); ``call`` is the whole round
    trip."""
    wrapper = DEVICE_WRAPPERS[name]
    parts = {k: [] for k in ("copies", "checks", "launch", "read_back",
                             "call")}
    for i in range(reps + 20):
        t0 = time.perf_counter()
        ts = [analytics.to_device(a, "cuda") for a in (*tables, q)]
        t1 = time.perf_counter()
        mvk.check(ts[:-1], ts[-1], per_row=name == "before_pairs")
        t2 = time.perf_counter()
        out = wrapper(*ts)
        t3 = time.perf_counter()
        out.cpu().numpy()
        t4 = time.perf_counter()
        if i < 20:                                  # warm-up
            continue
        for k, v in (("copies", t1 - t0), ("checks", t2 - t1),
                     ("launch", (t3 - t2) - (t2 - t1)),
                     ("read_back", t4 - t3),
                     ("call", (t1 - t0) + (t4 - t2))):
            parts[k].append(v * 1e6)
    return {k: statistics.median(v) for k, v in parts.items()}


def host_entry_us(rng, n: int, names: tuple, c: int = 3,
                  reps: int = 200) -> dict:
    """Median host µs per warm call (``reps`` calls) of each named host
    entry at N = ``n``, and the split of the same compares made through
    the device-tensor route (``device_route_split``)."""
    create, delete, q, qs = stamp_case(rng, n, c, "cpu")["host"]
    inputs = {"before_pairs": ((create,), qs), "before": ((create,), q),
              "visibility": ((create, delete), q)}
    entries = {"before_pairs": mvk.before_pairs_host,
               "before": mvk.before_host,
               "visibility": mvk.visibility_host}
    out = {}
    for name in names:
        tables, qq = inputs[name]
        times = []
        for i in range(reps + 20):
            t0 = time.perf_counter()
            entries[name](*tables, qq)
            if i >= 20:
                times.append((time.perf_counter() - t0) * 1e6)
        out[f"{name}_host"] = statistics.median(times)
        out[f"{name} device route"] = device_route_split(name, tables, qq,
                                                         reps)
    return out


def phase_kernels(seed: int, big_n: int, reps: int) -> dict:
    """Phase 2: every stamp-compare form and entry == its plain version
    (``stamp_edge_cases``); at N = ``big_n`` each device-facing form is
    timed beside its plain version, its bound and its whole tables'
    bytes; then the host entries' µs per small call."""
    dev = torch.device("cuda")
    timings, max_err = {}, {}
    for (n, c, off), case, checks in stamp_edge_cases(seed, dev, big_n):
        for label, bad in checks.items():
            name = label.split()[0].removesuffix("_host")
            max_err[name] = max(max_err.get(name, 0), int(bad != 0))
            if bad:
                what = ("a wrong dtype or shape" if bad < 0
                        else f"{bad} rows or words differing")
                raise PhaseError(f"{label} C={c} N={n} offset {off}: {what} "
                                 f"against the plain version")
        if n != big_n:
            continue
        rows, dele, qt, qst = case["dev"]
        copy_ms = time_ms(lambda: rows.clone(), reps)
        print(f"yardstick C={c} N={n}: rows.clone() {copy_ms:.4f} ms, "
              f"{2 * rows.numel() * 4 / copy_ms / 1e6:.1f} GB/s read + "
              f"written (the card's copy rate in this run)", flush=True)
        forms = {"before": ((rows, qt), False, mvops.before_mask,
                            mvref.before),
                 "before bits": ((rows, qt), True,
                                 lambda r, q: mvk.before(r, q, bits=True),
                                 None),
                 "visibility": ((rows, dele, qt), False,
                                mvops.visibility_mask, mvref.visibility),
                 "visibility bits": ((rows, dele, qt), True,
                                     lambda r, d, q: mvk.visibility(
                                         r, d, q, bits=True), None),
                 "before_pairs": ((rows, qst), False, mvops.before_pairs,
                                  mvref.before_pairs),
                 "before_pairs bits": ((rows, qst), True,
                                       lambda r, q: mvk.before_pairs(
                                           r, q, bits=True), None)}
        for label, (args, bits, wrapper, plain) in forms.items():
            k_ms = time_ms(lambda: wrapper(*args), reps)
            p_ms = (time_ms(lambda: plain(*args), max(3, reps // 4))
                    if plain else None)
            out_bytes = 4 * ((n + 31) // 32) if bits else n
            full = sum(t.numel() * 4 for t in args) + out_bytes
            words = needed_words(label.split()[0], args)
            nbytes = words * 4 + out_bytes
            bound_ms = max(nbytes / HBM_BYTES_PER_S,
                           2 * words / INT32_OPS_PER_S) * 1e3
            whole_ms = full / HBM_BYTES_PER_S * 1e3
            plain_txt = "" if p_ms is None else f", plain {p_ms:.4f} ms"
            print(f"kernel {label} C={c} N={n}: {k_ms:.4f} ms{plain_txt}, "
                  f"bound {bound_ms:.4f} ms (this data needs {nbytes} "
                  f"bytes: {nbytes / k_ms / 1e6:.1f} GB/s); whole tables "
                  f"{full} bytes: {full / k_ms / 1e6:.1f} GB/s, "
                  f"{whole_ms:.4f} ms at 3.35 TB/s", flush=True)
            timings[(label, c)] = {"ms": k_ms, "plain_ms": p_ms,
                                   "bound_ms": bound_ms,
                                   "whole_ms": whole_ms}
    print(f"stamp compares == plain versions (bytes, bits, host entries; "
          f"before, before_pairs, visibility) at C in (3, 9), N in "
          f"{(*STAMP_NS, big_n)} and (N, C, offset rows) {STAMP_EXTRA}",
          flush=True)
    rng = np.random.default_rng(seed + 1)
    every = ("before_pairs", "before", "visibility")
    for n, reps_n, names in ((64, 200, every), (1024, 200, every),
                             (SNAPSHOT_ROWS, 50, ("visibility",))):
        us = host_entry_us(rng, n, reps=reps_n, names=names)
        entries = ", ".join(f"{k} {v:.1f} us" for k, v in us.items()
                            if k.endswith("_host"))
        routes = ", ".join(f"{k.split()[0]} {json.dumps(v)}"
                           for k, v in us.items() if k.endswith("route"))
        print(f"host entries N={n} C=3, median of {reps_n} warm calls: "
              f"{entries}; device-tensor route (split, us): {routes}",
              flush=True)
        timings[("host_us", n)] = us
    for (name, c), t in timings.items():
        if name in max_err:
            t["max_abs_err"] = max_err[name]
    return timings


# ---------------------------------------------------------------------------
# Phase 2b: segment_mp against its plain version
# ---------------------------------------------------------------------------

# (N, E, D, F, dtype, hub row, tolerance kind): the reference tests' cases
# (tests/test_kernels.py) at their tolerances, a hub taking half the edges
# (split into chunks by the kernel) and gat-cora's input width D = 1433;
# then each gather order (mp_order) with the cases it must meet: F not a
# multiple of 4, a hub spanning several chunks, mostly empty dst rows,
# bf16 x under each order (at D = 33, 2-byte loads), the tie D * s = F * 4
# in fp32 (D = F = 64, 16) and bf16 (D 64, F 32), and hubs of more than
# CHUNK chunks (split a second time) under each order
MP_CASES = [
    (64, 256, 16, 32, torch.float32, None, "ref"),
    (128, 1000, 64, 64, torch.float32, None, "ref"),
    (300, 2000, 32, 8, torch.float32, None, "ref"),
    (128, 512, 128, 128, torch.bfloat16, None, "ref"),
    (17, 3, 8, 16, torch.float32, None, "ref"),
    (100, 3000, 16, 16, torch.float32, 7, "hub"),
    (2708, 10556, 1433, 8, torch.float32, None, "scale"),
    (500, 4000, 40, 10, torch.float32, None, "ref"),
    (100, 3000, 64, 16, torch.float32, 7, "hub"),
    (1000, 300, 48, 24, torch.float32, None, "ref"),
    (300, 2500, 100, 8, torch.bfloat16, 11, "ref"),
    (64, 700, 33, 40, torch.bfloat16, 3, "ref"),
    (150, 900, 64, 32, torch.bfloat16, None, "ref"),
    (1000, 200_000, 16, 8, torch.float32, 5, "hub"),
    (2000, 150_000, 24, 48, torch.bfloat16, 9, "ref"),
]
MP_TOL = 1e-5       # "scale" cases, full size and phase 3b: max |got - y|
#                     <= MP_TOL * max |y|, against the fp64 truth y; and
MP_ROW_TOL = 1e-4   # |got - y| <= MP_ROW_TOL * ((sum of |x_u|) @ |w|) at
#                     every output, that output's own rounding scale: fp32
#                     sums of k terms stay within k * 2^-24 of it (to first
#                     order), under 1e-4 up to k = deg + D ~ 1,600; a
#                     dropped or doubled edge reads 1e-2 or more at these
#                     shapes (except in rows of thousands of edges)


def plain64(x, w, src, dst, n: int, chunk: int = 1 << 22) -> torch.Tensor:
    """The fp64 truth of ``y[v] = sum x[src] @ w``: the x rows summed per
    dst in fp64 (in edge chunks, so the gather stays a few GB), then @ w
    in fp64; equal to the plain version's order by linearity."""
    agg = torch.zeros((n, x.shape[1]), dtype=torch.float64, device=x.device)
    for i in range(0, src.numel(), chunk):
        agg.index_add_(0, dst[i:i + chunk], x[src[i:i + chunk]].double())
    return agg @ w.double()


def max_diff(got: torch.Tensor, truth: torch.Tensor) -> float:
    return float((got.double() - truth).abs().max()) if got.numel() else 0.0


def mp_errors(got, x, w, src, dst, n: int) -> tuple:
    """(worst |got - y| / ((sum |x_u|) @ |w|) over the outputs, max
    |got - y|, max |y|) against the fp64 truth y."""
    if not got.numel():
        return 0.0, 0.0, 0.0
    truth = plain64(x, w, src, dst, n)
    diff = (got.double() - truth).abs()
    top = float(truth.abs().max())
    del truth
    ratio = diff / plain64(x.abs(), w.abs(), src, dst, n)
    # 0/0 (no edges, or all-zero inputs, and got exact) is no error
    return (float(ratio.nan_to_num_(nan=0.0, posinf=float("inf")).max()),
            float(diff.max()), top)


def mp_check(got, x, w, src, dst, n: int, kind: str) -> tuple:
    """(passes, max |err|, the tolerance in words) of one segment_mp
    result ``got`` from ``x.to(got.dtype)``, ``w.to(got.dtype)``."""
    xt, wt = x.to(got.dtype), w.to(got.dtype)
    if kind == "scale":
        rel, err, top = mp_errors(got, xt, wt, src, dst, n)
        return (rel <= MP_ROW_TOL and err <= MP_TOL * top, err,
                f"{rel:.3g} of each output's rounding scale <= {MP_ROW_TOL}; "
                f"<= {MP_TOL} * max|y| = {MP_TOL * top:.3g}")
    # the reference tests' tolerances, against the plain version in fp64
    # (bf16: of the bf16 inputs) rather than in fp32, whose atomic sums
    # on the card add their own rounding
    want = smpref.segment_matmul_reduce_ref(xt.double(), wt.double(), src,
                                            dst, n)
    rtol, atol = {"hub": (1e-4, 1e-4)}.get(
        kind, (3e-2, 3e-1) if got.dtype == torch.bfloat16 else (1e-5, 1e-5))
    diff = (got.double() - want).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    return (bool((diff <= atol + rtol * want.abs()).all()), err,
            f"rtol {rtol} atol {atol}")


def mp_case(rng, n, e, d, f, hub, dev):
    """Seeded normal x (n, d) and w (d, f) in fp32 and uniform int32
    edges; with ``hub``, half the edges go to that dst row."""
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(d, f)).astype(np.float32))
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    if hub is not None:
        dst = np.where(rng.random(e) < 0.5, hub, dst).astype(np.int32)
    return (x.to(dev), w.to(dev), torch.from_numpy(src).to(dev),
            torch.from_numpy(dst).to(dev))


def device_search(dev):
    """``graphs.random_graph``'s inverse-CDF search, on ``dev``."""
    def search(cdf: np.ndarray, u: np.ndarray) -> torch.Tensor:
        return torch.searchsorted(torch.from_numpy(cdf).to(dev),
                                  torch.from_numpy(u).to(dev),
                                  right=True).int()
    return search


def mp_bound(n, e, d, f, elem_bytes) -> tuple:
    """(bound ms, what binds): the bytes the function must move (indices
    once, x once, W once, y once) over the HBM rate, and its fp32
    operations in the cheaper order (2*N*D*F for the product, E*min(D, F)
    for the sums) over the fp32 rate, the larger of the two."""
    nbytes = e * 4 + (n + 1) * 4 + (n * d + d * f + n * f) * elem_bytes
    ops = 2 * n * d * f + e * min(d, f)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, \
        ("bytes" if t_bytes >= t_ops else "operations")


def mp_order(d: int, f: int, dt) -> str:
    """The order segment_mp must take: the one that gathers fewer bytes
    per edge, fp32 rows of h = x @ W (F * 4 bytes) or rows of x (D * its
    element size); a tie aggregates."""
    return "transform" if f * 4 < d * (torch.finfo(dt).bits // 8) \
        else "aggregate"


def mp_launched_order(before: dict) -> str:
    """The order of the one segment_mp call since ``before`` (a copy of
    the launch counts), or a description of what else was launched."""
    new = {k: smpk.launches[k] - before[k] for k in before}
    if new["segment_mp"] != 1:
        return f"{new['segment_mp']} launches"
    return "transform" if new["segment_mp_transform"] == 1 else \
        "aggregate" if new["segment_mp_aggregate"] == 1 else str(new)


def sync_free(fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("error")``: a call
    that synchronises with the card, or reads from it, raises."""
    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    except RuntimeError as e:
        raise PhaseError(f"a kernel wrapper synchronised: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def device_split(fn) -> dict:
    """Device ms per launch of each CUDA kernel ``fn`` launches: the mean
    over the launches that 5 profiled calls left in the trace
    (``torch.profiler``).  The trace can lose a short kernel's records,
    so a trace with none is taken again, up to 3 times; empty when none
    shows device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    out = {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            us = getattr(ev, "device_time_total",
                         getattr(ev, "cuda_time_total", 0.0))
            if us > 0:
                name = ev.key.replace("(anonymous namespace)::", "")
                name = name.removeprefix("void ").split("<")[0].split("(")[0]
                out[name] = out.get(name, 0.0) + us / 1e3 / ev.count
        if out:
            return out
    return out


def host_us(fn, n: int = 2000) -> float:
    """Host µs per call of ``fn`` over ``n`` calls without synchronising:
    the wrapper's own cost, for calls whose kernel is shorter."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def mp_edge_cases(seed: int, dev):
    """Yield (case, result, mp_check's verdict, the order launched) for
    every case of MP_CASES."""
    rng = np.random.default_rng(seed)
    for case in MP_CASES:
        n, e, d, f, dt, hub, kind = case
        x, w, src, dst = mp_case(rng, n, e, d, f, hub, dev)
        before = dict(smpk.launches)
        got = smpops.segment_matmul_reduce(x.to(dt), w.to(dt), src, dst, n)
        sync(dev)
        yield case, got, mp_check(got, x, w, src, dst, n, kind), \
            mp_launched_order(before)


def phase_segment_mp(seed: int, full: tuple, reps: int) -> dict:
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    max_err = 0.0
    for case, got, (ok, err, tol), order in mp_edge_cases(seed, dev):
        n, e, d, f, dt, hub, kind = case
        if got.dtype != dt or tuple(got.shape) != (n, f):
            raise PhaseError(f"segment_mp {n}x{d}->{f}: got {got.dtype} "
                             f"{tuple(got.shape)}")
        if order != mp_order(d, f, dt):
            raise PhaseError(f"segment_mp N={n} D={d} F={f} {dt}: launched "
                             f"{order}, expected {mp_order(d, f, dt)}")
        if not ok:
            raise PhaseError(f"segment_mp N={n} E={e} D={d} F={f} {dt}: "
                             f"max |err| {err} exceeds {tol}")
        if dt == torch.float32:
            max_err = max(max_err, err)
        print(f"segment_mp == plain at N={n} E={e} D={d} F={f} {dt} "
              f"({kind}, {order} first): max |err| {err:.3g} ({tol})",
              flush=True)
    # the wrappers read nothing back: no synchronising call in either
    # order, fp32 or bf16, through ops (sort and CSR on the card) or kernel
    for d, f in ((48, 24), (16, 64)):
        x, w, src, dst = mp_case(rng, 300, 5000, d, f, 5, dev)
        dst_s, order = torch.sort(dst, stable=True)
        src_s, indptr = src[order], smpops.csr_indptr(dst_s, 300)
        for dt in (torch.float32, torch.bfloat16):
            xt, wt = x.to(dt), w.to(dt)
            sync_free(lambda: smpops.segment_matmul_reduce(xt, wt, src, dst,
                                                           300))
            sync_free(lambda: smpk.segment_mp(xt, wt, src_s, indptr))
    print("segment_mp wrappers (ops and kernel, both orders, fp32 and "
          "bf16) made no synchronising call", flush=True)
    # a small call (the last case above, fp32), whose time is the wrapper's
    print(f"segment_mp at N=300 E=5000 D={d} F={f}: host "
          f"{host_us(lambda: smpk.segment_mp(x, w, src_s, indptr)):.2f} µs "
          f"per call", flush=True)

    n, e, d, f = full
    t0 = time.perf_counter()
    src, dst = graphs.random_graph(rng, n, e, power_law=True,
                                   search=device_search(dev))
    dst, order = torch.sort(dst, stable=True)
    src = src[order]
    del order
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n, d), generator=gen, device=dev)
    w = torch.randn((d, f), generator=gen, device=dev) / d ** 0.5
    indptr = smpops.csr_indptr(dst, n)
    deg = (indptr[1:] - indptr[:-1])
    n_heavy = int((deg > smpk.CHUNK).sum())
    print(f"segment_mp full size: power-law graph N={n} E={e} D={d} F={f} "
          f"made in {time.perf_counter() - t0:.1f} s; max in-degree "
          f"{int(deg.max())}, {n_heavy} rows above {smpk.CHUNK} edges",
          flush=True)
    del deg
    chunk_ptr = smpk.plan_on_card(indptr)
    if not (torch.equal(chunk_ptr, smpk.plan(indptr)) and torch.equal(
            smpk.plan_on_card(chunk_ptr), smpk.plan(chunk_ptr))):
        raise PhaseError(f"segment_mp at N={n}: the kernel's hub plan != "
                         f"its plain version")
    print(f"segment_mp full size: the kernel's hub plan == its plain "
          f"version at both levels ({int(chunk_ptr[-1])} chunks)",
          flush=True)
    del chunk_ptr
    before = dict(smpk.launches)
    got = smpk.segment_mp(x, w, src, indptr)
    order = mp_launched_order(before)
    if order != mp_order(d, f, x.dtype):
        raise PhaseError(f"segment_mp at N={n} D={d} F={f}: launched "
                         f"{order}, expected {mp_order(d, f, x.dtype)}")
    rel, err, top = mp_errors(got, x, w, src, dst, n)
    if not (rel <= MP_ROW_TOL and err <= MP_TOL * top):
        raise PhaseError(f"segment_mp at N={n}: max |err| {err} (max |y| "
                         f"{top}, tolerance {MP_TOL} of it), {rel} of an "
                         f"output's rounding scale (tolerance {MP_ROW_TOL})")
    del got
    truth = plain64(x, w, src, dst, n)
    plain_err = max_diff(smpref.segment_matmul_reduce_ref(
        x, w, src, dst, n), truth)
    a_csr = torch.sparse_csr_tensor(indptr, src, torch.ones(
        e, device=dev), size=(n, n))
    lib_err = max_diff(torch.sparse.mm(a_csr, x) @ w, truth)
    print(f"segment_mp at N={n}: max |kernel - fp64| {err:.4g} (max |y| "
          f"{top:.4g}), worst output {rel:.3g} of its rounding scale "
          f"(sum |x_u|) @ |w|; plain fp32 {plain_err:.4g}, sparse.mm@w "
          f"{lib_err:.4g} (tolerances {MP_TOL} * max |y|, {MP_ROW_TOL} of "
          f"the rounding scale)", flush=True)
    del truth
    torch.cuda.empty_cache()
    k_ms = time_ms(lambda: smpk.segment_mp(x, w, src, indptr), reps)
    split = device_split(lambda: smpk.segment_mp(x, w, src, indptr))
    p_ms = time_ms(lambda: smpref.segment_matmul_reduce_ref(
        x, w, src, dst, n), max(3, reps // 4))
    torch.cuda.empty_cache()
    l_ms = time_ms(lambda: torch.sparse.mm(a_csr, x) @ w, max(3, reps // 4))
    bound_ms, bound_by = mp_bound(n, e, d, f, 4)
    gathered = e * (f if order == "transform" else d) * 4
    print(f"kernel segment_mp N={n} E={e} D={d} F={f} fp32 ({order} "
          f"first): {k_ms:.4f} ms, plain {p_ms:.4f} ms, sparse.mm@w "
          f"{l_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); gathered "
          f"rows {gathered / k_ms / 1e6:.1f} GB/s; device ms by kernel "
          f"(torch.profiler, mean of 5 calls): {split}", flush=True)
    del x, w, src, dst, indptr, a_csr
    torch.cuda.empty_cache()
    return {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": max(max_err, err)}


# ---------------------------------------------------------------------------
# Phase 2c: flash_attention against its plain version
# ---------------------------------------------------------------------------

BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor-core rate
GEMMA = dict(hq=4, hkv=1, d=256)   # gemma3-1b's attention heads
LM_SEQ = 32_768                # the LM shapes' prefill_32k / decode_32k length
DECODE_BATCH = 128             # decode_32k's batch
# (B, Sq, Sk, Hq, Hkv, D, causal, window, dtype, kind).  kind "kv_len": K
# and V are strided views of one packed (B, Sk, 2, Hkv, D) cache and every
# batch row has its own key length (0, and Sk + 3: decode past a full
# cache, among them); "const_v": v is 3.5 everywhere, so every output row
# must be 3.5 (the probabilities sum to 1, the reference tests' row-sum
# property)
FLASH_CASES = [
    # the reference tests' cases (tests/test_kernels.py), one head each
    (2, 128, 128, 1, 1, 64, True, None, torch.float32, "plain"),
    (1, 256, 256, 1, 1, 32, True, None, torch.float32, "plain"),
    (3, 128, 128, 1, 1, 64, False, None, torch.float32, "plain"),
    (2, 128, 128, 1, 1, 64, True, 64, torch.float32, "plain"),
    (2, 128, 256, 1, 1, 64, True, None, torch.float32, "plain"),
    (2, 256, 256, 1, 1, 128, True, None, torch.bfloat16, "plain"),
    # Sq > Sk causal: the first Sq - Sk rows see no key (mean of v)
    (2, 200, 77, 4, 2, 64, True, None, torch.float32, "plain"),
    (1, 150, 40, 8, 8, 128, True, 16, torch.bfloat16, "plain"),
    # ragged Sq and Sk, n_rep 4 and 8, D 256, a D that takes scalar loads,
    # a window without the causal mask
    (2, 173, 291, 8, 1, 64, True, None, torch.bfloat16, "plain"),
    (1, 37, 100, 4, 1, 256, True, 16, torch.float32, "plain"),
    (2, 33, 65, 3, 1, 30, True, None, torch.float32, "plain"),
    (2, 70, 50, 2, 2, 64, False, 30, torch.float32, "plain"),
    # per-row kv_len over a padded cache read in place (decode and short
    # prompts), rows with no valid key among them
    (4, 1, 300, 8, 2, 128, True, None, torch.float32, "kv_len"),
    (3, 5, 200, 4, 1, 256, True, 40, torch.bfloat16, "kv_len"),
    (5, 1, 129, 4, 1, 256, True, None, torch.bfloat16, "kv_len"),
    (1, 128, 64, 1, 1, 64, False, None, torch.float32, "const_v"),
    (1, 64, 128, 4, 1, 32, True, None, torch.float32, "const_v"),
    # phase 4's shapes: gemma3-1b's heads, prefill of 8 x 1,024 (local
    # and global layers) and decode over the 1,056-slot cache
    (8, 1024, 1024, 4, 1, 256, True, 512, torch.bfloat16, "plain"),
    (8, 1024, 1024, 4, 1, 256, True, None, torch.bfloat16, "plain"),
    (8, 1, 1056, 4, 1, 256, True, 512, torch.bfloat16, "kv_len"),
    # kind "kv_past": every row's kv_len is Sk + Sq, so the last rows' windows
    # lie wholly past the full cache (no valid key: mean of v) while the
    # first rows still see keys
    (1, 20, 256, 1, 1, 64, True, 16, torch.float32, "kv_past"),
    (2, 40, 256, 4, 1, 128, True, 32, torch.bfloat16, "kv_past"),
    # so that every variant (kernel.select_variant) meets every kind: the
    # bf16 tensor-core prefill without the causal mask, at n_rep 3 (128
    # rows per tile do not split into whole positions) and at D = 80
    # (zero-filled to 128)
    (2, 70, 50, 2, 2, 64, False, 30, torch.bfloat16, "plain"),
    (2, 100, 160, 6, 2, 128, True, None, torch.bfloat16, "plain"),
    (1, 64, 96, 4, 2, 80, True, None, torch.bfloat16, "plain"),
    # the split decode: a window past a full cache in bf16, Sq > Sk
    # causal, a window without the causal mask, constant v over 1,000
    # keys, chatglm3's 16 rows, fp32 at D = 256 (kv_len 0 with 3 splits
    # is the first kv_len case above)
    (2, 4, 256, 4, 1, 128, True, 2, torch.bfloat16, "kv_past"),
    (2, 4, 3, 4, 1, 64, True, None, torch.float32, "plain"),
    (3, 2, 700, 2, 1, 64, False, 100, torch.bfloat16, "plain"),
    (1, 1, 1000, 8, 1, 32, False, None, torch.float32, "const_v"),
    (2, 1, 600, 16, 1, 128, True, None, torch.bfloat16, "kv_len"),
    (2, 1, 300, 4, 1, 256, True, None, torch.float32, "kv_len"),
    # the CUDA-core variant over a padded cache, and in bf16 at a D that
    # is no multiple of 16
    (3, 6, 200, 4, 1, 64, True, 40, torch.float32, "kv_len"),
    (2, 33, 65, 3, 1, 40, True, None, torch.bfloat16, "plain"),
]
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}   # rtol = atol, as
#              tests/test_kernels.py; against the plain version in fp32
FLASH_ROW_TOL = 8 * 2.0 ** -8   # and, for bf16, |err| <= this * (|want| +
#   the rms of want's row over D): the kernel rounds p and o to bf16 (unit
#   roundoff 2^-8), which puts its error at a few 2^-8 of the row's scale
#   (a bf16 emulation on the CPU reads up to 2.3 * 2^-8 at these shapes);
#   one key dropped from a 32k band reads 24 * 2^-8 there, a 64-key tile
#   dropped 95 and more.  An absolute limit would not do: a row's output
#   shrinks as 1/sqrt(keys seen) (rms 0.009 at 32k)


def flash_case(rng, case, dev):
    """Seeded normal q (B, Sq, Hq, D), k and v (B, Sk, Hkv, D) in the
    case's dtype on ``dev``, and kv_len (or None)."""
    b, sq, sk, hq, hkv, d, _, _, dt, kind = case
    q = torch.from_numpy(rng.normal(size=(b, sq, hq, d)).astype(np.float32))
    kv = torch.from_numpy(rng.normal(size=(b, sk, 2, hkv, d))
                          .astype(np.float32)).to(dev, dt)
    k, v = kv[:, :, 0], kv[:, :, 1]
    if kind not in ("kv_len", "kv_past"):
        k, v = k.contiguous(), v.contiguous()
    if kind == "const_v":
        v = torch.full_like(v, 3.5)
    kv_len = None
    if kind == "kv_len":
        lens = rng.integers(0, sk + 1, size=b).astype(np.int32)
        lens[0], lens[-1] = 0, sk + 3     # none valid; past a full cache
        kv_len = torch.from_numpy(lens).to(dev)
    if kind == "kv_past":
        kv_len = torch.full((b,), sk + sq, dtype=torch.int32, device=dev)
    return q.to(dev, dt), k, v, kv_len


def flash_plain(q, k, v, causal, window, kv_len, q_chunk: int = 2048,
                b_chunk: int = 8) -> torch.Tensor:
    """The plain version in fp32 (inputs upcast), ``b_chunk`` batch rows
    and ``q_chunk`` query rows at a time so that the 32k cases fit."""
    outs = []
    for b0 in range(0, q.shape[0], b_chunk):
        sl = slice(b0, b0 + b_chunk)
        outs.append(faops.mha_ref(
            q[sl].float(), k[sl].float(), v[sl].float(), causal=causal,
            window=window, kv_len=None if kv_len is None else kv_len[sl],
            q_chunk=q_chunk))
    return torch.cat(outs)


def flash_check(got, q, k, v, causal, window, kv_len, kind) -> tuple:
    """(passes, max |err|, max |err| / (|want| + rms of want's row), the
    tolerance in words) of one kernel result."""
    tol = FLASH_TOL[q.dtype]
    if kind == "const_v":
        err = float((got.float() - 3.5).abs().max())
        return err <= 1e-5 * 3.5, err, err / 7.0, "rtol 1e-5 of v = 3.5"
    want = flash_plain(q, k, v, causal, window, kv_len)
    diff = (got.float() - want).abs_()
    ok = bool((diff <= tol + tol * want.abs()).all())
    scale = want.abs() + want.pow(2).mean(-1, keepdim=True).sqrt()
    rel = float((diff / scale.clamp_min(1e-30)).max())
    words = f"rtol = atol = {tol}"
    if q.dtype == torch.bfloat16:
        ok = ok and rel <= FLASH_ROW_TOL
        words += f"; {rel / 2 ** -8:.3g} * 2^-8 of |want| + row rms <= " \
                 f"{FLASH_ROW_TOL / 2 ** -8:g} * 2^-8"
    return ok, float(diff.max()), rel, words


def flash_pairs(b, sq, sk, causal, window, kv_len) -> int:
    """Unmasked (query, key) pairs per query head over the batch."""
    kvl = np.full(b, sk, np.int64) if kv_len is None else \
        np.maximum(kv_len.cpu().numpy().astype(np.int64), 0)
    i = np.arange(sq, dtype=np.int64)
    total = 0
    for m in kvl:
        n = min(m, sk)
        pos = m - sq + i
        hi = np.minimum(n, pos + 1) if causal else np.full(sq, n)
        lo = np.maximum(0, pos - window + 1) if window else 0
        total += int(np.maximum(hi - lo, 0).sum())
    return total


def flash_bound(q, k, causal, window, kv_len) -> tuple:
    """(bound ms, what binds): q and o once and each K/V row a query can
    see once, over the HBM rate; 4 * D flops per unmasked (query, key)
    pair over the peak for q's type (bf16 tensor cores; fp32 outside
    them); the larger of the two."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    pairs = flash_pairs(b, sq, sk, causal, window, kv_len)
    if kv_len is None:
        kv_rows = b * sk
    else:   # decode: the rows below each kv_len
        kv_rows = int(kv_len.clamp(0, sk).sum())
    es = q.element_size()
    nbytes = 2 * q.numel() * es + 2 * kv_rows * hkv * d * es
    ops = 4 * d * pairs * hq
    peak = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else FP32_OPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, \
        ("bytes" if t_bytes >= t_ops else "operations")


def flash_full_runs(seed: int, seq: int, decode_batch: int, dev) -> dict:
    """The full-size inputs at gemma3-1b's heads, bf16, by label: (q, k,
    v, window, kv_len) for the prefill of one ``seq``-token prompt (global
    and window 512) and decode at ``decode_batch`` over a ``seq`` cache
    with per-row kv_len."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    hq, hkv, d = GEMMA["hq"], GEMMA["hkv"], GEMMA["d"]

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    q, k, v = randn(1, seq, hq, d), randn(1, seq, hkv, d), randn(1, seq, hkv, d)
    runs = {f"prefill S={seq} window={w}": (q, k, v, w, None)
            for w in (None, 512)}
    lens = np.random.default_rng(seed).integers(1, seq + 1, size=decode_batch)
    runs[f"decode B={decode_batch} Sk={seq} kv_len"] = (
        randn(decode_batch, 1, hq, d), randn(decode_batch, seq, hkv, d),
        randn(decode_batch, seq, hkv, d), None,
        torch.from_numpy(lens.astype(np.int32)).to(dev))
    return runs


def flash_simt_run(seed: int, seq: int, dev) -> tuple:
    """The fp32 causal prefill of one ``seq``-token prompt at gemma3-1b's
    heads: (q, k, v), the shape the fp32 CUDA-core variant serves."""
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    hq, hkv, d = GEMMA["hq"], GEMMA["hkv"], GEMMA["d"]
    return tuple(torch.randn((1, seq, h, d), generator=gen, device=dev)
                 for h in (hq, hkv, hkv))


def flash_edge_cases(seed: int, dev):
    """Yield (case, its result, flash_check's verdict) for every case of
    FLASH_CASES."""
    rng = np.random.default_rng(seed)
    for case in FLASH_CASES:
        _, _, _, _, _, _, causal, window, _, kind = case
        q, k, v, kv_len = flash_case(rng, case, dev)
        got = faops.mha(q, k, v, causal=causal, window=window, kv_len=kv_len)
        yield case, got, flash_check(got, q, k, v, causal, window, kv_len,
                                     kind)


SIMT_SEQ = 8192   # the fp32 variant's full-size prefill (the plain
#                   version's fp32 logits take 0.27 GB per 2,048 rows)


def phase_flash(seed: int, seq: int, decode_batch: int, reps: int,
                device: str = "cuda") -> dict:
    import torch.nn.functional as F
    dev = torch.device(device)
    for case, got, (ok, err, rel, tol) in flash_edge_cases(seed, dev):
        b, sq, sk, hq, hkv, d, causal, window, dt, kind = case
        if got.dtype != dt or tuple(got.shape) != (b, sq, hq, d):
            raise PhaseError(f"flash_attention {case}: got {got.dtype} "
                             f"{tuple(got.shape)}")
        if not ok:
            raise PhaseError(f"flash_attention {case}: max |err| {err} "
                             f"exceeds {tol}")
        print(f"flash_attention == plain at B={b} Sq={sq} Sk={sk} Hq={hq} "
              f"Hkv={hkv} D={d} causal={causal} window={window} {dt} "
              f"({kind}): max |err| {err:.3g} ({tol})", flush=True)

    hq, hkv, d = GEMMA["hq"], GEMMA["hkv"], GEMMA["d"]
    runs = flash_full_runs(seed, seq, decode_batch, dev)
    out = {}
    for label, (q, k, v, window, kv_len) in runs.items():
        variant = fak.select_variant(q.dtype, q.shape, k.shape,
                                     fak._vec_ok((q, k, v), q.shape[-1]))
        want = "decode" if kv_len is not None else "tc"
        if variant != want:
            raise PhaseError(f"flash_attention {label}: variant {variant}, "
                             f"expected {want}")
        got = faops.mha(q, k, v, causal=True, window=window, kv_len=kv_len)
        ok, err, rel, tol = flash_check(got, q, k, v, True, window, kv_len,
                                        "plain")
        if not ok:
            raise PhaseError(f"flash_attention {label}: max |err| {err} "
                             f"exceeds {tol}")
        del got
        torch.cuda.empty_cache()
        k_ms = time_ms(lambda: faops.mha(q, k, v, causal=True, window=window,
                                         kv_len=kv_len), reps, warmup=1)
        p_ms = time_ms(lambda: flash_plain(q, k, v, True, window, kv_len),
                       max(1, reps // 2), warmup=1)
        # the library yardstick: global causal (no window, no kv_len)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        causal_lib = q.shape[1] > 1
        l_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal_lib, enable_gqa=True), reps,
            warmup=1)
        del qt, kt, vt
        torch.cuda.empty_cache()
        bound_ms, bound_by = flash_bound(q, k, True, window, kv_len)
        print(f"kernel flash_attention ({variant}) {label} Hq={hq} Hkv={hkv} "
              f"D={d} bf16: "
              f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, sdpa (global causal) "
              f"{l_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); max "
              f"|err| {err:.3g} ({tol})", flush=True)
        out[label] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "max_abs_err": err}
    del q, k, v, runs
    torch.cuda.empty_cache()
    # the fp32 CUDA-core variant (on no model's path) at full width
    q, k, v = flash_simt_run(seed, SIMT_SEQ, dev)
    label = f"prefill S={SIMT_SEQ} fp32"
    variant = fak.select_variant(q.dtype, q.shape, k.shape,
                                 fak._vec_ok((q, k, v), q.shape[-1]))
    if variant != "simt":
        raise PhaseError(f"flash_attention {label}: variant {variant}, "
                         f"expected simt")
    got = faops.mha(q, k, v, causal=True)
    ok, err, rel, tol = flash_check(got, q, k, v, True, None, None, "plain")
    if not ok:
        raise PhaseError(f"flash_attention {label}: max |err| {err} exceeds "
                         f"{tol}")
    del got
    k_ms = time_ms(lambda: faops.mha(q, k, v, causal=True), reps, warmup=1)
    p_ms = time_ms(lambda: flash_plain(q, k, v, True, None, None),
                   max(1, reps // 2), warmup=1)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    l_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), reps, warmup=1)
    del qt, kt, vt
    bound_ms, bound_by = flash_bound(q, k, True, None, None)
    print(f"kernel flash_attention (simt) {label} Hq={hq} Hkv={hkv} D={d}: "
          f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, sdpa (enable_gqa, fp32) "
          f"{l_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); max |err| "
          f"{err:.3g} ({tol})", flush=True)
    out[label] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                  "bound_ms": bound_ms, "bound_by": bound_by,
                  "max_abs_err": err}
    del q, k, v
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 2d: embedding_bag against its plain version
# ---------------------------------------------------------------------------

# (V, D, B, L, weighted, mode, dtype, kind): the reference tests' cases
# (tests/test_kernels.py) at their tolerances, an all-pad bag (sum, and
# mean with bf16 weights), mean mode with weights in bf16, SASRec's
# one-index bags (D = 50, exact) and a wide row with more than 32 indices
# per bag; then the kernel's launch shapes: odd D (4-byte fp32 and 2-byte
# bf16 loads), L not a multiple of its 8 rows in flight, several bags per
# group (L < 8) with B not a multiple of the bags per warp, 64-byte rows
# (groups of 4 lanes), 1,200-byte rows (three slices of 32 lanes), and
# int64 indices (kinds ending in "64")
BAG_CASES = [
    (50, 128, 4, 6, False, "sum", torch.float32, "ref"),
    (200, 128, 8, 10, True, "sum", torch.float32, "ref"),
    (100, 256, 3, 5, True, "mean", torch.float32, "ref"),
    (64, 128, 16, 4, False, "mean", torch.float32, "ref"),
    (32, 128, 5, 7, True, "sum", torch.bfloat16, "ref"),
    (10, 128, 2, 3, False, "sum", torch.float32, "all_pad"),
    (1000, 50, 33, 50, True, "mean", torch.bfloat16, "ref"),
    (5000, 50, 100, 1, False, "sum", torch.float32, "one"),
    (300, 300, 7, 40, True, "sum", torch.float32, "ref"),
    (300, 33, 10, 13, True, "sum", torch.float32, "ref"),
    (300, 33, 9, 3, False, "mean", torch.bfloat16, "ref"),
    (100, 16, 77, 2, True, "sum", torch.float32, "ref"),
    (700, 300, 6, 70, False, "mean", torch.float32, "ref"),
    (2000, 64, 37, 20, True, "mean", torch.bfloat16, "ref64"),
    (5000, 50, 1001, 1, False, "sum", torch.float32, "one64"),
    (10, 128, 2, 3, True, "mean", torch.bfloat16, "all_pad"),
]
BAG_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}     # rtol = atol


def bag_case(rng, v, d, b, l, weighted, kind, dt, dev):
    """Seeded normal table (V, D) in ``dt``, int32 idx (B, L) (int64 for
    a kind ending in "64") with 20 % pads (-1; all pads for "all_pad",
    none for the one-index kinds) and positive weights (B, L) or None."""
    table = torch.from_numpy(rng.normal(size=(v, d)).astype(np.float32))
    idx = rng.integers(0, v, size=(b, l)).astype(np.int32)
    if kind == "all_pad":
        idx[:] = -1
    elif not kind.startswith("one"):
        idx[rng.random((b, l)) < 0.2] = -1
    if kind.endswith("64"):
        idx = idx.astype(np.int64)
    # positive weights keep mean mode's sum of weights away from 0
    w = torch.from_numpy(np.abs(rng.normal(size=(b, l))).astype(np.float32)
                         + 0.1).to(dev) if weighted else None
    return table.to(dev, dt), torch.from_numpy(idx).to(dev), w


def bag_check(got, table, idx, w, mode, kind) -> tuple:
    """(passes, max |err|, the tolerance in words) of one kernel result,
    against the plain version in fp32 on the same (rounded) inputs."""
    if kind == "all_pad":
        err = float(got.float().abs().max())
        return err == 0.0, err, "exactly 0"
    wt = None if w is None else w.to(table.dtype).float()
    want = ebops.embedding_bag(table.float(), idx, wt, mode=mode,
                               use_ref=True)
    diff = (got.float() - want).abs()
    if kind.startswith("one"):   # one index, weight 1: the row, bit for bit
        return bool(torch.equal(got, table[idx[:, 0].long()])), \
            float(diff.max()), "bit for bit"
    tol = BAG_TOL[table.dtype]
    return bool((diff <= tol + tol * want.abs()).all()), float(diff.max()), \
        f"rtol = atol = {tol}"


def bag_edge_cases(seed: int, dev):
    """Yield (case, result, bag_check's verdict) for every case of
    BAG_CASES."""
    rng = np.random.default_rng(seed)
    for case in BAG_CASES:
        v, d, b, l, weighted, mode, dt, kind = case
        table, idx, w = bag_case(rng, v, d, b, l, weighted, kind, dt, dev)
        got = ebops.embedding_bag(table, idx, w, mode=mode)
        sync(dev)
        yield case, got, bag_check(got, table, idx, w, mode, kind)


# A bag index past the table, in a process of its own: the kernel traps,
# which ends the process's CUDA context, and the error must surface at
# the next synchronisation (the wrapper itself reads nothing back)
BAG_OOB_SCRIPT = """
import sys
import torch
sys.path.insert(0, sys.argv[1])
from repro_torch.kernels.embedding_bag import kernel
table = torch.zeros((5, 3), device="cuda")
idx = torch.tensor([[0, -1], [4, 5]], dtype=torch.int32, device="cuda")
kernel.embedding_bag(table, idx)
print("launched", flush=True)
try:
    torch.cuda.synchronize()
except RuntimeError as e:
    print("error at synchronize:", str(e).strip().splitlines()[0],
          flush=True)
    sys.exit(0)
sys.exit(3)
"""


def bag_out_of_range() -> str:
    """Run BAG_OOB_SCRIPT; return the CUDA error it saw at the
    synchronisation, or raise."""
    proc = subprocess.run(
        [sys.executable, "-c", BAG_OOB_SCRIPT,
         str(Path(__file__).resolve().parent / "src")],
        capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or len(lines) != 2 or lines[0] != "launched":
        raise PhaseError(f"embedding_bag with an index past the table: exit "
                         f"{proc.returncode}, stdout {proc.stdout!r}, stderr "
                         f"{proc.stderr[-2000:]!r}")
    return lines[1]


def bag_bound(table, idx, w) -> float:
    """Bound ms (bytes): idx (and weights) once, each distinct row read
    once (row 0 for pads), the output once, over the HBM rate."""
    rows = int(torch.unique(idx.clamp(min=0)).numel())
    es = table.element_size()
    nbytes = idx.numel() * idx.element_size() \
        + (0 if w is None else w.numel() * es) \
        + rows * table.shape[1] * es + idx.shape[0] * table.shape[1] * es
    return nbytes / HBM_BYTES_PER_S * 1e3


def bag_full_runs(seed: int, dev, cfg) -> tuple:
    """sasrec's table (``cfg``'s rows, fp32) and, by label, (idx, mode,
    bag_check kind) of its train_batch bags (65,536 histories of seq_len
    items, 20 % pads; sum and mean) and of phase 5's one-index lookups (a
    512-user batch's histories, retrieval_cand's 1,000,000 candidates)."""
    from repro_torch.models.sasrec import table_rows
    gen = torch.Generator(device=dev).manual_seed(seed)
    table = torch.randn((table_rows(cfg), cfg.d_embed), generator=gen,
                        device=dev) * 0.02
    big = torch.randint(1, cfg.n_items + 1, (65_536, cfg.seq_len),
                        generator=gen, device=dev, dtype=torch.int32)
    big[torch.rand(big.shape, generator=gen, device=dev) < 0.2] = -1
    one = torch.randint(1, cfg.n_items + 1, (512 * cfg.seq_len, 1),
                        generator=gen, device=dev, dtype=torch.int32)
    cands = torch.randint(1, cfg.n_items + 1, (1_000_000, 1),
                          generator=gen, device=dev, dtype=torch.int32)
    return table, {"train_batch sum": (big, "sum", "ref"),
                   "train_batch mean": (big, "mean", "ref"),
                   "encode 512x50 one-index": (one, "sum", "one"),
                   "retrieval 1M one-index": (cands, "sum", "one")}


def phase_bag(seed: int, reps: int, device: str = "cuda",
              cfg=None) -> dict:
    import torch.nn.functional as F
    dev = torch.device(device)
    max_err = 0.0
    for case, got, (ok, err, tol) in bag_edge_cases(seed, dev):
        v, d, b, l, weighted, mode, dt, kind = case
        if got.dtype != dt or tuple(got.shape) != (b, d):
            raise PhaseError(f"embedding_bag V={v} D={d}: got {got.dtype} "
                             f"{tuple(got.shape)}")
        if not ok:
            raise PhaseError(f"embedding_bag V={v} D={d} B={b} L={l} {mode} "
                             f"{dt} ({kind}): max |err| {err} exceeds {tol}")
        if dt == torch.float32:
            max_err = max(max_err, err)
        print(f"embedding_bag == plain at V={v} D={d} B={b} L={l} "
              f"weighted={weighted} {mode} {dt} ({kind}): max |err| "
              f"{err:.3g} ({tol})", flush=True)
    if dev.type == "cuda":
        # no synchronising call, int32 and int64, sum and mean, weighted
        rng = np.random.default_rng(seed + 1)
        for kind, dt in (("ref", torch.float32), ("ref64", torch.bfloat16)):
            table, idx, w = bag_case(rng, 500, 50, 64, 9, True, kind, dt,
                                     dev)
            for mode in ("sum", "mean"):
                sync_free(lambda: ebops.embedding_bag(table, idx, w, mode))
                sync_free(lambda: ebk.embedding_bag(table, idx, None,
                                                    mode == "mean"))
        print("embedding_bag wrappers (ops and kernel, int32 and int64, sum "
              "and mean) made no synchronising call", flush=True)
        print(f"embedding_bag with an index past the table, in a "
              f"subprocess: {bag_out_of_range()}", flush=True)

    cfg = cfg or get_arch("sasrec").config
    table, runs = bag_full_runs(seed, dev, cfg)
    n_rows, d = table.shape
    out = {}
    for label, (idx, mode, kind) in runs.items():
        got = ebops.embedding_bag(table, idx, mode=mode)
        ok, err, tol = bag_check(got, table, idx, None, mode, kind)
        if not ok:
            raise PhaseError(f"embedding_bag {label}: max |err| {err} "
                             f"exceeds {tol}")
        max_err = max(max_err, err)
        k_ms = time_ms(lambda: ebops.embedding_bag(table, idx, mode=mode),
                       reps)
        p_ms = time_ms(lambda: ebops.embedding_bag(table, idx, mode=mode,
                                                   use_ref=True),
                       max(3, reps // 4))
        # the library yardstick: F.embedding_bag, pads as row 0 weight 0
        lib_idx = idx.clamp(min=0).long()
        lib_w = (idx >= 0).float()
        l_ms = time_ms(lambda: F.embedding_bag(
            lib_idx, table, mode="sum", per_sample_weights=lib_w), reps)
        bound_ms = bag_bound(table, idx, None)
        print(f"kernel embedding_bag {label} V={n_rows} D={d} B="
              f"{idx.shape[0]} L={idx.shape[1]} fp32: {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms, F.embedding_bag {l_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms (bytes); max |err| {err:.3g} ({tol})",
              flush=True)
        if dev.type == "cuda":
            split = device_split(lambda: ebops.embedding_bag(table, idx,
                                                             mode=mode))
            print(f"embedding_bag {label}: device ms (torch.profiler, mean "
                  f"of 5 calls) {split}", flush=True)
        if dev.type == "cuda" and label.startswith("encode"):
            # a call of a few µs of work: its time is the wrapper's
            k_us = host_us(lambda: ebops.embedding_bag(table, idx,
                                                       mode=mode))
            l_us = host_us(lambda: F.embedding_bag(
                lib_idx, table, mode="sum", per_sample_weights=lib_w))
            print(f"embedding_bag {label}: host {k_us:.2f} µs per call, "
                  f"F.embedding_bag {l_us:.2f} µs", flush=True)
        out[label] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                      "bound_ms": bound_ms, "bound_by": "bytes"}
    del table, runs
    torch.cuda.empty_cache()
    return {"runs": out, "max_abs_err": max_err}


# ---------------------------------------------------------------------------
# Phase 3b: GNN training over the live snapshot
# ---------------------------------------------------------------------------

# Card vs CPU run of gin-tu, in lockstep: every step starts both runs from
# the card's parameters and optimizer state.  Independent fp32 runs of this
# model on this graph cannot be compared over many steps: GIN's sum
# aggregation over the power-law snapshot grows activations by about the
# in-degree per layer (logits of 1e10-1e11), the loss is a difference of
# such logits, and Adam turns the sign of every near-zero gradient
# component into a full step, so two fp32 runs drift apart whatever the
# device (on the CPU at 20k users, fp32 vs fp64: loss 30 % apart by step
# 10).  Within one step the two runs differ only by summation order:
GNN_LOGIT_TOL = 1e-3   # max |logit diff| / max |logit|: five layers of fp32
#                        sums over in-degrees up to ~31k (fp32 vs fp64 on
#                        the CPU at 20k users: 2.7e-5)
GNN_LOSS_TOL = 1e-3    # |loss diff| / mean over labelled vertices of max
#                        |logit| (the loss's own scale; relative to the loss
#                        itself it is ill-conditioned, H100 step 1: 1.1e-4)
GNN_GRAD_TOL = 2e-2    # worst parameter tensor's error in the step's share
#                        of each Adam moment, m - b1 m_0 = (1 - b1) g and
#                        v - b2 v_0 = (1 - b2) g^2 (both runs start from the
#                        same moments), relative to max(its norm,
#                        GNN_GRAD_FLOOR * the norm over all tensors): the
#                        backward pass, tensor by tensor.  H100 vs CPU over
#                        36 steps: up to 5.5e-4 (layers.1.mlp.0.w); a
#                        pre-activation near zero whose sign differs between
#                        the runs switches a ReLU path, so the error is
#                        heavy-tailed.  A doubled, halved or sign-flipped
#                        gradient reads 0.5 to 2
GNN_GRAD_FLOOR = 1e-3  # a GIN eps scalar's gradient is one cancelling sum
#                        over every feature of every vertex, often 1e-5 of
#                        the whole, so its error relative to itself is
#                        heavy-tailed too (H100 vs CPU: up to 9.2e-4)
GNN_STEP_TOL = 1e-4    # worst parameter tensor's ||dp - dp_adamw|| /
#                        ||dp_adamw||: the card's change against AdamW's
#                        update worked out in fp64 from the card's own
#                        moments, so fp32 rounding only; a frozen step reads
#                        1, a sign-flipped one 2.  (Against the CPU run's
#                        change it is no check: Adam turns a gradient element
#                        at its rounding noise into a full lr step either
#                        way, 5.8e-2 of one tensor's change in an H100 run)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want|| in fp64 (0 when both are zero)."""
    got, want = got.double(), want.double()
    num, den = float((got - want).norm()), float(want.norm())
    return num / den if den else (0.0 if num == 0 else float("inf"))


def moment_errs(card_m: dict, host_m: dict, m0: dict, decay: float) -> dict:
    """Per tensor, ||d_card - d_host|| / max(||d_host||, GNN_GRAD_FLOOR *
    ||all of d_host||) with d = m - decay * m0, the step's share of an
    Adam moment.  One tensor at a time in fp64 on the device of
    ``card_m``."""
    dev = next(iter(card_m.values())).device

    def share(m, k):
        return m[k].to(dev).double() - decay * m0[k].to(dev).double()

    norms = {k: float(share(host_m, k).norm()) for k in m0}
    floor = GNN_GRAD_FLOOR * float(np.sqrt(sum(n * n
                                                for n in norms.values())))
    return {k: float((share(card_m, k) - share(host_m, k)).norm())
            / max(norms[k], floor, 1e-300) for k in m0}


def update_errs(params: dict, state, p0: dict, opt) -> dict:
    """Per tensor, the relative error of the step's change of ``params``
    from ``p0`` against AdamW's update worked out in fp64 from the run's
    own moments ``state``: -lr (m^ / (sqrt(v^) + eps) + wd p0), in fp64 on
    the parameters' device."""
    t = int(state.step)
    lr = float(adamw.schedule_lr(opt, t))
    bc1, bc2 = 1 - opt.b1 ** t, 1 - opt.b2 ** t
    out = {}
    for k, p in params.items():
        m, v = state.mu[k].double(), state.nu[k].double()
        p0k = p0[k].to(p.device).double()
        want = -lr * (m / bc1 / ((v / bc2).sqrt() + opt.eps)
                      + opt.weight_decay * p0k)
        out[k] = rel_err(p.detach().double() - p0k, want)
    return out


def phase_gnn(w, seed: int, steps: int, device: str = "cuda") -> dict:
    """Train gin-tu at its published width on ``w``'s live snapshot, on
    ``device`` (the card) and, in lockstep, on the CPU in this process, on
    the same batches.  ``device="cpu"`` rehearses the phase without a
    card."""
    from repro_torch.data.pipeline import DynamicGraphPipeline, \
        batch_to_torch
    from repro_torch.models import gnn, mp
    from repro_torch.optim import AdamWConfig, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    cfg = get_arch("gin-tu").config           # 5 layers, d = 64
    _, stamp, _ = w.run_program("count_edges", [("u0", None)])
    ga = analytics.snapshot_arrays(w, stamp)
    pad_nodes = ga.n_nodes + 256              # room for the writers' vertices
    pad_edges = ga.edge_src.size + 4096       # the sentinel row is a hub
    pipe = DynamicGraphPipeline(w, d_feat=cfg.d_feat,
                                n_classes=cfg.n_classes,
                                pad_nodes=pad_nodes, pad_edges=pad_edges,
                                seed=seed)
    written = [0]

    def writer(wv):
        tx = wv.begin_tx()
        vid = tx.create_vertex(f"gnn{written[0]}")
        tx.create_edge(vid, "u0")
        written[0] += 1
        if not wv.run_tx(tx).ok:
            raise PhaseError("phase 3b: writer tx failed")

    card = gnn.init_model(cfg, torch.Generator().manual_seed(seed))
    host = gnn.init_model(cfg)
    host.load_state_dict(card.state_dict())
    card = card.to(dev)
    opt = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=30)
    step = make_train_step(lambda m, b: gnn.gnn_loss(m, b, cfg), opt)
    st_card = adamw.init(dict(card.named_parameters()))
    st_host = adamw.init(dict(host.named_parameters()))
    gen = torch.Generator().manual_seed(seed + 1)
    w_in = (torch.randn((cfg.d_feat, cfg.d_hidden), generator=gen)
            / cfg.d_feat ** 0.5).to(dev)
    w_hid = (torch.randn((cfg.d_hidden, cfg.d_hidden), generator=gen)
             / cfg.d_hidden ** 0.5).to(dev)
    print(f"gnn: gin-tu {cfg.n_layers} layers d={cfg.d_hidden} on the live "
          f"snapshot ({ga.n_nodes} vertices, {ga.edge_src.size} edges; "
          f"pads {pad_nodes}/{pad_edges})", flush=True)
    losses, secs = [], {"batch": 0.0, "kernel": 0.0, "cuda_step": 0.0,
                        "cpu_step": 0.0}
    mp_err = 0.0
    errs = []
    batches = pipe.batches(mutate_between=writer)
    for i in range(steps):
        t0 = time.perf_counter()
        b = next(batches)
        tc, th = batch_to_torch(b, dev), batch_to_torch(b, "cpu")
        t1 = time.perf_counter()
        secs["batch"] += t1 - t0
        src, dst = tc["edge_src"], tc["edge_dst"]
        hid = torch.tanh(tc["x"] @ w_in)
        mp.set_use_kernel(True)
        try:
            outs = [(xin, wm, mp.propagate_matmul(xin, wm, src, dst,
                                                  pad_nodes, dst_sorted=True))
                    for xin, wm in ((tc["x"], w_in), (hid, w_hid))]
        finally:
            mp.set_use_kernel(False)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        secs["kernel"] += t2 - t1
        for xin, wm, got in outs:
            rel, err, top = mp_errors(got, xin, wm, src, dst, pad_nodes)
            if not (rel <= MP_ROW_TOL and err <= MP_TOL * top):
                raise PhaseError(f"phase 3b batch {i}: propagate_matmul on "
                                 f"the kernel off by {err} (max |y| {top}), "
                                 f"{rel} of an output's rounding scale")
            mp_err = max(mp_err, rel)
        t3 = time.perf_counter()
        p0 = {k: v.detach().clone() for k, v in host.named_parameters()}
        mu0 = {k: v.clone() for k, v in st_host.mu.items()}
        nu0 = {k: v.clone() for k, v in st_host.nu.items()}
        with torch.no_grad():
            logits_c = card(tc).cpu()
        card, st_card, mc = step(card, st_card, tc)
        lc = float(mc["loss"])
        t4 = time.perf_counter()
        with torch.no_grad():
            logits_h = host(th)
        host, st_host, mh = step(host, st_host, th)
        lh = float(mh["loss"])
        t5 = time.perf_counter()
        secs["cuda_step"] += t4 - t3
        secs["cpu_step"] += t5 - t4
        top = logits_h.abs().amax(dim=-1)
        logit_err = float((logits_c - logits_h).abs().max() / top.max())
        loss_err = abs(lc - lh) / float(top[th["label_mask"] > 0].mean())
        grad_errs = moment_errs(st_card.mu, st_host.mu, mu0, opt.b1)
        grad_errs.update({f"{k} (v)": e for k, e in moment_errs(
            st_card.nu, st_host.nu, nu0, opt.b2).items()})
        step_errs = update_errs(dict(card.named_parameters()), st_card, p0,
                                opt)
        g_key = max(grad_errs, key=grad_errs.get)
        s_key = max(step_errs, key=step_errs.get)
        grad_err, step_err = grad_errs[g_key], step_errs[s_key]
        errs.append((logit_err, loss_err, grad_err, step_err))
        print(f"gnn step {i + 1}: {int(b['label_mask'].sum())} live "
              f"vertices, loss cuda {lc!r} cpu {lh!r}, max |logit| "
              f"{float(top.max()):.4g}, grad norm {float(mh['grad_norm']):.4g}"
              f"; errors logits {logit_err:.3g} loss {loss_err:.3g} grad "
              f"{grad_err:.3g} ({g_key}) step {step_err:.3g} ({s_key}); "
              f"batch {t1 - t0:.2f} s, cuda step {t4 - t3:.3f} s, cpu step "
              f"{t5 - t4:.2f} s", flush=True)
        if not (np.isfinite(lc) and logit_err <= GNN_LOGIT_TOL
                and loss_err <= GNN_LOSS_TOL and grad_err <= GNN_GRAD_TOL
                and step_err <= GNN_STEP_TOL):
            raise PhaseError(
                f"phase 3b step {i + 1}: card != CPU (logits {logit_err} > "
                f"{GNN_LOGIT_TOL}, loss {loss_err} > {GNN_LOSS_TOL}, "
                f"gradient {grad_err} > {GNN_GRAD_TOL} or step {step_err} > "
                f"{GNN_STEP_TOL}), or loss {lc}")
        losses.append((lc, lh))
        host.load_state_dict({k: v.cpu() for k, v in
                              card.state_dict().items()})
        st_host = adamw.AdamWState(
            step=st_card.step.cpu(),
            mu={k: v.cpu() for k, v in st_card.mu.items()},
            nu={k: v.cpu() for k, v in st_card.nu.items()})
    worst = [max(e[k] for e in errs) for k in range(4)]
    print(f"gnn: card == CPU in lockstep over {steps} AdamW steps (worst "
          f"errors: logits {worst[0]:.3g} <= {GNN_LOGIT_TOL}, loss "
          f"{worst[1]:.3g} <= {GNN_LOSS_TOL}, gradient {worst[2]:.3g} <= "
          f"{GNN_GRAD_TOL} (floor {GNN_GRAD_FLOOR} of the whole), step "
          f"{worst[3]:.3g} <= {GNN_STEP_TOL}); "
          f"propagate_matmul on the kernel worst output {mp_err:.3g} of its "
          f"rounding scale <= {MP_ROW_TOL}; host seconds "
          + ", ".join(f"{k} {v:.2f}" for k, v in secs.items())
          + f"; snapshot engine {pipe.snapshot_stats()}", flush=True)
    return {"losses": losses, "errors": worst, "secs": secs}


# ---------------------------------------------------------------------------
# Phase 3: the system end to end (also held against the JAX reference by
# tests/test_torch_weaver.py, which imports make_stream / run_stream)
# ---------------------------------------------------------------------------

def serve_loops(n: int) -> list:
    """The serving steps' client fleets for ``n`` requests in the first
    loop: (loop, clients or rate factor, requests, read share).  A closed
    loop of 64 clients at TAO's published read share (0.998, the
    reference ``serve_graph``'s setting), one of 16 clients at 0.75 so
    that writes contend, and an open loop at half the first loop's
    simulated throughput."""
    if n <= 0:
        return []
    return [("closed", 64, n, 0.998), ("closed", 16, max(1, n // 5), 0.75),
            ("open", 0.5, max(1, n // 4), 0.998)]


def make_stream(seed: int, n_users: int, avg_degree: int = 14,
                n_tx: int = 300, n_prog: int = 50, chunk: int = 512,
                kill: str = None, gc_period: float = 0.05,
                serve_requests: int = 0) -> list:
    """A seeded op stream: bulk load in ``chunk``-op transactions, then a
    shuffled mix of ``n_tx`` small transactions and ``n_prog`` of each
    node program, with GC, async submissions, snapshots, the serving
    steps of :func:`serve_loops` (``serve_requests`` > 0: TAO requests
    from ``synth.tao_workload`` on live vertices, through the package's
    ``GraphQueryServer``) and (optionally) a shard kill plus promotion.
    Edges are named by creation index."""
    rng = np.random.default_rng(seed)
    users = [f"u{i}" for i in range(n_users)]
    edges = synth.social_graph(rng, n_users, avg_degree)
    steps = [("tx", [("cv", v) for v in users[i:i + chunk]])
             for i in range(0, n_users, chunk)]
    steps += [("tx", [("ce", s, d) for s, d in edges[i:i + chunk]])
              for i in range(0, len(edges), chunk)]
    n_edges = len(edges)
    n_new = 0
    deleted = set()      # program roots avoid these: a program whose roots
    #                      are all gone from the store never completes

    def pick() -> str:
        return users[int(rng.integers(n_users))]

    def prog(name: str) -> tuple:
        u, v = pick(), pick()
        while u in deleted:
            u = pick()
        params = {"traverse": {"depth": 0, "max_depth": 2},
                  "reachable": {"target": v},
                  "sssp": {"target": v, "max_depth": 3},
                  "get_edges": None, "count_edges": None,
                  "clustering": {"phase": 0}}[name]
        return ("prog", name, [(u, params)])

    def tx() -> tuple:
        nonlocal n_edges, n_new
        ops = []
        for _ in range(int(rng.integers(1, 4))):
            r = rng.random()
            if r < 0.3:
                ops.append(("ce", pick(), pick()))
                n_edges += 1
            elif r < 0.45:
                ops.append(("se", int(rng.integers(n_edges)), "weight",
                            float(rng.integers(1, 10))))
            elif r < 0.6:
                ops.append(("de", int(rng.integers(n_edges))))
            elif r < 0.75:
                ops.append(("sv", pick(), "age", int(rng.integers(100))))
            elif r < 0.92:
                vid = f"n{n_new}"
                n_new += 1
                ops += [("cv", vid), ("ce", vid, pick())]
                n_edges += 1
            else:
                vid = users[1 + int(rng.integers(n_users - 1))]  # keep u0
                deleted.add(vid)
                ops.append(("dv", vid))
        return ("tx", ops)

    kinds = ["tx"] * n_tx + [p for p in PROGRAMS for _ in range(n_prog)]
    mixed = []
    for k in rng.permutation(len(kinds)).tolist():
        mixed.append(tx() if kinds[k] == "tx" else prog(kinds[k]))
    half = len(mixed) // 2
    steps += mixed[:half]
    steps += [("settle", 1.2 * gc_period),   # a GC pass runs
              prog("count_edges"), ("snap", False),
              ("async", [prog(p)[1:] for p in PROGRAMS])]
    steps += mixed[half:]
    live = [u for u in users if u not in deleted]
    loops = [(loop, arg, synth.tao_workload(rng, n, read_frac, vertices=live))
             for loop, arg, n, read_frac in serve_loops(serve_requests)]
    steps += [("serve", loops)] if loops else []
    steps += [prog("count_edges"), ("snap", True)]
    if kill is not None:
        steps += [("kill", kill), prog("traverse"), prog("count_edges"),
                  ("snap", True)]
    return steps


def _stamp(s):
    return None if s is None else (s.epoch, tuple(s.clock), s.gk, s.ctr)


def tao_request(w, ops: list, i: int) -> tuple:
    """Request ``i`` of a TAO op list as the reference's ``serve_graph``
    maps it: reads are node programs, ``create_edge`` a one-op tx, and
    ``delete_edge`` deletes the first edge ``read_vertex`` shows, else
    touches a property (as ``examples/social_serve.py`` does)."""
    op = ops[i]
    if op["type"] in ("get_edges", "count_edges", "get_node"):
        return "prog", (op["type"], [(op["v"], None)])
    tx = w.begin_tx()
    if op["type"] == "create_edge":
        tx.create_edge(op["v"], op["u"])
    else:
        ed = w.read_vertex(op["v"])
        if ed and ed["edges"]:
            tx.delete_edge(op["v"], next(iter(ed["edges"])))
        else:
            tx.set_vertex_prop(op["v"], "touch", i)
    return "tx", tx


def serve_loop(server, w, loop_ops: tuple, first: list) -> tuple:
    """One client fleet of a serving step through ``server`` (a
    ``GraphQueryServer``): the loop's returned dict, plus each request's
    ``(index, ok, latency)`` in completion order.  An open loop's rate is
    its factor times the step's first closed loop's simulated throughput
    (``first``)."""
    loop, arg, ops = loop_ops
    done = []
    cur = {}

    def make_request(i):
        cur["i"] = i
        return tao_request(w, ops, i)

    issue = server._issue

    def recorded(kind, payload, on_done):
        i = cur["i"]          # both loops call make_request(i) just before

        def _done(ok, latency):
            done.append((i, ok, latency))
            on_done(ok, latency)

        issue(kind, payload, _done)

    server._issue = recorded
    try:
        if loop == "closed":
            res = server.run_closed_loop(arg, len(ops), make_request)
            first.append(res["throughput_per_s"])
        else:
            res = server.run_open_loop(arg * first[0], len(ops),
                                       make_request)
    finally:
        server._issue = issue
    return ("serve", loop, res, done)


def run_stream(core, analytics_mod, cfg, steps: list, device=None,
               around_serve=None) -> list:
    """Run ``steps`` through a fresh ``core.Weaver(cfg)`` and return one
    comparable record per step plus the final counters.  ``core`` and
    ``analytics_mod`` are the package's modules, and serving steps go
    through that package's ``runtime.GraphQueryServer``, so the same
    driver runs the port and (in the tests) the JAX reference.
    ``around_serve``, a context manager factory, is entered around each
    serving step."""
    w = core.Weaver(cfg)
    server_cls = importlib.import_module(
        core.__name__.split(".")[0] + ".runtime").GraphQueryServer
    server = server_cls(w)
    vis_kw = {} if device is None else {"device": device}
    handles = []
    out = []
    last = None
    for step in steps:
        kind = step[0]
        if kind == "serve":
            with (around_serve or contextlib.nullcontext)():
                first = []
                out += [serve_loop(server, w, loop, first)
                        for loop in step[1]]
        elif kind == "tx":
            t = w.begin_tx()
            for op in step[1]:
                if op[0] == "cv":
                    t.create_vertex(op[1])
                elif op[0] == "ce":
                    handles.append(t.create_edge(op[1], op[2]))
                elif op[0] == "de":
                    t.delete_edge(handles[op[1]])
                elif op[0] == "se":
                    t.set_edge_prop(handles[op[1]], op[2], op[3])
                elif op[0] == "sv":
                    t.set_vertex_prop(op[1], op[2], op[3])
                elif op[0] == "dv":
                    t.delete_vertex(op[1])
            r = w.run_tx(t)
            out.append(("tx", r.ok, r.error, _stamp(r.stamp), r.retries,
                        r.latency))
        elif kind == "prog":
            res, stamp, lat = w.run_program(step[1], step[2], timeout=60.0)
            last = stamp
            out.append(("prog", step[1], res, _stamp(stamp), lat))
        elif kind == "async":
            box = []
            for name, entries in step[1]:
                w.submit_program(name, entries,
                                 lambda r, s, l, name=name: box.append(
                                     (name, r, _stamp(s), l)))
            deadline = w.sim.now + 60.0
            while len(box) < len(step[1]) and w.sim.pending() \
                    and w.sim.now < deadline:
                w.sim.run(until=min(deadline, w.sim.now + 5e-3))
            out.append(("async", box))
        elif kind == "settle":
            w.settle(step[1])
            out.append(("settle", w.sim.now))
        elif kind == "kill":
            w.kill(step[1])
            w.settle(0.1)            # heartbeat loss -> promote_backup
            out.append(("kill", w.manager.epoch))
        elif kind == "snap":
            ga = analytics_mod.snapshot_arrays(w, last, keep_raw=step[1])
            rec = ["snap", list(ga.vids[:ga.n_nodes]), ga.edge_src,
                   ga.edge_dst, ga.csc_src, ga.csc_dst]
            if step[1]:
                src, dst, mask = analytics_mod.visible_edges_at(
                    ga, last, cfg.n_gatekeepers, **vis_kw)
                rec += [ga.raw_src, ga.raw_dst, ga.edge_create,
                        ga.edge_delete, src, dst, mask]
            out.append(tuple(rec))
    out.append(("counters", w.counters()))
    return out, w


def diff_records(a: list, b: list) -> list:
    """Human-readable mismatches between two run_stream outputs."""
    def same(x, y) -> bool:
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            x, y = np.asarray(x), np.asarray(y)
            return x.shape == y.shape and x.dtype == y.dtype \
                and np.array_equal(x, y)
        if isinstance(x, (list, tuple)) and isinstance(y, (list, tuple)):
            return len(x) == len(y) and all(same(p, q) for p, q in zip(x, y))
        if isinstance(x, dict) and isinstance(y, dict):
            return x.keys() == y.keys() and all(same(x[k], y[k]) for k in x)
        return x == y

    bad = []
    if len(a) != len(b):
        bad.append(f"{len(a)} records vs {len(b)}")
    for i, (x, y) in enumerate(zip(a, b)):
        if not same(x, y):
            bad.append(f"step {i} ({x[0]}): {str(x)[:200]} != {str(y)[:200]}")
    return bad


def canon(ga) -> tuple:
    """Order-free snapshot form: vid set + vid-pair edge multiset."""
    vids = ga.vids[:ga.n_nodes]
    return sorted(vids), sorted(zip((vids[i] for i in ga.edge_src.tolist()),
                                    (vids[i] for i in ga.edge_dst.tolist())))


class BoundaryClock:
    """Host seconds spent in the port's stamp-compare entry points (host
    to device copy, kernel, device to host copy), by wrapping them for
    the duration of a run: where the system phase's time goes."""

    def __init__(self):
        from repro_torch.core import writepath
        from repro_torch.dist.columns import DeviceColumnPlane
        self.sites = [(analytics, "_before_batch"),
                      (analytics, "visible_edges_at"),
                      (writepath, "before_pairs"),
                      (DeviceColumnPlane, "before_all")]
        self.secs = {name: 0.0 for _, name in self.sites}
        self.calls = {name: 0 for _, name in self.sites}
        self.each = {name: [] for _, name in self.sites}

    def __enter__(self):
        self._saved = [(obj, name, getattr(obj, name))
                       for obj, name in self.sites]
        for obj, name, fn in self._saved:
            def timed(*a, _fn=fn, _name=name, **kw):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **kw)
                finally:
                    dt = time.perf_counter() - t0
                    self.secs[_name] += dt
                    self.calls[_name] += 1
                    self.each[_name].append(dt)
            setattr(obj, name, timed)
        return self

    def __exit__(self, *exc):
        for obj, name, fn in self._saved:
            setattr(obj, name, fn)

    def line(self) -> str:
        """Calls, seconds and median µs per call of each entry point."""
        return ", ".join(
            f"{k} {self.calls[k]} calls {self.secs[k]:.3f} s (median "
            f"{statistics.median(self.each[k] or [0.0]) * 1e6:.1f} us)"
            for k in self.secs)


def plane_mask_forms(plane, reps: int = 20) -> dict:
    """Median host ms of each part of one ``DeviceColumnPlane.before_all``
    and its ``masks_for`` calls over the plane's resident blocks at the
    last query it answered, in two forms: bytes (a bool per row copied
    back, then a view per block and table) and bits (the plane's form:
    an int32 word per 32 rows copied back, then each block's synced rows
    unpacked by ``np.unpackbits``).  Parts: launch (the wrapper's host
    time), wait (until the kernel is done), copy (device to host, into
    numpy) and masks.  The two forms' masks must be equal."""
    if plane._masks_q is None:
        raise PhaseError("plane forms: the plane answered no query")
    qd = torch.from_numpy(np.frombuffer(plane._masks_q, np.int32).copy()
                          ).to(plane.device)
    blocks = plane._blocks
    s_, t_, cap = blocks.shape[:3]
    rows = blocks.view(-1, plane.c)
    # (block, table, synced rows): tables 0, 1 hold vertices, 2, 3 edges
    spans = [(bi, t, cur[t // 2]) for bi, cur in enumerate(plane._consumed)
             for t in range(t_)]

    def form(bits: bool):
        t0 = time.perf_counter()
        out = (mvk.before(rows, qd, bits=True) if bits
               else mvops.before_mask(rows, qd))
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host = out.cpu().numpy()
        t3 = time.perf_counter()
        if bits:
            w = host.view(np.uint8)
            masks = [np.unpackbits(w[(bi * t_ + t) * cap // 8:], count=n,
                                   bitorder="little").view(bool)
                     for bi, t, n in spans]
        else:
            m = host.reshape(s_, t_, cap)
            masks = [m[bi, t, :n] for bi, t, n in spans]
        t4 = time.perf_counter()
        return masks, {"launch": t1 - t0, "wait": t2 - t1, "copy": t3 - t2,
                       "masks": t4 - t3, "call": t4 - t0}

    out, masks = {}, {}
    for name, bits in (("bytes", False), ("bits", True)):
        parts = []
        for i in range(reps + 3):
            torch.cuda.synchronize()
            masks[name], secs = form(bits)
            if i >= 3:                              # after 3 warm-ups
                parts.append(secs)
        out[name] = {k: statistics.median(p[k] for p in parts) * 1e3
                     for k in parts[0]}
    if any(not np.array_equal(a, b)
           for a, b in zip(masks["bytes"], masks["bits"])):
        raise PhaseError("plane forms: the bit form's masks != the byte "
                         "form's")
    out["rows"] = int(rows.shape[0])
    out["synced_rows"] = int(sum(n for _, _, n in spans))
    return out


def run_on(device: str, seed: int, n_users: int, plane: bool, n_prog: int,
           n_tx: int, serve_requests: int = 0):
    """One run of the deployment's seeded stream on ``device``: (steps,
    records, launch counts of this run, host seconds, entry-point line,
    the serving steps' figures (``serve_clock``), the Weaver)."""
    steps = make_stream(seed, n_users, n_tx=n_tx, n_prog=n_prog,
                        gc_period=GC_PERIOD, serve_requests=serve_requests)
    cfg = core.WeaverConfig(n_gatekeepers=2, n_shards=4, device=device,
                            device_shard_columns=plane,
                            write_group_commit=1e-3, seed=seed,
                            gc_period=GC_PERIOD,
                            wal_checkpoint_every=WAL_CHECKPOINT_EVERY)
    mvk.reset_launches()                     # counts of THIS run only
    serving = {}
    t0 = time.perf_counter()
    with BoundaryClock() as bc:
        recs, w = run_stream(core, analytics, cfg, steps, device=device,
                             around_serve=lambda: serve_clock(device,
                                                              serving))
        sync(device)
    secs = time.perf_counter() - t0
    return steps, recs, dict(mvk.launches), secs, bc.line(), serving, w


@contextlib.contextmanager
def serve_clock(device: str, out: dict):
    """Around the serving steps: the stamp compares' launch counts set to
    0 before and read after (then added back to the run's), host wall
    clock to a synchronise, and the entry points' line, into ``out``."""
    saved = dict(mvk.launches)
    mvk.reset_launches()
    t0 = time.perf_counter()
    with BoundaryClock() as bc:
        yield
        sync(device)
    out.update(secs=time.perf_counter() - t0, counts=dict(mvk.launches),
               line=bc.line())
    for k, v in saved.items():
        mvk.launches[k] += v


def cpu_twin(*args):
    """``run_on("cpu", ...)`` for a worker process (the number of steps
    in place of the steps; no Weaver returned)."""
    steps, *rest, _ = run_on("cpu", *args)
    return (len(steps), *rest)


def serve_summary(label: str, device: str, recs: list, serving: dict) -> None:
    """Print the serving steps' host figures and each loop's simulated
    goodput, p50 and p99."""
    loops = [r for r in recs if r[0] == "serve"]
    if not loops:
        return
    n = sum(len(r[3]) for r in loops)
    print(f"{label} device={device}: serving steps {n} requests in "
          f"{serving['secs']:.2f} s host wall clock "
          f"({serving['secs'] / n * 1e6:.1f} us host per request), "
          f"launches {serving['counts']}", flush=True)
    print(f"{label} device={device}: serving entry points "
          f"{serving['line']}", flush=True)
    if device != "cuda":
        return
    for r in loops:
        res = r[2]
        lat = np.asarray(res["latencies_s"]) * 1e3
        rate = (f" offered {res['offered_per_s']:.1f}/s"
                if "offered_per_s" in res else "")
        print(f"{label} serving {r[1]} loop (simulated):{rate} issued "
              f"{res['issued']} ok {res['ok']} goodput "
              f"{res['goodput_per_s']:.1f}/s p50 "
              f"{np.percentile(lat, 50):.3f} ms p99 "
              f"{np.percentile(lat, 99):.3f} ms", flush=True)


def deployment(label: str, seed: int, n_users: int, plane: bool,
               n_prog: int, n_tx: int, oracle: bool, keep: bool = False,
               serve_requests: int = 0):
    """Run one seeded stream on the card and, at the same time in a
    worker process, on the CPU; compare the two runs.  Returns the card
    run's launch counts, its Weaver when ``keep`` (else None) and its
    serving steps' launch counts (None without serving steps)."""
    args = (seed, n_users, plane, n_prog, n_tx, serve_requests)
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=1, mp_context=ctx) as pool:
        twin = pool.submit(cpu_twin, *args)
        steps, recs, counts, secs, line, serving, w = run_on("cuda", *args)
        n_load = sum(1 for s in steps if s[0] == "tx" and len(s[1]) > 64)
        print(f"{label} device=cuda: {len(steps)} steps ({n_load} load "
              f"txs) in {secs:.2f} s host wall clock, launches {counts}",
              flush=True)
        print(f"{label} device=cuda: stamp-compare entry points {line}",
              flush=True)
        serve_summary(label, "cuda", recs, serving)
        n_e = sum(c.n_e for c in (sh.partition.columns for sh in w.shards)
                  if c is not None)
        print(f"{label}: {n_e} edge rows resident, plane stats "
              f"{None if w.device_plane is None else w.device_plane.stats}",
              flush=True)
        if oracle:
            _, stamp, _ = w.run_program("count_edges", [("u0", None)])
            got = analytics.snapshot_arrays(w, stamp)
            want = analytics.snapshot_arrays_python(w, stamp)
            if canon(got) != canon(want):
                raise PhaseError(f"{label}: engine snapshot != Python "
                                 f"snapshot oracle")
            print(f"{label}: snapshot == per-object Python oracle "
                  f"({got.n_nodes} vertices, {got.edge_src.size} edges)",
                  flush=True)
        if not keep:
            w = None
        (n_steps, cpu_recs, cpu_counts, cpu_secs, cpu_line,
         cpu_serving) = twin.result()
    print(f"{label} device=cpu (worker process, concurrent): {n_steps} "
          f"steps in {cpu_secs:.2f} s host wall clock, launches "
          f"{cpu_counts}", flush=True)
    print(f"{label} device=cpu: stamp-compare entry points {cpu_line}",
          flush=True)
    serve_summary(label, "cpu", cpu_recs, cpu_serving)
    bad = diff_records(recs, cpu_recs)
    if bad:
        raise PhaseError(f"{label}: CUDA run != CPU run:\n"
                         + "\n".join(bad[:10]))
    if any(cpu_counts.values()):
        raise PhaseError(f"{label}: the CPU run launched kernels: "
                         f"{cpu_counts}")
    print(f"{label}: CUDA run == CPU run over {len(steps)} steps "
          f"(results, TxResults, counters, snapshot arrays, "
          f"visible_edges_at{', serving loops' if serving else ''})",
          flush=True)
    return counts, w, serving.get("counts")


# ---------------------------------------------------------------------------
# Phase 3c: snapshot traversals on the card, against host oracles
# ---------------------------------------------------------------------------

CC_MAX_DEG = 256      # clustering's padded rows: the graph's largest
#                       out-degree (~30k) would make a ~12 GB table
CC_SAMPLE = 2000      # clustering vertices held to the oracle (plus the
#                       20 of largest degree)
PR_RTOL, PR_ATOL = 1e-4, 1e-9   # fp32 card pagerank vs fp64 numpy: 20
#                                 rounds of sums of ~14 terms each


def padded_table(src: np.ndarray, dst: np.ndarray, n: int, max_deg: int):
    """The reference's padded neighbour table, built by its per-edge loop
    (the oracle of ``clustering_coefficients_padded``'s vectorised
    build): rows in stable ``argsort(src)`` order, self-loops skipped, at
    most ``max_deg`` per row, sorted, padded with ``n``."""
    table = np.full((n, max_deg), n, dtype=np.int32)
    counts = np.zeros(n, dtype=np.int64)
    for e in np.argsort(src, kind="stable").tolist():
        u, v = int(src[e]), int(dst[e])
        if u == v or counts[u] >= max_deg:
            continue
        table[u, counts[u]] = v
        counts[u] += 1
    table.sort(axis=1)
    return table, counts


def clustering_oracle(table: np.ndarray, counts: np.ndarray, n: int,
                      verts: np.ndarray) -> np.ndarray:
    """Clustering coefficients of ``verts`` over the padded table, in
    numpy: links = the row's entries found in each listed neighbour's
    row, over k(k - 1) in fp32."""
    out = np.zeros(verts.size, np.float32)
    for j, u in enumerate(verts.tolist()):
        row = table[u][table[u] < n]
        if row.size == 0:
            continue
        hit = (table[row][:, :, None] == row[None, None, :]).any(axis=1)
        k = int(counts[u])
        if k >= 2:
            out[j] = np.float32(hit.sum()) / np.float32(k * (k - 1))
    return out


def phase_traversals(w, seed: int, reps: int,
                     device: str = "cuda") -> dict:
    """Phase 3c: the snapshot traversals of ``core.analytics`` on
    ``device`` over ``snapshot_arrays`` of the deployment's last program
    stamp, each held to a host oracle (exact but pagerank) and timed with
    CUDA events beside its bound: the edge arrays' bytes (int32 src and
    dst, and sssp's fp32 weights) per round times the rounds, over
    3.35 TB/s (clustering: its padded table's bytes once)."""
    from scipy.sparse import coo_matrix, csgraph

    _, stamp, _ = w.run_program("count_edges", [("u0", None)])
    ga = analytics.snapshot_arrays(w, stamp)
    n, src, dst = ga.n_nodes, ga.edge_src, ga.edge_dst
    e = int(src.size)
    rng = np.random.default_rng(seed)
    weights = rng.integers(1, 10, e).astype(np.float32)
    s_d = torch.from_numpy(src).to(device)
    d_d = torch.from_numpy(dst).to(device)
    w_d = torch.from_numpy(weights).to(device)
    i0 = ga.index["u0"]
    target = int(rng.integers(n))
    inf = int(analytics.INF)

    # host oracles
    unw = coo_matrix((np.ones(e), (src, dst)), shape=(n, n)).tocsr()
    want_bfs = csgraph.shortest_path(unw, unweighted=True, indices=i0)
    want_bfs = np.where(np.isinf(want_bfs), inf, want_bfs).astype(np.int32)
    _, comp = csgraph.connected_components(unw, directed=False)
    first = np.full(comp.max() + 1, n, np.int64)
    np.minimum.at(first, comp, np.arange(n))
    want_cc = first[comp].astype(np.int32)
    key = src.astype(np.int64) * n + dst          # parallel edges: min weight
    order = np.lexsort((weights, key))
    key_s, w_s = key[order], weights[order]
    keep = np.r_[True, key_s[1:] != key_s[:-1]]
    wmat = coo_matrix((w_s[keep].astype(np.float64),
                       (key_s[keep] // n, key_s[keep] % n)),
                      shape=(n, n)).tocsr()
    want_sssp = csgraph.dijkstra(wmat, indices=i0)
    want_sssp = np.where(np.isinf(want_sssp), 3.4e38,
                         want_sssp).astype(np.float32)
    deg = np.maximum(np.bincount(src, minlength=n), 1).astype(np.float64)
    want_pr = np.full(n, 1.0 / n)
    for _ in range(20):
        want_pr = (1.0 - 0.85) / n + 0.85 * np.bincount(
            dst, weights=want_pr[src] / deg[src], minlength=n)
    table, counts = padded_table(src, dst, n, CC_MAX_DEG)
    verts = np.unique(np.concatenate([
        rng.choice(n, min(CC_SAMPLE, n), replace=False),
        np.argsort(-counts, kind="stable")[:20]]))
    want_clu = clustering_oracle(table, counts, n, verts)

    def exact(want, at=slice(None)):
        return lambda got: int(np.count_nonzero(got[at] != want))

    # name: (call, bytes per round, rounds from its segment reductions,
    #        mismatches against the oracle)
    runs = {
        "bfs_levels_ga": (
            lambda: analytics.bfs_levels_ga(ga, [i0], device=device),
            8 * e, lambda k: k, exact(want_bfs)),
        "connected_components_ga": (
            lambda: analytics.connected_components_ga(ga, device=device),
            8 * e, lambda k: k // 2, exact(want_cc)),
        "pagerank_ga": (
            lambda: analytics.pagerank_ga(ga, device=device),
            8 * e, lambda k: k - 1,
            lambda got: int(np.count_nonzero(~np.isclose(
                got, want_pr, rtol=PR_RTOL, atol=PR_ATOL)))),
        "sssp_weighted": (
            lambda: analytics.sssp_weighted(s_d, d_d, w_d, n, [i0]),
            12 * e, lambda k: k, exact(want_sssp)),
        "clustering_coefficients_padded": (
            lambda: analytics.clustering_coefficients_padded(
                s_d, d_d, n, CC_MAX_DEG),
            4 * n * CC_MAX_DEG, lambda k: 1, exact(want_clu, verts)),
    }
    out = {}
    reduce_ = analytics._segment_reduce
    for name, (fn, nbytes, rounds_of, mismatches) in runs.items():
        calls = []

        def counted(*a, **kw):
            calls.append(1)
            return reduce_(*a, **kw)

        analytics._segment_reduce = counted
        try:
            got = fn().cpu().numpy()
        finally:
            analytics._segment_reduce = reduce_
        bad = mismatches(got)
        max_err = (float(np.max(np.abs(got - want_pr)))
                   if name == "pagerank_ga" else 0.0)
        if bad:
            raise PhaseError(f"traversals: {name} differs from its oracle at "
                             f"{bad} vertices (max |err| {max_err})")
        rounds = rounds_of(len(calls))
        ms = time_ms(fn, reps=reps, warmup=1) if device == "cuda" else None
        bound = nbytes * rounds / HBM_BYTES_PER_S * 1e3
        out[name] = {"rounds": rounds, "ms": ms, "bound_ms": bound,
                     "max_abs_err": max_err}
        timed = "not timed" if ms is None else f"{ms:.4f} ms"
        print(f"traversals: {name} == host oracle (max |err| {max_err:.3g}); "
              f"{rounds} rounds, {timed}, bound {bound:.4f} ms (bytes)",
              flush=True)
    got = analytics.reachable(s_d, d_d, n, i0, target)
    if got != bool(want_bfs[target] < inf):
        raise PhaseError(f"traversals: reachable(u0, {target}) = {got}")
    print(f"traversals over {n} vertices, {e} edges: reachable(u0 -> "
          f"{target}) = {got} as the oracle; eccentricity from u0 "
          f"{int(want_bfs[want_bfs < inf].max())}, {int(comp.max()) + 1} "
          f"components; clustering held at {verts.size} vertices",
          flush=True)
    return out


# (module, argv) of the database's entry points, each run with --device
# cuda and --device cpu
ENTRY_POINTS = (
    ("repro_torch.launch.serve", ["--mode", "graph"]),
    ("repro_torch.examples.quickstart", []),
    ("repro_torch.examples.social_serve", []),
    ("repro_torch.examples.coingraph", []),
)


def phase_entry_points(devices=("cuda", "cpu")) -> dict:
    """Each database entry point's ``main(argv + ["--device", d])`` for
    each device in this process: every call must exit 0, the card's must
    launch the stamp compares, and all must print the same text (their
    simulated figures).  Returns the launch counts of each card call."""
    counts = {}
    for mod, argv in ENTRY_POINTS:
        main_fn = importlib.import_module(mod).main
        outs = {}
        for dev in devices:
            buf = io.StringIO()
            mvk.reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = main_fn(argv + ["--device", dev])
            sync(dev)
            secs = time.perf_counter() - t0
            if rc != 0:
                raise PhaseError(f"entry points: {mod} --device {dev} "
                                 f"exited {rc}")
            outs[dev] = buf.getvalue()
            if dev == "cuda":
                counts[mod] = dict(mvk.launches)
                if not any(counts[mod].values()):
                    raise PhaseError(f"entry points: {mod} launched no "
                                     f"stamp compare on the card")
            print(f"entry points: {' '.join([mod] + argv)} --device {dev}: "
                  f"exit 0 in {secs:.2f} s host wall clock", flush=True)
        if len(set(outs.values())) != 1:
            raise PhaseError(f"entry points: {mod} printed differently on "
                             f"{' and '.join(devices)}: {outs}")
        text = outs[devices[0]].strip().splitlines()
        print(f"entry points: {mod} printed the same {len(text)} lines on "
              f"{' and '.join(devices)}; first: {text[0][:120]}", flush=True)
    return counts


# ---------------------------------------------------------------------------
# Phase 4: LM serving (gemma3-1b at its published width and depth)
# ---------------------------------------------------------------------------

LM_LOGIT_TOL = 5e-2    # per step, max |logit diff| / max |logit| between the
#                        kernel path and its plain twin, both in bf16 over
#                        26 layers: the two round p (unnormalised vs
#                        normalised) and sum in different orders, each
#                        layer adding bf16 noise of ~2^-8 of an attention
#                        output.  Measured on an H100 (700 W) by
#                        scripts/flash_mutants.py: the kernel reads 0.018;
#                        broken copies of it read 0.66 (a 64-key tile
#                        skipped), 0.16 (the causal mask dropping the own
#                        key) and 0.15 (seeing one future key)


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


@contextlib.contextmanager
def attention_held(att: list):
    """Inside, every ``faops.mha`` call's result is held against its plain
    version as phase 2c holds it (``flash_check``); each call appends
    (passes, error in row-scale units, prefill?) to ``att``."""
    mha = faops.mha

    def checked(q, k, v, causal=True, window=None, kv_len=None, **kw):
        got = mha(q, k, v, causal=causal, window=window, kv_len=kv_len, **kw)
        ok, _, rel, _ = flash_check(got, q, k, v, causal, window, kv_len,
                                    "plain")
        att.append((ok, rel, q.shape[1] > 1))
        return got

    faops.mha = checked
    try:
        yield
    finally:
        faops.mha = mha


def phase_lm(seed: int, batch: int, prompt: int, steps: int,
             device: str = "cuda", cfg=None, params=None,
             label: str = "phase 4") -> dict:
    """gemma3-1b (or ``cfg``, with ``params`` when given, else random
    weights from ``seed``) behind ``LMServer``: one batch of prompts,
    then greedy decode steps; the plain twin (``set_use_kernel(False)``,
    same weights) runs in lockstep on the kernel path's tokens.
    ``device="cpu"`` with a reduced ``cfg`` rehearses the phase."""
    from repro_torch.models import transformer
    from repro_torch.runtime import LMServer
    cfg = cfg or get_arch("gemma3-1b").config
    t0 = time.perf_counter()
    if params is None:
        params = transformer.init_params(cfg, seed=seed, device=device)
    sync(device)
    print(f"lm: {cfg.name} {cfg.n_layers} layers d={cfg.d_model} heads "
          f"{cfg.n_heads}/{cfg.n_kv}x{cfg.d_head} d_ff={cfg.d_ff} vocab "
          f"{cfg.vocab} windows {cfg.window_pattern} {cfg.dtype}: "
          f"{_tree_bytes(params) / 1e9:.3f} GB of weights made on {device} "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)
    prompts = np.random.default_rng(seed).integers(0, cfg.vocab,
                                                   (batch, prompt))
    max_len = prompt + steps
    kern = LMServer(params, cfg, batch, max_len, device=device)
    plain = LMServer(params, cfg, batch, max_len, device=device)

    def plain_call(fn, *a):
        transformer.set_use_kernel(False)
        try:
            return fn(*a)
        finally:
            transformer.set_use_kernel(True)

    def compare(lk, lp) -> tuple:
        top = float(lp.float().abs().max())
        err = float((lk.float() - lp.float()).abs().max()) / top
        agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
        return err, agree

    # the first prefill of each path also pays one-time set-up (GEMM
    # heuristics, lazy module loads): timed and reported, then both are
    # timed again warm; prefill starts a fresh cache, so this changes
    # nothing downstream
    t0 = time.perf_counter()
    kern.prefill(prompts)
    sync(device)
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain_call(plain.prefill, prompts)
    sync(device)
    plain_cold_s = time.perf_counter() - t0
    fak.reset_launches()
    t0 = time.perf_counter()
    lk = kern.prefill(prompts)
    sync(device)
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lp = plain_call(plain.prefill, prompts)
    sync(device)
    plain_prefill_s = time.perf_counter() - t0
    errs, agrees = [], []
    err, agree = compare(lk, lp)
    errs.append(err)
    agrees.append(agree)
    tok = lk.argmax(-1)
    step_s, plain_step_s, toks = [], [], []
    for _ in range(steps):
        toks.append(tok)
        t0 = time.perf_counter()
        lk = kern.step(tok)
        sync(device)
        step_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        lp = plain_call(plain.step, tok)
        sync(device)
        plain_step_s.append(time.perf_counter() - t0)
        err, agree = compare(lk, lp)
        errs.append(err)
        agrees.append(agree)
        tok = lk.argmax(-1)
    launches = fak.launches["flash_attention"]
    variants = {k: fak.launches[k] for k in ("flash_tc", "flash_decode",
                                            "flash_simt")}
    # every attention call of the kernel path, held to its plain version
    # in a second, untimed pass over the same prompts and tokens: the
    # logits compare 26 layers of bf16 noise, these one call each
    att = []
    with attention_held(att):
        kern.prefill(prompts)
        for t in toks:
            kern.step(t)
    att_pre = max(r for _, r, pre in att if pre) / 2 ** -8
    att_dec = max(r for _, r, pre in att if not pre) / 2 ** -8
    print(f"lm: batch {batch} prompt {prompt} + {steps} greedy steps "
          f"(max_len {max_len}); prefill {prefill_s * 1e3:.2f} ms (plain twin "
          f"{plain_prefill_s * 1e3:.2f} ms; first calls {cold_s * 1e3:.2f} / "
          f"{plain_cold_s * 1e3:.2f} ms), decode step median "
          f"{statistics.median(step_s) * 1e3:.2f} ms (plain twin "
          f"{statistics.median(plain_step_s) * 1e3:.2f} ms), first "
          f"{step_s[0] * 1e3:.2f} ms; host wall clock to a synchronise",
          flush=True)
    print(f"lm: kernel path vs plain twin in lockstep: max |logit diff| / "
          f"max |logit| per call: prefill {errs[0]:.3g}, decode worst "
          f"{max(errs[1:]):.3g} (tolerance {LM_LOGIT_TOL}); greedy tokens "
          f"agree {statistics.mean(agrees):.4f} (worst call "
          f"{min(agrees):.4f}; reported, not required: bf16 near-ties over "
          f"{cfg.vocab} logits); flash_attention launches {launches} "
          f"{variants}; each of the {len(att)} attention calls against its "
          f"plain version: worst {att_pre:.3g} (prefill) / {att_dec:.3g} "
          f"(decode) * 2^-8 of |want| + row rms", flush=True)
    if not all(np.isfinite(errs)) or max(errs) > LM_LOGIT_TOL:
        raise PhaseError(f"{label}: kernel path != plain twin: logit errors "
                         f"{errs} (tolerance {LM_LOGIT_TOL})")
    if not all(ok for ok, _, _ in att):
        raise PhaseError(f"{label}: {sum(not ok for ok, _, _ in att)} of "
                         f"{len(att)} attention calls differ from their plain "
                         f"version (worst {att_pre:.3g} / {att_dec:.3g} * 2^-8 "
                         f"of the row scale; {FLASH_TOL} and FLASH_ROW_TOL)")
    want = {"flash_tc": cfg.n_layers, "flash_decode": cfg.n_layers * steps,
            "flash_simt": 0}
    if device == "cuda" and (variants != want
                             or launches != cfg.n_layers * (1 + steps)):
        raise PhaseError(f"{label}: flash_attention launches {launches} "
                         f"{variants}, expected {cfg.n_layers} x (1 + "
                         f"{steps}): {want}")
    del kern, plain, params
    if device == "cuda":
        torch.cuda.empty_cache()
    return {"launches": launches, "variants": variants,
            "attention_errors": (att_pre, att_dec),
            "prefill_ms": prefill_s * 1e3,
            "plain_prefill_ms": plain_prefill_s * 1e3,
            "step_ms": statistics.median(step_s) * 1e3, "errors": errs,
            "agree": agrees}


# ---------------------------------------------------------------------------
# Phase 5: SASRec serving (the published config)
# ---------------------------------------------------------------------------

REC_SCORE_TOL = 1e-6   # max |score diff| / max |score|: the bag of one index
#                        with weight 1 is the row itself, so the two paths
#                        should agree bit for bit (0 expected)


def rec_bad_id(srv, hist: np.ndarray, top: np.ndarray) -> str:
    """An item id one past the table, then -1, sent to the live server
    must raise IndexError (checked on the host, before any upload), and
    the next top_k must equal ``top``, the server's earlier answer."""
    rows = srv.params["item_emb"].shape[0]
    errors = []
    for wrong, call in ((rows, "top_k"), (-1, "score")):
        bad = hist[:2].copy()
        bad[0, -1] = wrong
        try:
            if call == "top_k":
                srv.top_k(bad, k=10)
            else:
                srv.score(hist[:1], bad[:1])
        except IndexError as e:
            errors.append(f"{call}: {e}")
            continue
        raise PhaseError(f"phase 5: item id {wrong} in {call} did not raise "
                         f"IndexError")
    again = srv.top_k(hist, k=10)
    sync(srv.device)
    if not np.array_equal(again, top):
        raise PhaseError("phase 5: after a bad item id the server's top_k "
                         "differs from its earlier answer")
    return (f"bad item ids raised IndexError ({'; '.join(errors)}); the next "
            f"top_k equals the earlier answer")


# An item id past the table sent to a RecServer on the card, in a process
# of its own (had the id reached the bag kernel, its trap would end the
# process's CUDA context): it must raise IndexError, and the same server
# must then answer a good call as before
REC_BAD_ID_SCRIPT = """
import sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from repro_torch.configs import get_arch
from repro_torch.launch.train import reduced_config
from repro_torch.models import sasrec
from repro_torch.runtime import RecServer
cfg = reduced_config(get_arch("sasrec"))
srv = RecServer(sasrec.init_params(cfg, seed=0), cfg)
hist = np.random.default_rng(0).integers(1, cfg.n_items + 1, (4, cfg.seq_len))
top = srv.top_k(hist, k=5)
bad = hist.copy()
bad[0, 0] = srv.params["item_emb"].shape[0]
try:
    srv.top_k(bad, k=5)
except IndexError as e:
    print("IndexError:", e, flush=True)
again = srv.top_k(hist, k=5)
torch.cuda.synchronize()
print("same" if np.array_equal(top, again) else "differs", flush=True)
"""


def rec_bad_id_subprocess() -> str:
    """Run REC_BAD_ID_SCRIPT; return its IndexError line, or raise."""
    proc = subprocess.run(
        [sys.executable, "-c", REC_BAD_ID_SCRIPT,
         str(Path(__file__).resolve().parent / "src")],
        capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or len(lines) != 2 or lines[1] != "same" \
            or not lines[0].startswith("IndexError"):
        raise PhaseError(f"RecServer with an item id past the table: exit "
                         f"{proc.returncode}, stdout {proc.stdout!r}, stderr "
                         f"{proc.stderr[-2000:]!r}")
    return lines[0]


def phase_rec(seed: int, batch: int, n_cand: int,
              device: str = "cuda", cfg=None) -> dict:
    """SASRec (or ``cfg``) behind ``RecServer``: catalog top-10 for
    ``batch`` users and one user's ``n_cand`` candidate scores, held
    against the plain path (direct indexing, ``set_use_kernel(False)``)
    on the same weights.  ``device="cpu"`` with a reduced ``cfg``
    rehearses the phase."""
    from repro_torch.models import sasrec
    from repro_torch.runtime import RecServer
    cfg = cfg or get_arch("sasrec").config
    params = sasrec.init_params(cfg, seed=seed, device=device)
    srv = RecServer(params, cfg, device=device)
    rng = np.random.default_rng(seed)
    hist = rng.integers(1, cfg.n_items + 1, (batch, cfg.seq_len))
    short = rng.random(batch) < 0.2              # short histories, left-padded
    hist[short, :rng.integers(1, cfg.seq_len)] = 0
    cands = rng.integers(1, cfg.n_items + 1, (1, n_cand))
    ebk.reset_launches()
    t0 = time.perf_counter()
    top = srv.top_k(hist, k=10)
    t1 = time.perf_counter()
    scores = srv.score(hist[:1], cands)
    t2 = time.perf_counter()
    launches = ebk.launches["embedding_bag"]
    sasrec.set_use_kernel(False)
    try:
        top_p = srv.top_k(hist, k=10)
        scores_p = srv.score(hist[:1], cands)
    finally:
        sasrec.set_use_kernel(True)
    err = float(np.abs(scores - scores_p).max() / np.abs(scores_p).max())
    same_sets = sum(set(a) == set(b) for a, b in zip(top, top_p))
    print(f"rec: {cfg.name} {cfg.n_items} items d={cfg.d_embed} "
          f"{cfg.n_blocks} blocks seq {cfg.seq_len}: top_k(k=10) for "
          f"{batch} users {(t1 - t0) * 1e3:.2f} ms, score of {n_cand} "
          f"candidates {(t2 - t1) * 1e3:.2f} ms (host wall clock, results "
          f"copied back); against direct indexing: candidate scores max "
          f"|diff| / max |score| {err:.3g} (tolerance {REC_SCORE_TOL}), "
          f"top-10 sets equal for {same_sets}/{batch} users; embedding_bag "
          f"launches {launches}", flush=True)
    if not np.isfinite(scores).all() or err > REC_SCORE_TOL \
            or same_sets != batch or top.shape != (batch, 10):
        raise PhaseError(f"phase 5: kernel path != plain path (score error "
                         f"{err}, {same_sets}/{batch} equal top-10 sets)")
    if device == "cuda" and not launches:
        raise PhaseError("phase 5: embedding_bag was never launched")
    print(f"rec: {rec_bad_id(srv, hist, top)}", flush=True)
    del srv, params
    return {"launches": launches, "top_k_ms": (t1 - t0) * 1e3,
            "score_ms": (t2 - t1) * 1e3, "score_err": err}


# ---------------------------------------------------------------------------
# Phase 6: LM and SASRec training (runtime.Trainer; no kernel on the grad
# path, the kernels on the no-grad paths)
# ---------------------------------------------------------------------------

TRAIN_LOSS_TOL = 1e-4   # per step, |loss card - loss CPU| / |loss CPU| in
#                        the fp32 locksteps: both start the step from the
#                        same parameters and moments, so summation order only
TRAIN_GNORM_TOL = 1e-3  # the same for the global gradient norm
RESUME_TOL = 1e-3       # |loss after on_failure - uninterrupted loss| / loss
#                        on the same batches from the restored stamp (a
#                        bit-exact restore of bf16 parameters and fp32
#                        moments; only non-deterministic device sums could
#                        part them)
NOGRAD_LOSS_TOL = 1e-5  # |lm_loss kernel seam on - off| / loss under
#                        no_grad: bf16 attention outputs rounded differently
#                        (unnormalised vs normalised p), through every layer;
#                        1.48e-06 measured at batch 8 on an H100 (4.22e-07
#                        at batch 4), so ~7x the noise; each attention call
#                        is also held to its plain version (FLASH_TOL,
#                        FLASH_ROW_TOL)
ENTRY_LOSS_TOL = 2e-2   # |final loss cuda - cpu| / loss of the training
#                        entry points: 50-200 AdamW steps from the same
#                        weights and batches, each device's rounding carried
#                        along (Adam turns noise-level gradients into full
#                        steps), printed to 4 decimals


# the sizes main gives phases 6a-6d (6e runs reduced configs at fixed
# sizes), by --train-sizes.  "full": 6b keeps train_4k's seq and cuts its
# batch 256 -> 8: the card holds more (the peak, 28.2 GiB on an H100, is
# the same at batch 4 and 8), but each sequence adds ~0.49 s to each of
# the phase's 16 steps, and the script must finish in its time limit
TRAIN_SIZES = {
    "full": {
        "6a": dict(layers=6, batch=2, seq=128, steps=3),
        "6b": dict(layers=26, batch=8, seq=4096, steps=10, ckpt_every=5),
        "6c": dict(layers=2, seq=4096, steps=4, lock_tokens=128,
                   lock_steps=2, serve_batch=2, serve_prompt=256,
                   serve_steps=8),
        "6d": dict(batch=65_536, steps=5, lock_batch=512, lock_steps=3),
    },
    "rehearsal": {
        "6a": dict(layers=2, batch=2, seq=128, steps=3),
        "6b": dict(layers=6, batch=2, seq=512, steps=10, ckpt_every=5),
        "6c": dict(layers=2, seq=512, steps=4, lock_tokens=128,
                   lock_steps=2, serve_batch=2, serve_prompt=256,
                   serve_steps=8),
        "6d": dict(batch=4096, steps=5, lock_batch=512, lock_steps=3),
    },
}


def fit_step(trainer, batch) -> None:
    """One step through ``trainer.fit`` over an iterator that holds only
    ``batch``: fit stops at the iterator's end (``StopIteration``) before
    the trainer's ``total_steps``, so no checkpoint is written."""
    try:
        trainer.fit(iter([batch]))
    except StopIteration:
        return
    raise PhaseError(f"trainer reached its total_steps at {trainer.step}")


def _kernel_launches() -> dict:
    return {"flash_attention": fak.launches["flash_attention"],
            "embedding_bag": ebk.launches["embedding_bag"]}


def _no_kernel_on_grad_path(label: str) -> None:
    got = _kernel_launches()
    if any(got.values()):
        raise PhaseError(f"{label}: kernels launched on the grad path: {got}")


def _host_copy(model):
    """A CPU ParamTree holding a copy of ``model``'s parameters."""
    from repro_torch.models.layers import ParamTree, module_tree, tree_like
    tree = module_tree(model)
    return ParamTree(tree_like(tree, {
        k: v.detach().cpu().clone()
        for k, v in model.named_parameters()}))


def train_lockstep(label: str, card_tr, host_tr, batches: list, opt) -> dict:
    """``card_tr`` and ``host_tr``, the same model and optimizer on the
    card and on the CPU, take ``fit_step`` on the same batches in turn.
    Per step the losses and global gradient norms, each tensor's Adam
    moments' step share (``moment_errs``) and the card's change against
    AdamW in fp64 from its own moments (``update_errs``) must agree; then
    the CPU trainer takes the card's parameters and moments, so each step
    starts equal."""
    from repro_torch.optim.adamw import AdamWState
    worst = {"loss": 0.0, "grad_norm": 0.0, "moments": 0.0, "update": 0.0}
    secs = {"card": [], "cpu": []}
    for i, b in enumerate(batches):
        card = dict(card_tr.model.named_parameters())
        p0 = {k: v.detach().clone() for k, v in card.items()}
        mu0 = {k: v.clone() for k, v in card_tr.opt_state.mu.items()}
        nu0 = {k: v.clone() for k, v in card_tr.opt_state.nu.items()}
        t0 = time.perf_counter()
        fit_step(card_tr, b)
        sync(card_tr.device)
        t1 = time.perf_counter()
        fit_step(host_tr, b)
        t2 = time.perf_counter()
        secs["card"].append(t1 - t0)
        secs["cpu"].append(t2 - t1)
        lc, lh = card_tr.history[-1]["loss"], host_tr.history[-1]["loss"]
        gc = float(card_tr.last_metrics["grad_norm"])
        gh = float(host_tr.last_metrics["grad_norm"])
        st_c, st_h = card_tr.opt_state, host_tr.opt_state
        errs = {"loss": abs(lc - lh) / abs(lh),
                "grad_norm": abs(gc - gh) / abs(gh)}
        g = moment_errs(st_c.mu, st_h.mu, mu0, opt.b1)
        g.update({f"{k} (v)": e for k, e in moment_errs(
            st_c.nu, st_h.nu, nu0, opt.b2).items()})
        u = update_errs(card, st_c, p0, opt)
        g_key, u_key = max(g, key=g.get), max(u, key=u.get)
        errs["moments"], errs["update"] = g[g_key], u[u_key]
        for k in worst:
            worst[k] = max(worst[k], errs[k])
        print(f"{label} step {i + 1}: loss card {lc!r} cpu {lh!r}, grad norm "
              f"{gc:.6g} / {gh:.6g}; errors loss {errs['loss']:.3g} grad norm "
              f"{errs['grad_norm']:.3g} moments {g[g_key]:.3g} ({g_key}) "
              f"update {u[u_key]:.3g} ({u_key}); card step {t1 - t0:.3f} s, "
              f"cpu step {t2 - t1:.2f} s", flush=True)
        if not (np.isfinite(lc) and errs["loss"] <= TRAIN_LOSS_TOL
                and errs["grad_norm"] <= TRAIN_GNORM_TOL
                and errs["moments"] <= GNN_GRAD_TOL
                and errs["update"] <= GNN_STEP_TOL):
            raise PhaseError(
                f"{label} step {i + 1}: card != CPU: {errs} (tolerances loss "
                f"{TRAIN_LOSS_TOL}, grad norm {TRAIN_GNORM_TOL}, moments "
                f"{GNN_GRAD_TOL}, update {GNN_STEP_TOL})")
        del p0, mu0, nu0
        if i == len(batches) - 1:
            break
        with torch.no_grad():
            for k, p in host_tr.model.named_parameters():
                p.copy_(card[k].detach().cpu())
        host_tr.opt_state = AdamWState(
            step=st_c.step.cpu(), mu={k: v.cpu() for k, v in st_c.mu.items()},
            nu={k: v.cpu() for k, v in st_c.nu.items()})
    print(f"{label}: card == CPU in lockstep over {len(batches)} steps "
          f"through Trainer (worst: loss {worst['loss']:.3g} <= "
          f"{TRAIN_LOSS_TOL}, grad norm {worst['grad_norm']:.3g} <= "
          f"{TRAIN_GNORM_TOL}, moments {worst['moments']:.3g} <= "
          f"{GNN_GRAD_TOL}, update {worst['update']:.3g} <= {GNN_STEP_TOL}); "
          f"host s per step card {[round(x, 3) for x in secs['card']]}, cpu "
          f"{[round(x, 2) for x in secs['cpu']]}", flush=True)
    return {"errors": worst, "secs": secs}


def lockstep_trainers(loss_fn, model, opt, tmp: str) -> tuple:
    """Trainers of ``model`` on its device and of a CPU copy, each with a
    checkpoint directory under ``tmp`` that ``fit_step`` never writes."""
    from repro_torch.runtime import Trainer, TrainerConfig
    host = _host_copy(model)
    mk = lambda m, d: Trainer(loss_fn, m, opt, TrainerConfig(  # noqa: E731
        total_steps=10 ** 6, ckpt_every=10 ** 6, log_every=10 ** 6,
        ckpt_dir=str(Path(tmp) / d)))
    return mk(model, "card"), mk(host, "cpu")


def _dir_bytes(path: str) -> int:
    return sum(f.stat().st_size for f in Path(path).iterdir())


def phase_lm_lockstep(seed: int, layers: int, batch: int, seq: int,
                      steps: int, device: str = "cuda", cfg=None) -> dict:
    """6a: gemma3-1b at full width (or ``cfg``), depth cut to ``layers``,
    fp32, trained through Trainer on the card and on the CPU in
    lockstep."""
    from repro_torch.models import transformer
    from repro_torch.models.layers import ParamTree
    from repro_torch.optim import AdamWConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(cfg or get_arch("gemma3-1b").config,
                              n_layers=layers, dtype="float32")
    print(f"6a lm lockstep: {cfg.name} d={cfg.d_model} heads {cfg.n_heads}/"
          f"{cfg.n_kv}x{cfg.d_head} d_ff={cfg.d_ff} vocab {cfg.vocab}; cut: "
          f"depth {get_arch('gemma3-1b').config.n_layers} -> {layers} "
          f"(windows {[int(w) for w in cfg.layer_windows()]}), fp32, batch "
          f"{batch} x {seq}, {steps} steps", flush=True)
    model = ParamTree(transformer.init_params(cfg, seed=seed, device=device))
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=steps)
    gen = synth.token_batches(np.random.default_rng(seed), cfg.vocab, batch,
                              seq)
    batches = [next(gen) for _ in range(steps)]
    with tempfile.TemporaryDirectory() as tmp:
        card_tr, host_tr = lockstep_trainers(
            lambda m, b: transformer.lm_loss(m.tree(), b, cfg), model, opt,
            tmp)
        fak.reset_launches()
        ebk.reset_launches()
        out = train_lockstep("6a lm lockstep", card_tr, host_tr, batches,
                             opt)
        _no_kernel_on_grad_path("6a")
    return out


def _device_us(event) -> float:
    """A profiler event's own device time in µs (the attribute's name
    changed across torch versions)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def step_profile(step_fn, model, state, batch, top: int = 10) -> dict:
    """One more training step under ``torch.profiler`` on the card: its
    host ms to the loss read, the device ms summed over its kernels (so
    the device's idle share) and the operators whose kernels took the
    most device time, with their input shapes."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        t0 = time.perf_counter()
        _, _, m = step_fn(model, state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages(group_by_input_shape=True)
    # kernels carry the device time; the operators that launched them
    # carry the same time again, with their input shapes
    kernel = [e for e in events
              if "CUDA" in str(getattr(e, "device_type", ""))]
    device = sum(_device_us(e) for e in kernel) / 1e3
    ops = sorted(((_device_us(e) / 1e3, e.key, str(e.input_shapes))
                  for e in events if e not in kernel and _device_us(e) > 0),
                 reverse=True)
    return {"wall_ms": wall * 1e3, "device_ms": device,
            "idle_share": 1 - device / (wall * 1e3), "ops": ops[:top]}


def phase_lm_train(seed: int, batch: int, seq: int, steps: int,
                   ckpt_every: int, device: str = "cuda", cfg=None) -> dict:
    """6b: gemma3-1b (or ``cfg``) at full width and depth, bf16 parameters
    with fp32 moments, trained through Trainer on Zipfian tokens with
    checkpoints; then the last save torn, ``on_failure`` restores the one
    before it and the steps after it run again on the same batches; last,
    the trained weights' lm_loss under no_grad with the kernel seam on
    and off."""
    from repro_torch.data.pipeline import batch_to_torch
    from repro_torch.models import transformer
    from repro_torch.models.layers import ParamTree
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import Trainer, TrainerConfig
    cfg = cfg or get_arch("gemma3-1b").config
    full = get_arch("gemma3-1b").shapes["train_4k"].dims
    print(f"6b lm train: {cfg.name} {cfg.n_layers} layers d={cfg.d_model} "
          f"vocab {cfg.vocab} {cfg.dtype} params, fp32 moments, loss_chunks "
          f"{cfg.loss_chunks}, remat {cfg.remat}; cut: train_4k's batch "
          f"{full['batch']} -> {batch} (seq {seq}; train_4k's {full['seq']}), "
          f"{steps} steps, ckpt every {ckpt_every}", flush=True)
    model = ParamTree(transformer.init_params(cfg, seed=seed, device=device))
    n_params = sum(p.numel() for p in model.parameters())
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=steps)
    gen = synth.token_batches(np.random.default_rng(seed), cfg.vocab, batch,
                              seq)
    batches = [next(gen) for _ in range(steps)]
    tmp = tempfile.mkdtemp()
    try:
        tr = Trainer(lambda m, b: transformer.lm_loss(m.tree(), b, cfg),
                     model, opt, TrainerConfig(
                         total_steps=steps, ckpt_every=ckpt_every,
                         ckpt_dir=tmp, log_every=10 ** 6))
        saves = []
        save = tr.store.save

        def timed_save(state, step, extra=None):
            sync(device)
            t0 = time.perf_counter()
            st = save(state, step, extra)
            saves.append(time.perf_counter() - t0)
            return st

        tr.store.save = timed_save
        fak.reset_launches()
        ebk.reset_launches()
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr.fit(iter(batches))
        fit_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        _no_kernel_on_grad_path("6b")
        losses = [h["loss"] for h in tr.history]
        step_s = [h["time_s"] for h in tr.history]
        last = tr.store.latest()
        ckpt_bytes = _dir_bytes(last.path)
        warm = statistics.median(step_s[1:])
        print(f"6b lm train: {n_params / 1e9:.4f}B parameters; losses "
              f"{[round(x, 4) for x in losses]}; step ms median of steps "
              f"2-{steps} {warm * 1e3:.2f} (first {step_s[0] * 1e3:.2f}), "
              f"{batch * seq / warm:.1f} tokens/s (host wall clock to the "
              f"loss read); max_memory_allocated "
              f"{peak / 2 ** 30:.2f} GiB; checkpoint {ckpt_bytes / 1e9:.3f} "
              f"GB at step {last.step}, saves {[round(x, 2) for x in saves]} "
              f"s; fit {fit_s:.1f} s", flush=True)
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise PhaseError(f"6b: loss not finite or not falling: {losses}")
        # a failure that tears the last save: restart from the one before
        os.remove(os.path.join(last.path, "MANIFEST.json"))
        t0 = time.perf_counter()
        tr.on_failure()
        sync(device)
        restore_s = time.perf_counter() - t0
        if tr.step != steps - ckpt_every or tr.store.epoch != 1:
            raise PhaseError(f"6b: resumed at step {tr.step}, epoch "
                             f"{tr.store.epoch}")
        tr.fit(iter(batches[tr.step:]))
        again = [h["loss"] for h in tr.history[steps:]]
        diff = max(abs(a - b) / abs(b)
                   for a, b in zip(again, losses[steps - ckpt_every:]))
        print(f"6b lm train: step {steps}'s save torn (manifest removed); "
              f"on_failure restored step {steps - ckpt_every} (epoch 1) in "
              f"{restore_s:.2f} s; rerun losses {[round(x, 4) for x in again]}"
              f", largest relative difference from the uninterrupted run "
              f"{diff:.3g} (tolerance {RESUME_TOL})", flush=True)
        if len(again) != ckpt_every or not diff <= RESUME_TOL:
            raise PhaseError(f"6b: rerun after on_failure {again} != "
                             f"{losses[steps - ckpt_every:]}")
        _no_kernel_on_grad_path("6b rerun")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    tb = batch_to_torch(batches[-1], device)
    att = []
    with torch.no_grad():
        fak.reset_launches()
        with attention_held(att):
            on = float(transformer.lm_loss(model.tree(), tb, cfg)[0])
        launches = _kernel_launches()
        transformer.set_use_kernel(False)
        try:
            off = float(transformer.lm_loss(model.tree(), tb, cfg)[0])
        finally:
            transformer.set_use_kernel(True)
    err = abs(on - off) / abs(off)
    att_worst = max((r for _, r, _ in att), default=0.0) / 2 ** -8
    print(f"6b lm train: lm_loss under no_grad, seam on {on!r} off {off!r}: "
          f"relative difference {err:.3g} (tolerance {NOGRAD_LOSS_TOL}); "
          f"launches {launches}; each of the {len(att)} attention calls "
          f"against its plain version: worst {att_worst:.3g} * 2^-8 of "
          f"|want| + row rms", flush=True)
    if not err <= NOGRAD_LOSS_TOL:
        raise PhaseError(f"6b: no-grad lm_loss seam on {on} != off {off}")
    if len(att) != cfg.n_layers or not all(ok for ok, _, _ in att):
        raise PhaseError(f"6b: {sum(not ok for ok, _, _ in att)} of "
                         f"{len(att)} attention calls differ from their plain "
                         f"version (worst {att_worst:.3g} * 2^-8 of the row "
                         f"scale; {FLASH_TOL} and FLASH_ROW_TOL)")
    if device == "cuda" and launches["flash_attention"] != cfg.n_layers:
        raise PhaseError(f"6b: flash_attention launched "
                         f"{launches['flash_attention']} times in the no-grad "
                         f"lm_loss, expected {cfg.n_layers}")
    prof = None
    if device == "cuda":
        # where a step's time goes: the Trainer's step once more, profiled
        # (after every check: it changes nothing checked above)
        prof = step_profile(tr.step_fn, tr.model, tr.opt_state, tb)
        print(f"6b lm train: one more step under torch.profiler: "
              f"{prof['wall_ms']:.2f} ms host wall clock, "
              f"{prof['device_ms']:.2f} ms of kernels (device idle share "
              f"{prof['idle_share']:.3f}); operators by device ms: "
              + "; ".join(f"{ms:.2f} {key} {shapes}"
                          for ms, key, shapes in prof["ops"]), flush=True)
    del tr, model
    if device == "cuda":
        torch.cuda.empty_cache()
    return {"step_ms": warm * 1e3, "tokens_per_s": batch * seq / warm,
            "peak_bytes": peak, "ckpt_bytes": ckpt_bytes, "save_s": saves,
            "restore_s": restore_s, "resume_diff": diff,
            "nograd_err": err, "attention_error": att_worst,
            "launches": launches["flash_attention"],
            "losses": losses, "profile": prof}


def phase_moe(seed: int, layers: int, seq: int, steps: int,
              lock_tokens: int, lock_steps: int, serve_batch: int,
              serve_prompt: int, serve_steps: int, device: str = "cuda",
              cfg=None) -> dict:
    """6c: moonshot-v1-16b-a3b (or ``cfg``) at full width, depth cut to
    ``layers``: an fp32 lockstep card against CPU at ``lock_tokens``
    tokens, then bf16 training at ``seq`` tokens through Trainer (loss,
    aux loss and the share of (token, slot) pairs over capacity), then
    LMServer on the trained weights against its plain twin (phase 4's
    checks)."""
    from repro_torch.models import moe, transformer
    from repro_torch.models.layers import ParamTree
    from repro_torch.optim import AdamWConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    full = cfg or get_arch("moonshot-v1-16b-a3b").config
    cfg = dataclasses.replace(full, n_layers=layers)
    m = cfg.moe
    print(f"6c moe: {cfg.name} d={cfg.d_model} heads {cfg.n_heads}/"
          f"{cfg.n_kv}x{cfg.d_head} {m.n_experts} experts top-{m.top_k} "
          f"d_expert {m.d_expert} shared {m.n_shared} vocab {cfg.vocab}; cut: "
          f"depth {get_arch('moonshot-v1-16b-a3b').config.n_layers} -> "
          f"{layers} ({cfg.n_params() / 1e9:.3f}B parameters), train "
          f"{steps} steps at seq {seq} x batch 1 in bf16; lockstep fp32 at "
          f"{lock_tokens} tokens x {lock_steps} steps", flush=True)
    loss_of = {}
    kept = []
    dispatch = moe.dispatch

    def recording(expert_flat, n_experts, c):
        pos_c, keep = dispatch(expert_flat, n_experts, c)
        kept.append(keep.float().mean())
        return pos_c, keep

    def loss_fn(c):
        def f(mm, b):
            loss, metrics = transformer.lm_loss(mm.tree(), b, c)
            loss_of["aux"] = metrics["aux"].detach()
            return loss, metrics
        return f

    # the fp32 lockstep first, then its weights go
    c32 = dataclasses.replace(cfg, dtype="float32")
    model = ParamTree(transformer.init_params(c32, seed=seed, device=device))
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=lock_steps)
    gen = synth.token_batches(np.random.default_rng(seed), c32.vocab, 1,
                              lock_tokens)
    moe.dispatch = recording
    try:
        with tempfile.TemporaryDirectory() as tmp:
            card_tr, host_tr = lockstep_trainers(loss_fn(c32), model, opt,
                                                 tmp)
            fak.reset_launches()
            lock = train_lockstep("6c moe lockstep", card_tr, host_tr,
                                  [next(gen) for _ in range(lock_steps)], opt)
            _no_kernel_on_grad_path("6c lockstep")
        lock_drop = max(1 - float(k) for k in kept)
        del card_tr, host_tr, model
        if device == "cuda":
            torch.cuda.empty_cache()
        # bf16 training at seq tokens
        model = ParamTree(transformer.init_params(cfg, seed=seed,
                                                  device=device))
        opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=steps)
        gen = synth.token_batches(np.random.default_rng(seed + 1), cfg.vocab,
                                  1, seq)
        with tempfile.TemporaryDirectory() as tmp:
            tr, _ = lockstep_trainers(loss_fn(cfg), model, opt, tmp)
            recs = []
            if device == "cuda":
                torch.cuda.reset_peak_memory_stats()
            for _ in range(steps):
                kept.clear()
                fit_step(tr, next(gen))
                recs.append((tr.history[-1]["loss"], float(loss_of["aux"]),
                             1 - float(torch.stack(kept).mean()),
                             tr.history[-1]["time_s"]))
            peak = torch.cuda.max_memory_allocated() \
                if device == "cuda" else 0
            _no_kernel_on_grad_path("6c train")
    finally:
        moe.dispatch = dispatch
    warm = statistics.median(r[3] for r in recs[1:])
    print(f"6c moe train: per step (loss, aux loss, share of (token, slot) "
          f"pairs over capacity, averaged over {layers} layers, host s) "
          f"{[tuple(round(x, 4) for x in r) for r in recs]}; step ms median "
          f"of steps 2-{steps} {warm * 1e3:.2f}, {seq / warm:.1f} tokens/s; "
          f"max_memory_allocated {peak / 2 ** 30:.2f} GiB; lockstep's "
          f"largest drop share in one layer call {lock_drop:.4f}",
          flush=True)
    if not all(np.isfinite(r[:2]).all() for r in recs):
        raise PhaseError(f"6c: loss or aux not finite: {recs}")
    params = model.tree()
    t0 = time.perf_counter()
    serve = phase_lm(seed, serve_batch, serve_prompt, serve_steps,
                     device=device, cfg=cfg, params=params, label="6c")
    print(f"6c moe serve: {time.perf_counter() - t0:.2f} s host wall clock",
          flush=True)
    del tr, model, params
    if device == "cuda":
        torch.cuda.empty_cache()
    return {"lockstep": lock, "train": recs, "step_ms": warm * 1e3,
            "peak_bytes": peak, "serve": serve,
            "launches": serve["launches"]}


def phase_rec_train(seed: int, batch: int, steps: int, lock_batch: int,
                    lock_steps: int, device: str = "cuda", cfg=None) -> dict:
    """6d: SASRec (or ``cfg``) at its published config trained through
    Trainer at ``batch`` sequences per step; a lockstep card against CPU
    at ``lock_batch``; then bce_loss under no_grad with the bag seam on
    and off (equal, the bag launched)."""
    from repro_torch.data.pipeline import batch_to_torch
    from repro_torch.models import sasrec
    from repro_torch.models.layers import ParamTree
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import Trainer, TrainerConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cfg or get_arch("sasrec").config
    full = get_arch("sasrec").shapes["train_batch"].dims
    print(f"6d rec train: {cfg.name} {cfg.n_items} items d={cfg.d_embed} "
          f"{cfg.n_blocks} blocks seq {cfg.seq_len}; batch {batch} "
          f"(train_batch's {full['batch']}), {steps} steps through Trainer; "
          f"lockstep at batch {lock_batch} x {lock_steps} steps", flush=True)
    loss_fn = lambda m, b: sasrec.bce_loss(m.tree(), b, cfg)  # noqa: E731
    rng = np.random.default_rng(seed)
    model = ParamTree(sasrec.init_params(cfg, seed=seed, device=device))
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=lock_steps)
    with tempfile.TemporaryDirectory() as tmp:
        card_tr, host_tr = lockstep_trainers(loss_fn, model, opt, tmp)
        fak.reset_launches()
        ebk.reset_launches()
        lock = train_lockstep(
            "6d rec lockstep", card_tr, host_tr,
            [synth.sasrec_batch(rng, cfg.n_items, lock_batch, cfg.seq_len)
             for _ in range(lock_steps)], opt)
        _no_kernel_on_grad_path("6d lockstep")
    del card_tr, host_tr, model
    model = ParamTree(sasrec.init_params(cfg, seed=seed, device=device))
    batches = [synth.sasrec_batch(rng, cfg.n_items, batch, cfg.seq_len)
               for _ in range(steps)]
    tmp = tempfile.mkdtemp()
    try:
        tr = Trainer(loss_fn, model, AdamWConfig(lr=1e-3, warmup_steps=1,
                                                 total_steps=steps),
                     TrainerConfig(total_steps=steps, ckpt_every=steps,
                                   ckpt_dir=tmp, log_every=10 ** 6))
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        tr.fit(iter(batches))
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        _no_kernel_on_grad_path("6d train")
        ckpt_bytes = _dir_bytes(tr.store.latest().path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    losses = [h["loss"] for h in tr.history]
    warm = statistics.median(h["time_s"] for h in tr.history[1:])
    print(f"6d rec train: losses {[round(x, 5) for x in losses]}; step ms "
          f"median of steps 2-{steps} {warm * 1e3:.2f} (first "
          f"{tr.history[0]['time_s'] * 1e3:.2f}), {batch / warm:.1f} "
          f"sequences/s; max_memory_allocated {peak / 2 ** 30:.2f} GiB; "
          f"checkpoint {ckpt_bytes / 1e9:.3f} GB", flush=True)
    # the batches' targets and negatives are uniform draws: nothing to
    # learn from them, so the loss stays near 2 ln 2; finite is required
    if not np.isfinite(losses).all():
        raise PhaseError(f"6d: loss not finite: {losses}")
    tb = batch_to_torch(batches[-1], device)
    with torch.no_grad():
        ebk.reset_launches()
        on = sasrec.bce_loss(model.tree(), tb, cfg)[0]
        launches = _kernel_launches()
        sasrec.set_use_kernel(False)
        try:
            off = sasrec.bce_loss(model.tree(), tb, cfg)[0]
        finally:
            sasrec.set_use_kernel(True)
    print(f"6d rec train: bce_loss under no_grad, seam on {float(on)!r} off "
          f"{float(off)!r} (must be equal: one-index bags are the rows); "
          f"launches {launches}", flush=True)
    if not torch.equal(on, off):
        raise PhaseError(f"6d: no-grad bce_loss seam on {float(on)} != off "
                         f"{float(off)}")
    if device == "cuda" and launches["embedding_bag"] != 3:
        raise PhaseError(f"6d: embedding_bag launched "
                         f"{launches['embedding_bag']} times in the no-grad "
                         f"bce_loss, expected 3")
    del tr, model
    if device == "cuda":
        torch.cuda.empty_cache()
    return {"lockstep": lock, "step_ms": warm * 1e3, "peak_bytes": peak,
            "ckpt_bytes": ckpt_bytes, "losses": losses,
            "launches": launches["embedding_bag"]}


# (module, argv) of the training entry points, each run with --device cuda
# and --device cpu: one architecture of each family at reduced_config
TRAIN_ENTRY_POINTS = (
    ("repro_torch.launch.train", ["--arch", "gemma3-1b"]),
    ("repro_torch.launch.train", ["--arch", "gin-tu"]),
    ("repro_torch.launch.train", ["--arch", "sasrec"]),
    ("repro_torch.examples.train_lm", []),
)


def _final_loss(text: str) -> float:
    """The loss an entry point printed last: ``final loss X after N
    steps`` (launch.train) or ``loss A -> B over N steps`` (train_lm)."""
    last = text.strip().splitlines()[-1].split()
    return float(last[2] if last[0] == "final" else last[3])


def phase_train_entry_points(devices=("cuda", "cpu")) -> dict:
    """6e: each training entry point's ``main(argv + ["--device", d,
    "--ckpt-dir", ...])`` for each device in this process: every call
    must exit 0, launch no kernel, and print final losses that agree
    within ENTRY_LOSS_TOL.  Then each device's launch.train checkpoint of
    the first arch resumes on the other device (``--resume``)."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for mod, argv in TRAIN_ENTRY_POINTS:
            main_fn = importlib.import_module(mod).main
            losses = {}
            for dev in devices:
                ck = str(Path(tmp) / f"{mod}{''.join(argv)}_{dev}")
                buf = io.StringIO()
                fak.reset_launches()
                ebk.reset_launches()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    rc = main_fn(argv + ["--device", dev, "--ckpt-dir", ck])
                sync(dev)
                secs = time.perf_counter() - t0
                if rc != 0:
                    raise PhaseError(f"6e: {mod} {argv} --device {dev} "
                                     f"exited {rc}: {buf.getvalue()[-2000:]}")
                _no_kernel_on_grad_path(f"6e {mod} {argv} {dev}")
                losses[dev] = _final_loss(buf.getvalue())
                print(f"6e entry points: {' '.join([mod] + argv)} --device "
                      f"{dev}: exit 0 in {secs:.2f} s host wall clock; last "
                      f"line: {buf.getvalue().strip().splitlines()[-1]}",
                      flush=True)
            vals = list(losses.values())
            err = abs(vals[0] - vals[-1]) / abs(vals[-1])
            print(f"6e entry points: {' '.join([mod] + argv)} final losses "
                  f"{losses}: relative difference {err:.3g} (tolerance "
                  f"{ENTRY_LOSS_TOL})", flush=True)
            if not err <= ENTRY_LOSS_TOL:
                raise PhaseError(f"6e: {mod} {argv} final losses {losses}")
            out[" ".join([mod] + argv)] = losses
        # a checkpoint written on one device resumes on the other
        mod, argv = TRAIN_ENTRY_POINTS[0]
        main_fn = importlib.import_module(mod).main
        for src, dst in zip(devices, devices[::-1]):
            if src == dst:
                continue
            ck = str(Path(tmp) / f"{mod}{''.join(argv)}_{src}")
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = main_fn(argv + ["--device", dst, "--ckpt-dir", ck,
                                     "--resume", "--steps", "60"])
            text = buf.getvalue()
            if rc != 0 or "resumed at step 50" not in text \
                    or not text.strip().endswith("after 60 steps"):
                raise PhaseError(f"6e: {src} checkpoint did not resume on "
                                 f"{dst}: {text[-2000:]}")
            print(f"6e entry points: the {src} run's checkpoint resumed on "
                  f"{dst} at step 50 and trained to 60: "
                  f"{text.strip().splitlines()[-1]}", flush=True)
    return out


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Phase 7: distribution (dist/ on torch.distributed), ranks spawned on the
# card
# ---------------------------------------------------------------------------
A2A_TOL = 2e-4         # max |y a2a - y scatter| / max |y scatter|: the
#                        reference tests' tolerance (test_distributed_
#                        numerics.py), held at bf16 too: the receiving
#                        side runs the scatter path's batched products;
#                        also 7a serve's logits (max |diff| / max |logit|
#                        per call) against the single-card server, whose
#                        attention runs the same kernels
SPLITK_F32_TOL = 5e-5  # the same for split-K logits in fp32 (the
#                        reference test's); bf16 takes LM_LOGIT_TOL, the
#                        noise of two attention routes over 26 layers
GRAD_TOL = 1e-6        # plain grad_sync vs the fp64 mean: rtol = atol,
#                        one fp32 rounding per hop
GRAD_Q_TOL = 0.02      # int8 across pods: rtol = atol of the reference
#                        test; each value is also held to half an int8
#                        step of its tensor, max |x| / 254
GRAD_BF16_TOL = 2e-2   # 7e's bf16 gradients, a2a against scatter: max
#                        |diff| / the tensor's largest gradient.  The
#                        forward is the same bit for bit (7a: err 0); the
#                        backward sums each token's k slot gradients, and
#                        each whole input's block gradients, in another
#                        order, rounding each sum to bf16 (unit roundoff
#                        2^-8 = 3.9e-3); a dropped or doubled slot reads
#                        ~1/k = 0.17 of a token's gradient or more
TOPK_RTOL = 1e-5       # 7e's distributed top-k values against dense
#                        score_catalog + sort (the reference test's rtol):
#                        each rank's block product and the dense one sum
#                        the same 50 terms, perhaps in another order
GRAD_STD = 0.35        # 7c's gradients: N(0, GRAD_STD^2), so the largest
#                        of the table's 50M values (~2.0) lies in the
#                        reference test's range (its values reach 2.3);
#                        at N(0, 1) half an int8 step (~5.7 / 254) alone
#                        exceeds 0.02

DIST_SIZES = {
    "full": {
        # skew: 7a's tokens are N(0, 1) plus skew times one shared N(0, 1)
        # vector, so routing favours some experts and capacity factor 1.25
        # drops pairs (0.5 made the busiest expert take 5x the mean load,
        # and the ample capacity's buffers overflowed the card)
        "7a": dict(arch="qwen3-moe-235b-a22b", batch=4, seq=4096,
                   mesh=(2, 4), skew=0.15),
        "7a_serve": dict(arch="moonshot-v1-16b-a3b", layers=2, batch=4,
                         prompt=256, steps=8, model=4),
        "7b": dict(layers=26, batch=8, prompt=1024, steps=32,
                   max_len=LM_SEQ, model=4, f32_layers=6, f32_steps=4),
        "7c": dict(arch="sasrec", mesh=(2, 2, 2)),
        "7e": dict(arch="moonshot-v1-16b-a3b", layers=2, model=4,
                   f32_tokens=128, bf16_tokens=4096),
        "7e_step": dict(arch="moonshot-v1-16b-a3b", layers=2, model=4,
                        tokens=128, vocab=32_768),
        "7e_topk": dict(arch="sasrec", batch=512, mesh=(2, 4)),
    },
    "rehearsal": {
        "7a": dict(arch="qwen3-moe-235b-a22b", batch=4, seq=16,
                   mesh=(2, 4), skew=0.5, reduced=True),
        "7a_serve": dict(arch="moonshot-v1-16b-a3b", layers=2, batch=4,
                         prompt=16, steps=4, model=4, reduced=True),
        "7b": dict(layers=2, batch=4, prompt=8, steps=8, max_len=16,
                   model=4, f32_layers=2, f32_steps=4, reduced=True),
        "7c": dict(arch="sasrec", mesh=(2, 2, 2), reduced=True),
        "7e": dict(arch="moonshot-v1-16b-a3b", layers=2, model=4,
                   f32_tokens=128, bf16_tokens=256, reduced=True),
        "7e_step": dict(arch="moonshot-v1-16b-a3b", layers=2, model=4,
                        tokens=128, vocab=None, reduced=True),
        "7e_topk": dict(arch="sasrec", batch=8, mesh=(2, 4), reduced=True),
    },
}


def _arch_cfg(arch: str, reduced: bool = False):
    from repro_torch.launch.train import reduced_config
    spec = get_arch(arch)
    return reduced_config(spec) if reduced else spec.config


def moe_layer(seed: int, cfg, experts, device) -> dict:
    """One MoE layer of the LM config ``cfg`` (``moe_block``'s tree,
    without shared experts): the router, and the weights of the experts
    ``experts``, each expert drawn from its own seed so that a rank makes
    its block alone (the reference's distributions)."""
    m, d, dt = cfg.moe, cfg.d_model, cfg.tdtype
    gen = torch.Generator(device=device).manual_seed(seed)
    p = {"router": torch.randn((d, m.n_experts), generator=gen,
                               device=device) / np.sqrt(d)}
    for i, (name, (rows, cols, s)) in enumerate((
            ("w_gate", (d, m.d_expert, d)), ("w_up", (d, m.d_expert, d)),
            ("w_down", (m.d_expert, d, m.d_expert)))):
        ws = []
        for e in experts:
            g = torch.Generator(device=device).manual_seed(
                seed * 1_000_003 + 3 * e + i)
            ws.append(torch.randn((rows, cols), generator=g, device=device,
                                  dtype=dt) * float(1 / np.sqrt(s)))
        p[name] = torch.stack(ws)
    return p


def moe_tokens(seed: int, cfg, batch: int, seq: int, skew: float, device):
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    x = torch.randn((batch, seq, cfg.d_model), generator=gen, device=device)
    shared = torch.randn((cfg.d_model,), generator=gen, device=device)
    return (x + skew * shared).to(cfg.tdtype)


def _loads(p, x, m) -> torch.Tensor:
    """Pairs routed to each expert (the scatter path's top-k)."""
    from repro_torch.models import moe
    probs = torch.softmax(x.reshape(-1, x.shape[-1]).float() @ p["router"],
                          dim=-1)
    _, idx = moe.top_k(probs, m.top_k)
    return torch.bincount(idx.reshape(-1), minlength=m.n_experts)


def _cuts(kw: dict, depth: str) -> str:
    return ("cuts: reduced config (rehearsal)" if kw.get("reduced")
            else f"cuts: {depth}; width uncut")


def moe_cotangent(seed: int, shape, device) -> torch.Tensor:
    """The fixed fp32 cotangent of 7e's MoE-layer backward:
    sum(y * cot) is the loss."""
    gen = torch.Generator(device=device).manual_seed(seed + 7)
    return torch.randn(tuple(shape), generator=gen, device=device)


def expert_prints(seed: int, grads: dict, device) -> dict:
    """Each expert's gradient of each weight projected on one seeded
    N(0, 1) direction of that weight's shape (float64 sums): (e,) per
    weight, so a rank's block of experts is held against the whole
    layer's without moving the whole gradients."""
    out = {}
    for i, name in enumerate(("w_gate", "w_up", "w_down")):
        g = grads[name]
        gen = torch.Generator(device=device).manual_seed(seed * 31 + i)
        r = torch.randn(tuple(g.shape[1:]), generator=gen, device=device)
        out[name] = torch.stack([torch.sum(g[e].double() * r.double())
                                 for e in range(g.shape[0])])
    return out


def moe_grads(p: dict, x, cot, c) -> tuple:
    """``moe_block``'s forward and backward of sum(y * cot) on ``p``
    (the router and this rank's experts, or all of them): the gradients
    of x, the router and the experts, with each pass's seconds and
    counted collectives."""
    from repro_torch import dist
    from repro_torch.models import moe
    leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
    xg = x.detach().requires_grad_()
    dev = x.device
    dist.reset_counts()
    t0 = time.perf_counter()
    y, _ = moe.moe_block(leaves, xg, c)
    sync(dev)
    t1 = time.perf_counter()
    fwd = dict(dist.counts)
    names = ("router", "w_gate", "w_up", "w_down")
    got = torch.autograd.grad(torch.sum(y.float() * cot),
                              [xg] + [leaves[k] for k in names])
    sync(dev)
    t2 = time.perf_counter()
    bwd = {k: v for k, v in dist.counts.items() if ".bwd@" in k}
    return dict(zip(("x",) + names, got)), {
        "fwd_s": t1 - t0, "bwd_s": t2 - t1, "fwd_sent": fwd,
        "bwd_sent": bwd}


def grad_cfg(arch: str, layers: int, dtype: str, reduced: bool = False):
    """7e's LM: ``arch`` at its width (or reduced), depth ``layers``,
    ``dtype``, MoE layers on the all-to-all (the scatter path without a
    mesh)."""
    cfg = dataclasses.replace(_arch_cfg(arch, reduced), n_layers=layers,
                              dtype=dtype)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, moe_impl="a2a"))


def grad_batch(seed: int, cfg, tokens: int, device) -> dict:
    b = next(synth.token_batches(np.random.default_rng(seed + 3), cfg.vocab,
                                 1, tokens))
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in b.items()}


def lm_grads(model, batch: dict, cfg) -> tuple:
    """``lm_loss`` and every parameter's gradient (by name): what the
    Trainer's step differentiates."""
    from repro_torch.models import transformer
    loss, _ = transformer.lm_loss(model.tree(), batch, cfg)
    names = [k for k, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return float(loss.detach()), dict(zip(names, grads))


STEP_OPT = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)


def step_cfg(arch: str, layers: int, vocab, reduced: bool = False):
    """7e's Trainer step: ``grad_cfg`` in fp32 with the vocabulary cut to
    ``vocab`` (None: uncut)."""
    cfg = grad_cfg(arch, layers, "float32", reduced)
    return dataclasses.replace(cfg, vocab=vocab) if vocab else cfg


def step_trainer(seed: int, cfg, tokens: int, device, ckpt_dir: str,
                 mesh=None) -> tuple:
    """A ``Trainer`` of ``cfg``'s LM (this rank's tree under ``mesh``;
    checkpoints never written) and one batch of ``tokens`` tokens."""
    from repro_torch.models import transformer
    from repro_torch.models.layers import ParamTree
    from repro_torch.runtime import Trainer, TrainerConfig
    params = transformer.init_params(cfg, seed=seed, device=device)
    model = ParamTree(transformer.local_params(params, cfg, mesh))
    del params
    tr = Trainer(lambda m, b: transformer.lm_loss(m.tree(), b, cfg), model,
                 STEP_OPT, TrainerConfig(
                     total_steps=10 ** 6, ckpt_every=10 ** 6,
                     log_every=10 ** 6, ckpt_dir=ckpt_dir))
    batch = next(synth.token_batches(np.random.default_rng(seed + 3),
                                     cfg.vocab, 1, tokens))
    return tr, batch


def _rank_7a(rank, world, seed, ref_dir, device, arch, batch, seq, mesh,
             skew, reduced=False):
    """Expert-parallel MoE on a (data, model) mesh: ``moe_block``'s a2a
    path on this rank's experts against the single-card scatter path at
    the ample and the 1.25 capacity factor, and the exact-sized wire
    buffer bit for bit against the static one."""
    from repro_torch import dist
    from repro_torch.dist import collectives
    from repro_torch.models import moe
    cfg = _arch_cfg(arch, reduced)
    m = cfg.moe
    mesh = dist.make_mesh(mesh, ("data", "model"))
    n_model = mesh.shape["model"]
    e_loc = m.n_experts // n_model
    lo = mesh.coord("model") * e_loc
    p = moe_layer(seed, cfg, range(lo, lo + e_loc), device)
    x = moe_tokens(seed, cfg, batch, seq, skew, device)
    ref = torch.load(os.path.join(ref_dir, "7a.pt"), map_location=device)
    out = {"block_experts": int(p["w_gate"].shape[0]),
           "block_bytes": sum(p[k].numel() * p[k].element_size()
                              for k in ("w_gate", "w_up", "w_down"))}
    dist.set_mesh(mesh)
    try:
        for label, cf in (("ample", ref["ample_cf"]), ("overflow", 1.25)):
            c = dataclasses.replace(m, capacity_factor=cf, moe_impl="a2a")
            dist.reset_counts()
            t0 = time.perf_counter()
            y, _ = moe.moe_block(p, x, c)
            sync(device)
            want = ref[label].to(device)
            err = float((y.float() - want.float()).abs().max()
                        / want.float().abs().max())
            out[label] = {"err": err, "s": time.perf_counter() - t0,
                          "sent": dict(dist.counts)}
            if not err < A2A_TOL:
                raise PhaseError(f"7a rank {rank}: a2a != scatter at "
                                 f"capacity factor {cf}: {err} (tolerance "
                                 f"{A2A_TOL})")
        # the two-phase exact sizing against the static bound
        t = batch * seq
        xf = x.reshape(t, cfg.d_model)
        logits = xf.float() @ p["router"]
        cap = moe.capacity(t, dataclasses.replace(m, capacity_factor=1.25))
        exact = collectives.moe_alltoall_exact_c_dev(logits, mesh, m.top_k,
                                                     capacity=cap)
        ys = {}
        for name, c_dev, flag in (("static", 0, False), ("exact", exact,
                                                         True)):
            dist.reset_counts()
            t0 = time.perf_counter()
            ys[name] = collectives.moe_alltoall_block(
                xf, logits, p["w_gate"], p["w_up"], p["w_down"], mesh,
                m.top_k, c_dev, capacity=cap, exact_c_dev=flag)
            sync(device)
            out[name] = {"s": time.perf_counter() - t0,
                         "sent": dict(dist.counts)}
        t_loc = t // (mesh.shape["data"] * n_model)
        out["c_dev"] = (exact, min(t_loc * m.top_k, e_loc * cap))
        if not torch.equal(ys["exact"], ys["static"]):
            raise PhaseError(f"7a rank {rank}: the exact-sized dispatch "
                             f"(c_dev {exact}) differs from the static one")
        del ys, logits, xf
        # 7e: the layer's backward, against the single-card scatter path's
        cot = moe_cotangent(seed, x.shape, device)
        want = torch.load(os.path.join(ref_dir, "7e_moe.pt"),
                          map_location=device)
        for label, cf in (("ample", ref["ample_cf"]), ("overflow", 1.25)):
            c = dataclasses.replace(m, capacity_factor=cf, moe_impl="a2a")
            grads, info = moe_grads(p, x, cot, c)
            prints = expert_prints(seed, grads, device)
            w = want[label]
            errs = {k: float((grads[k].float() - w[k].float()).abs().max()
                             / w[k].float().abs().max())
                    for k in ("x", "router")}
            for k, v in prints.items():
                errs[k] = float((v - w["prints"][k][lo:lo + e_loc]).abs()
                                .max() / w["prints"][k].abs().max())
            del grads
            out[f"grad_{label}"] = dict(info, errs=errs)
            if not max(errs.values()) <= GRAD_BF16_TOL:
                raise PhaseError(f"7e rank {rank}: a2a gradients != the "
                                 f"scatter path's at capacity factor {cf}: "
                                 f"{errs} (tolerance {GRAD_BF16_TOL})")
            if not info["bwd_sent"].get("all_to_all.bwd@model"):
                raise PhaseError(f"7e rank {rank}: no all-to-all in the "
                                 f"backward: {info['bwd_sent']}")
    finally:
        dist.set_mesh(None)
    return out


def _rank_7c(rank, world, seed, ref_dir, device, arch, mesh, reduced=False):
    """grad_sync and cross_pod_allreduce on (pod, data, model) over
    SASRec's parameter tree, a different tree on each rank, against the
    fp64 mean over the ranks of this rank's dp group."""
    from repro_torch import dist
    from repro_torch.dist.collectives import cross_pod_allreduce, grad_sync
    from repro_torch.models import sasrec
    from repro_torch.models.layers import flatten_tree
    cfg = _arch_cfg(arch, reduced)
    mesh = dist.make_mesh(mesh, ("pod", "data", "model"))
    like = flatten_tree(sasrec.init_params(cfg, device=device))

    def tree(r):
        g = torch.Generator(device=device).manual_seed(seed * 1000 + r)
        return {k: torch.randn(v.shape, generator=g, device=device)
                * GRAD_STD for k, v in like.items()}

    def within(got, want, tol, step):
        """|got - want| within rtol = atol = tol and, for int8, within
        half an int8 step of the largest input (``step``)."""
        return all(torch.allclose(got[k].double(), want[k].double(),
                                  rtol=tol, atol=tol)
                   and (step is None or float((got[k].double()
                                               - want[k].double()).abs()
                                              .max()) <= step[k])
                   for k in want)

    def half_step(trees):
        """Half an int8 step of each leaf's largest input, plus 4e-7
        (a few fp32 roundings of values up to ~2.5)."""
        return {k: max(float(t[k].abs().max()) for t in trees) / 254
                + 4e-7 for k in like}

    group = [r for r in range(world)
             if r % mesh.shape["model"] == mesh.coord("model")]
    mean = {k: torch.zeros(v.shape, dtype=torch.float64, device=device)
            for k, v in like.items()}
    step = {k: 0.0 for k in like}
    for r in group:
        t = tree(r)
        step = {k: max(step[k], h) for k, h in half_step([t]).items()}
        for k, v in t.items():
            mean[k] += v.double() / len(group)
    mine = tree(rank)
    out = {"tree_bytes": sum(v.numel() * 4 for v in mine.values()),
           "group": group}
    for label, q in (("plain", False), ("int8", True)):
        dist.reset_counts()
        t0 = time.perf_counter()
        got = grad_sync(mesh, mine, int8_cross_pod=q)
        sync(device)
        tol = GRAD_Q_TOL if q else GRAD_TOL
        err = max(float((got[k].double() - mean[k]).abs().max())
                  for k in mine)
        out[label] = {"err": err, "s": time.perf_counter() - t0,
                      "sent": dict(dist.counts)}
        if not within(got, mean, tol, step if q else None):
            raise PhaseError(f"7c rank {rank}: grad_sync ({label}) != the "
                             f"fp64 mean of ranks {group}: max |err| {err} "
                             f"(rtol = atol = {tol}; int8: half a step)")
    same = tree(world)                  # one tree on every rank
    for label, q in (("replicated", False), ("replicated int8", True)):
        got = grad_sync(mesh, same, int8_cross_pod=q)
        if not (within(got, same, GRAD_Q_TOL, half_step([same])) if q
                else all(torch.equal(got[k], same[k]) for k in same)):
            raise PhaseError(f"7c rank {rank}: grad_sync ({label}) of a "
                             f"replicated tree is not the identity")
    # the standalone hop: a pod-sharded table, averaged across pods
    table = same["item_emb"]
    half = table.shape[0] // 2
    dist.reset_counts()
    t0 = time.perf_counter()
    got = cross_pod_allreduce(mesh, table, in_spec=dist.P("pod", None))
    sync(device)
    want = ((table[:half].double() + table[half:].double()) / 2).repeat(2, 1)
    out["cross_pod"] = {"s": time.perf_counter() - t0,
                        "sent": dict(dist.counts)}
    if not torch.allclose(got.double(), want, rtol=GRAD_TOL, atol=GRAD_TOL):
        raise PhaseError(f"7c rank {rank}: cross_pod_allreduce != the pod "
                         f"mean")
    if not torch.equal(cross_pod_allreduce(mesh, table), table):
        raise PhaseError(f"7c rank {rank}: cross_pod_allreduce of a "
                         f"replicated tensor is not the identity")
    return out


def _serve_lockstep(srv, prompts, ref, steps: int):
    """Prefill then ``steps`` greedy steps fed the reference server's
    tokens: (logits error per call, this server's own greedy tokens)."""
    lg = srv.prefill(prompts)
    errs, toks = [], []
    for i in range(steps + 1):
        want = ref["logits"][i].to(lg.device).float()
        errs.append(float((lg.float() - want).abs().max()
                          / want.abs().max()))
        toks.append(lg.argmax(-1).cpu())
        if i < steps:
            lg = srv.step(ref["tokens"][i].to(lg.device))
    return errs, torch.stack(toks)


def reference_server(cfg, params, prompts, steps: int, max_len: int,
                     device) -> dict:
    """The single-card server's greedy run: tokens (steps + 1, B) and the
    logits of every call (steps + 1, B, V)."""
    from repro_torch.runtime import LMServer
    srv = LMServer(params, cfg, prompts.shape[0], max_len, device=device)
    lg = srv.prefill(prompts)
    toks, logits = [], []
    for i in range(steps + 1):
        logits.append(lg.cpu())
        toks.append(lg.argmax(-1).cpu())
        if i < steps:
            lg = srv.step(toks[-1].to(lg.device))
    return {"tokens": torch.stack(toks), "logits": torch.stack(logits)}


def _held_summary(att: list) -> dict:
    """``attention_held``'s records in brief: calls held, and the worst
    error in units of 2^-8 of |want| + row rms."""
    return {"calls": len(att),
            "worst_2^-8": max((r for _, r, _ in att), default=0.0) / 2 ** -8}


def _check_held(label: str, att: list, want: int) -> None:
    """Fail unless ``want`` attention calls were held and each passed."""
    bad = sum(not ok for ok, _, _ in att)
    if bad or len(att) != want:
        raise PhaseError(f"{label}: {bad} of {len(att)} attention calls "
                         f"differ from their plain version ({want} "
                         f"expected; {FLASH_TOL} and FLASH_ROW_TOL)")


def _serve_cfgs(arch, layers, reduced, **kw):
    return dataclasses.replace(_arch_cfg(arch, reduced), n_layers=layers,
                               **kw)


def _rank_7a_serve(rank, world, seed, ref_dir, device, arch, layers, batch,
                   prompt, steps, model, reduced=False):
    """An MoE LM with moe_impl="a2a" behind LMServer on a (model) mesh,
    this rank holding its block of every layer's experts, in lockstep
    with the single-card scatter server's tokens."""
    from repro_torch import dist
    from repro_torch.models import transformer
    from repro_torch.runtime import LMServer
    cfg = _serve_cfgs(arch, layers, reduced)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, moe_impl="a2a"))
    mesh = dist.make_mesh((model,), ("model",))
    params = transformer.local_params(
        transformer.init_params(cfg, seed=seed, device=device), cfg, mesh)
    if device != "cpu":
        torch.cuda.empty_cache()
    ref = torch.load(os.path.join(ref_dir, "7a_serve.pt"))
    prompts = ref["prompts"].numpy()
    experts = params["layers"]["moe"]["w_gate"].shape[1]
    att = []
    dist.set_mesh(mesh)
    try:
        srv = LMServer(params, cfg, batch, prompt + steps, device=device)
        fak.reset_launches()
        dist.reset_counts()
        t0 = time.perf_counter()
        errs, toks = _serve_lockstep(srv, prompts, ref, steps)
        sync(device)
        out = {"errs": errs, "s": time.perf_counter() - t0,
               "sent": dict(dist.counts), "block_experts": experts,
               "flash": dict(fak.launches)}
        # every attention call held to its plain version, in a second,
        # untimed pass over the same prompts and tokens: both sides of
        # the logit comparison run the same kernels
        with attention_held(att):
            _serve_lockstep(srv, prompts, ref, steps)
    finally:
        dist.set_mesh(None)
    out["attention"] = _held_summary(att)
    if experts != cfg.moe.n_experts // model:
        raise PhaseError(f"7a serve rank {rank}: holds {experts} experts")
    want = {"flash_tc" if cfg.dtype == "bfloat16" else "flash_simt": layers,
            "flash_decode": layers * steps}
    if device != "cpu" and {k: out["flash"][k] for k in want} != want:
        raise PhaseError(f"7a serve rank {rank}: flash launches "
                         f"{out['flash']}, expected {want}")
    _check_held(f"7a serve rank {rank}", att, sum(want.values()))
    if not torch.equal(toks, ref["tokens"]) or not max(errs) < A2A_TOL:
        raise PhaseError(f"7a serve rank {rank}: tokens or logits differ "
                         f"from the single-card server: logit errors "
                         f"{errs} (tolerance {A2A_TOL}), tokens "
                         f"{toks.tolist()} vs {ref['tokens'].tolist()}")
    return out


def _rank_7b(rank, world, seed, ref_dir, device, layers, batch, prompt,
             steps, max_len, model, f32_layers, f32_steps, reduced=False):
    """Split-K decode of gemma3-1b behind LMServer on a (model) mesh, this
    rank holding its sequence block of the cache, in lockstep with the
    single-card server's tokens (gather decode on flash_decode): bf16 at
    ``layers`` and fp32 at ``f32_layers``; the counted bytes per layer
    and step are the partials'."""
    from repro_torch import dist
    from repro_torch.models import transformer
    from repro_torch.runtime import LMServer
    mesh = dist.make_mesh((model,), ("model",))
    out = {}
    for label, n, dt, st, tol in (("bf16", layers, "bfloat16", steps,
                                   LM_LOGIT_TOL),
                                  ("fp32", f32_layers, "float32", f32_steps,
                                   SPLITK_F32_TOL)):
        cfg = _serve_cfgs("gemma3-1b", n, reduced, dtype=dt,
                          decode_attn="splitk")
        ref = torch.load(os.path.join(ref_dir, f"7b_{label}.pt"))
        params = transformer.init_params(cfg, seed=seed, device=device)
        att = []
        dist.set_mesh(mesh)
        try:
            srv = LMServer(params, cfg, batch, max_len, device=device)
            fak.reset_launches()
            dist.reset_counts()
            t0 = time.perf_counter()
            errs, _ = _serve_lockstep(srv, ref["prompts"].numpy(), ref, st)
            sync(device)
            serve_s = time.perf_counter() - t0
            block = tuple(srv.cache["k"].shape)
            sent, launches = dict(dist.counts), dict(fak.launches)
            # the prefill's attention calls held to their plain version
            # in a second, untimed prefill (split-K decode attends in
            # plain torch; the launch check below says it calls no kernel)
            with attention_held(att):
                srv.prefill(ref["prompts"].numpy())
        finally:
            dist.set_mesh(None)
        h, dh = cfg.n_heads, cfg.d_head
        per = st * n        # layer calls of the decode steps
        want = {"pmax@model": {"calls": per, "bytes": per * batch * h * 4},
                "psum@model": {"calls": 2 * per,
                               "bytes": per * batch * h * (dh + 1) * 4}}
        cache_block = (block[1] * block[2] * block[3] * block[4]
                       * (2 if dt == "bfloat16" else 4))
        out[label] = {"errs": errs, "s": serve_s, "sent": sent,
                      "block": block,
                      "bytes_per_layer_step": batch * h * (dh + 2) * 4,
                      "cache_block_bytes": cache_block,
                      "flash": launches, "attention": _held_summary(att)}
        if block[2] != max_len // model:
            raise PhaseError(f"7b rank {rank}: cache block {block}")
        # prefill on the kernel; split-K decode attends in plain torch
        flash = {"flash_decode": 0, "flash_simt" if dt == "float32"
                 else "flash_tc": n}
        if device != "cpu" and {k: launches[k] for k in flash} != flash:
            raise PhaseError(f"7b rank {rank} ({label}): flash launches "
                             f"{launches}, expected {flash}")
        _check_held(f"7b rank {rank} ({label})", att, n)
        if sent != want:
            raise PhaseError(f"7b rank {rank} ({label}): sent {sent}, "
                             f"expected the partials only: {want}")
        if not max(errs) <= tol:
            raise PhaseError(f"7b rank {rank} ({label}): split-K logits != "
                             f"the single-card server's: {errs} (tolerance "
                             f"{tol})")
        del srv, params
        if device != "cpu":
            torch.cuda.empty_cache()
    return out


def _rank_7d(rank, world, seed, ref_dir, device, arch, batch, seq, skew,
             reduced=False, **_):
    """A world of one (NCCL on the card): 7a's a2a path and 7c's syncs on
    (1, 1) meshes equal the single-device results exactly."""
    from repro_torch import dist
    from repro_torch.dist.collectives import cross_pod_allreduce, grad_sync
    from repro_torch.models import moe
    cfg = _arch_cfg(arch, reduced)
    m = cfg.moe
    p = moe_layer(seed, cfg, range(m.n_experts), device)
    x = moe_tokens(seed, cfg, batch, seq, skew, device)
    c = dataclasses.replace(m, capacity_factor=1.25)
    y_single, aux_single = moe.moe_block(p, x, c)
    mesh = dist.make_mesh((1, 1), ("data", "model"))
    dist.set_mesh(mesh)
    try:
        dist.reset_counts()
        y, aux = moe.moe_block(p, x, dataclasses.replace(c, moe_impl="a2a"))
        sync(device)
    finally:
        dist.set_mesh(None)
    out = {"backend": mesh.backend, "sent": dict(dist.counts)}
    if not (torch.equal(y, y_single) and torch.equal(aux, aux_single)):
        raise PhaseError(f"7d: the a2a path on a (1, 1) {mesh.backend} mesh "
                         f"differs from the single-device scatter path: "
                         f"{float((y.float() - y_single.float()).abs().max())}")
    pod = dist.make_mesh((1, 1, 1), ("pod", "data", "model"))
    g = {"w": x[0].float()}
    for mm in (mesh, pod):
        if not (torch.equal(grad_sync(mm, g)["w"], g["w"])
                and torch.equal(cross_pod_allreduce(mm, g["w"], compress=True),
                                g["w"])):
            raise PhaseError("7d: grad_sync / cross_pod_allreduce on a "
                             "world of one is not the identity")
    return out


def _rank_7e(rank, world, seed, ref_dir, device, arch, layers, model,
             f32_tokens, bf16_tokens, reduced=False):
    """The gradients of ``lm_loss`` (what a Trainer step differentiates)
    of ``arch`` at depth ``layers`` with its MoE layers on the all-to-all,
    this rank holding its block of the experts on a (model) mesh, against
    the single-card scatter path's: the loss, every tensor's gradient (an
    expert block against the matching slice) and the whole tree's norm
    (``adamw.global_norm`` over the held blocks), fp32 and bf16."""
    from repro_torch import dist
    from repro_torch.models import transformer
    from repro_torch.models.layers import ParamTree
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = dist.make_mesh((model,), ("model",))
    out = {}
    for label, dt, tokens, tol in (("fp32", "float32", f32_tokens, A2A_TOL),
                                   ("bf16", "bfloat16", bf16_tokens,
                                    GRAD_BF16_TOL)):
        cfg = grad_cfg(arch, layers, dt, reduced)
        e_loc = cfg.moe.n_experts // model
        lo = mesh.coord("model") * e_loc
        params = transformer.init_params(cfg, seed=seed, device=device)
        net = ParamTree(transformer.local_params(params, cfg, mesh))
        del params
        if device != "cpu":
            torch.cuda.empty_cache()
        batch = grad_batch(seed, cfg, tokens, device)
        dist.set_mesh(mesh)
        try:
            dist.reset_counts()
            t0 = time.perf_counter()
            loss, grads = lm_grads(net, batch, cfg)
            sync(device)
            secs = time.perf_counter() - t0
            sent = dict(dist.counts)
            gnorm = float(adamw.global_norm(grads))
        finally:
            dist.set_mesh(None)
        ref = torch.load(os.path.join(ref_dir, f"7e_{label}.pt"),
                         map_location="cpu", mmap=True)
        errs = {}
        for k, g in grads.items():
            w = ref["grads"][k]
            if k in mesh.held:
                w = w[:, lo:lo + e_loc]
            errs[k] = float((g.float() - w.to(device).float()).abs().max()
                            / max(ref["scale"][k], 1e-30))
        worst = max(errs, key=errs.get)
        out[label] = {"loss_err": abs(loss - ref["loss"]) / abs(ref["loss"]),
                      "gnorm_err": abs(gnorm - ref["gnorm"]) / ref["gnorm"],
                      "worst": (worst, errs[worst]), "s": secs,
                      "sent": sent, "experts": e_loc}
        del net, grads, ref
        if device != "cpu":
            torch.cuda.empty_cache()
        if not (out[label]["loss_err"] <= tol and out[label]["gnorm_err"]
                <= tol and errs[worst] <= tol):
            raise PhaseError(f"7e rank {rank} ({label}): a2a gradients != "
                             f"the single-card scatter path's: "
                             f"{_brief(out[label])} (tolerance {tol})")
        if not sent.get("all_to_all.bwd@model"):
            raise PhaseError(f"7e rank {rank}: no all-to-all in the "
                             f"backward: {sent}")
    return out


def _rank_7e_step(rank, world, seed, ref_dir, device, arch, layers, model,
                  tokens, vocab, reduced=False):
    """One ``Trainer`` step of ``step_cfg``'s LM with its MoE layers on
    the all-to-all, this rank holding its block of the experts on a
    (model) mesh, against the single-card scatter path's step: the loss,
    the clipped gradient's norm (the whole tree's, over the blocks in
    ``mesh.held``), each tensor's first Adam moment (the clipped gradient
    times 1 - b1; an expert block against the matching slice), and this
    rank's change of its parameters against AdamW in fp64 from its own
    moments (``update_errs``)."""
    from repro_torch import dist
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = dist.make_mesh((model,), ("model",))
    cfg = step_cfg(arch, layers, vocab, reduced)
    e_loc = cfg.moe.n_experts // model
    lo = mesh.coord("model") * e_loc
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    tr, batch = step_trainer(seed, cfg, tokens, device,
                             os.path.join(ref_dir, f"step{rank}"), mesh)
    p0 = {k: v.detach().cpu().clone()
          for k, v in tr.model.named_parameters()}
    dist.set_mesh(mesh)
    try:
        dist.reset_counts()
        t0 = time.perf_counter()
        fit_step(tr, batch)
        sync(device)
        secs = time.perf_counter() - t0
        sent = dict(dist.counts)
    finally:
        dist.set_mesh(None)
    ref = torch.load(os.path.join(ref_dir, "7e_step.pt"), map_location="cpu",
                     mmap=True)
    errs = {}
    for k, m in tr.opt_state.mu.items():
        w = ref["mu"][k]
        if k in mesh.held:
            w = w[:, lo:lo + e_loc]
        errs[k] = float((m - w.to(m.device)).abs().max()
                        / max(float(w.abs().max()), 1e-30))
    upd = update_errs(dict(tr.model.named_parameters()), tr.opt_state, p0,
                      STEP_OPT)
    worst, u_key = max(errs, key=errs.get), max(upd, key=upd.get)
    loss, gnorm = tr.history[-1]["loss"], float(tr.last_metrics["grad_norm"])
    out = {"loss_err": abs(loss - ref["loss"]) / abs(ref["loss"]),
           "gnorm_err": abs(gnorm - ref["grad_norm"]) / ref["grad_norm"],
           "moment": (worst, errs[worst]), "update": (u_key, upd[u_key]),
           "held": sorted(mesh.held), "s": secs, "sent": sent,
           "peak_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                        if device != "cpu" else None)}
    del tr, p0, ref
    if device != "cpu":
        torch.cuda.empty_cache()
    if not (out["loss_err"] <= A2A_TOL and out["gnorm_err"] <= A2A_TOL
            and errs[worst] <= A2A_TOL and upd[u_key] <= GNN_STEP_TOL):
        raise PhaseError(f"7e step rank {rank}: the Trainer step on the mesh "
                         f"!= the single-card step: {_brief(out)} "
                         f"(tolerances {A2A_TOL}; update {GNN_STEP_TOL})")
    if not sent.get("all_to_all.bwd@model"):
        raise PhaseError(f"7e step rank {rank}: no all-to-all in the "
                         f"backward: {sent}")
    return out


def rec_histories(seed: int, cfg, batch: int) -> np.ndarray:
    """``batch`` user histories, 20 % of them short and left-padded
    (phase 5's)."""
    rng = np.random.default_rng(seed)
    hist = rng.integers(1, cfg.n_items + 1, (batch, cfg.seq_len))
    short = rng.random(batch) < 0.2
    hist[short, :rng.integers(1, cfg.seq_len)] = 0
    return hist


def _rank_7e_topk(rank, world, seed, ref_dir, device, arch, batch, mesh,
                  reduced=False):
    """``_rec_serve``'s distributed top-100 (``sasrec.topk_catalog``) on
    a (data, model) mesh: each rank scores its users' block against its
    catalogue block; values against dense ``score_catalog`` + sort, and
    indices wherever the values are not tied.  The encode launches
    embedding_bag, held against its plain twin as phase 5 holds it."""
    from repro_torch import dist
    from repro_torch.models import sasrec
    cfg = _arch_cfg(arch, reduced)
    mesh = dist.make_mesh(mesh, ("data", "model"))
    params = sasrec.init_params(cfg, seed=seed, device=device)
    hist = torch.from_numpy(rec_histories(seed, cfg, batch)).to(device)
    ref = torch.load(os.path.join(ref_dir, "7e_topk.pt"),
                     map_location=device)
    with torch.no_grad():
        h_k = sasrec.encode(params, hist, cfg)
        sasrec.set_use_kernel(False)
        try:
            h_p = sasrec.encode(params, hist, cfg)
        finally:
            sasrec.set_use_kernel(True)
    enc_err = float((h_k - h_p).abs().max() / h_p.abs().max())
    sasrec.topk_catalog(params, hist, cfg, mesh)            # warm
    ebk.reset_launches()
    dist.reset_counts()
    sync(device)
    t0 = time.perf_counter()
    v, idx = sasrec.topk_catalog(params, hist, cfg, mesh)
    sync(device)
    ms = (time.perf_counter() - t0) * 1e3
    launches = ebk.launches["embedding_bag"]
    # the reference keeps k + 1: a value tied with the first one left out
    # may take the last place
    want_v, want_i = ref["values"][:, :-1], ref["indices"][:, :-1]
    rel = float(((v - want_v).abs() / want_v.abs().clamp(min=1e-30)).max())
    tied = torch.isclose(want_v[:, :, None], ref["values"][:, None, :],
                         rtol=TOPK_RTOL).sum(-1) > 1
    idx_ok = bool(torch.equal(idx.long()[~tied], want_i[~tied]))
    out = {"ms": ms, "rel_err": rel, "enc_err": enc_err,
           "launches": launches, "tied": int(tied.sum()),
           "sent": dict(dist.counts)}
    if not (rel <= TOPK_RTOL and idx_ok and enc_err <= REC_SCORE_TOL):
        raise PhaseError(f"7e top-k rank {rank}: values rel err {rel} "
                         f"(rtol {TOPK_RTOL}), indices equal where untied: "
                         f"{idx_ok}, encode kernel vs plain {enc_err}")
    if device != "cpu" and launches != 1:
        raise PhaseError(f"7e top-k rank {rank}: embedding_bag launched "
                         f"{launches} times (1 expected: the encode)")
    return out


DIST_SUBPHASES = {"7a": _rank_7a, "7a_serve": _rank_7a_serve, "7b": _rank_7b,
                  "7c": _rank_7c, "7d": _rank_7d, "7e": _rank_7e,
                  "7e_step": _rank_7e_step, "7e_topk": _rank_7e_topk}


def dist_ranks(rank, world, seed, plan, ref_dir, devices):
    """One rank of a phase 7 spawn: the sub-phases of ``plan`` in turn on
    ``devices[rank]``, each printing its backend, world size, device,
    seconds and counted collective bytes."""
    import torch.distributed as tdist
    device = devices[rank]
    if device != "cpu":
        torch.cuda.set_device(device)
    out = {}
    for name, kw in plan:
        t0 = time.perf_counter()
        res = DIST_SUBPHASES[name](rank, world, seed, ref_dir, device, **kw)
        sync(device)
        res["rank_s"] = time.perf_counter() - t0
        sent = {}
        for v in [res] + [v for v in res.values() if isinstance(v, dict)]:
            for op, c in v.get("sent", {}).items():
                sent[op] = sent.get(op, 0) + c["bytes"]
        print(f"{name} rank {rank}/{world}: {tdist.get_backend()}, world "
              f"{world}, {device}, {res['rank_s']:.2f} s, collective bytes "
              f"sent {json.dumps(sent)}", flush=True)
        if rank == 0:
            print(f"{name} rank 0: {json.dumps(_brief(res))}", flush=True)
        out[name] = res
    return out


def _op_bytes(sent: dict, prefix: str) -> int:
    return sum(c["bytes"] for k, c in sent.items() if k.startswith(prefix))


def _brief(res):
    """``res`` for one printed line: floats to 4 significant digits,
    lists of floats to their max."""
    if isinstance(res, dict):
        return {k: _brief(v) for k, v in res.items()}
    if isinstance(res, (list, tuple)) and res and all(
            isinstance(v, float) for v in res):
        return {"max": float(f"{max(res):.4g}"), "n": len(res)}
    if isinstance(res, float):
        return float(f"{res:.4g}")
    if isinstance(res, (list, tuple)):
        return [_brief(v) for v in res]
    return res


def phase_dist(seed: int, sizes: dict, device: str = "cuda") -> dict:
    """7: the distribution slice (``dist/`` on ``torch.distributed``),
    one spawned process per rank.  The single-card references run here
    first (the scatter MoE, the gather-decode servers) and go to the
    ranks through files; then 8 gloo ranks sharing the card run 7a's
    expert-parallel MoE on (data 2, model 4) and 7c's gradient sync on
    (pod 2, data 2, model 2), 4 run 7a's MoE server and 7b's split-K
    decode on (model 4), and one NCCL rank runs 7d.  With two cards or
    more, 7a also runs on NCCL across distinct cards.  ``device="cpu"``
    with ``DIST_SIZES["rehearsal"]`` rehearses it on gloo (7d too)."""
    from repro_torch.launch.mesh import run_local
    from repro_torch.models import moe
    from repro_torch.models import transformer
    res = {}
    on_card = device != "cpu"
    if on_card:
        torch.cuda.empty_cache()        # the earlier phases' cached blocks
    with tempfile.TemporaryDirectory() as ref_dir:
        # 7a: the single-card scatter path over every expert
        kw = sizes["7a"]
        cfg = _arch_cfg(kw["arch"], kw.get("reduced", False))
        m = cfg.moe
        p = moe_layer(seed, cfg, range(m.n_experts), device)
        x = moe_tokens(seed, cfg, kw["batch"], kw["seq"], kw["skew"], device)
        t = kw["batch"] * kw["seq"]
        loads = _loads(p, x, m)
        avg = t * m.top_k / m.n_experts
        ample = max(1.25, math.ceil(4 * int(loads.max()) / avg) / 4)
        refs = {"ample_cf": ample}
        for label, cf in (("ample", ample), ("overflow", 1.25)):
            y, _ = moe.moe_block(p, x, dataclasses.replace(
                m, capacity_factor=cf))
            refs[label] = y.cpu()
        cap = moe.capacity(t, dataclasses.replace(m, capacity_factor=1.25))
        dropped = int((loads - cap).clamp(min=0).sum())
        w_bytes = sum(p[k].numel() * p[k].element_size()
                      for k in ("w_gate", "w_up", "w_down"))
        torch.save(refs, os.path.join(ref_dir, "7a.pt"))
        print(f"7a: {cfg.name} one MoE layer: {m.n_experts} experts "
              f"top-{m.top_k}, d {cfg.d_model}, d_expert {m.d_expert}, "
              f"{cfg.dtype}, {w_bytes / 1e9:.3f} GB of experts; tokens "
              f"{kw['batch']} x {kw['seq']} (N(0, 1) + {kw['skew']} x one "
              f"shared vector); mesh (data, model) {kw['mesh']} on "
              f"{math.prod(kw['mesh'])} gloo ranks sharing {device}; "
              f"loads per expert max {int(loads.max())} / mean {avg:.1f}: "
              f"ample capacity factor {ample}, at 1.25 (capacity {cap}) "
              f"{dropped} of {t * m.top_k} pairs dropped; "
              + _cuts(kw, f"one MoE layer of {cfg.n_layers}"), flush=True)
        if not dropped:
            raise PhaseError("7a: no pair overflows at capacity factor 1.25")
        del y
        # 7e: the same layer's backward on the scatter path, every expert
        cot = moe_cotangent(seed, x.shape, device)
        back = {}
        for label, cf in (("ample", ample), ("overflow", 1.25)):
            grads, info = moe_grads(p, x, cot, dataclasses.replace(
                m, capacity_factor=cf))
            back[label] = {"x": grads["x"].cpu(),
                           "router": grads["router"].cpu(),
                           "prints": {k: v.cpu() for k, v in expert_prints(
                               seed, grads, device).items()},
                           "fwd_s": info["fwd_s"], "bwd_s": info["bwd_s"]}
            del grads
        torch.save(back, os.path.join(ref_dir, "7e_moe.pt"))
        res["7e_single"] = {"moe_layer_s": {k: (v["fwd_s"], v["bwd_s"])
                                            for k, v in back.items()}}
        del p, x, cot, back
        if on_card:
            torch.cuda.empty_cache()
        print(f"7e: 7a's layer once more with backward (sum(y * cot), a "
              f"fixed N(0, 1) cot) at both capacity factors on the same 8 "
              f"ranks, against the single-card scatter path's gradients: x "
              f"and the router whole, each expert's gradients through a "
              f"seeded projection (tolerance {GRAD_BF16_TOL}); single-card "
              f"(fwd s, bwd s) {_brief(res['7e_single']['moe_layer_s'])}",
              flush=True)
        # 7a serve: the single-card scatter server
        kw = sizes["7a_serve"]
        cfg = _serve_cfgs(kw["arch"], kw["layers"], kw.get("reduced", False))
        params = transformer.init_params(cfg, seed=seed, device=device)
        prompts = np.random.default_rng(seed).integers(
            0, cfg.vocab, (kw["batch"], kw["prompt"]))
        ref = reference_server(cfg, params, prompts, kw["steps"],
                               kw["prompt"] + kw["steps"], device)
        torch.save(dict(ref, prompts=torch.from_numpy(prompts)),
                   os.path.join(ref_dir, "7a_serve.pt"))
        print(f"7a serve: {cfg.name} d {cfg.d_model}, {cfg.moe.n_experts} "
              f"experts top-{cfg.moe.top_k}, {cfg.dtype}, moe_impl a2a on "
              f"mesh (model {kw['model']}), LMServer {kw['batch']} x "
              f"{kw['prompt']} prompts + {kw['steps']} greedy steps against "
              f"the single-card scatter server (tolerance {A2A_TOL}; a "
              f"decode step's {kw['batch']} tokens must divide over the "
              f"ranks), every attention call held to its plain version; "
              + _cuts(kw, f"depth {get_arch(kw['arch']).config.n_layers} -> "
                      f"{kw['layers']}"), flush=True)
        del params
        # 7b: the single-card gather-decode servers, bf16 and fp32
        kw = sizes["7b"]
        prompts = np.random.default_rng(seed + 2).integers(
            0, 2 ** 31, (kw["batch"], kw["prompt"]))
        for label, n, dt, st in (("bf16", kw["layers"], "bfloat16",
                                  kw["steps"]),
                                 ("fp32", kw["f32_layers"], "float32",
                                  kw["f32_steps"])):
            cfg = _serve_cfgs("gemma3-1b", n, kw.get("reduced", False),
                              dtype=dt, decode_attn="splitk")
            params = transformer.init_params(cfg, seed=seed, device=device)
            pr = prompts % cfg.vocab
            ref = reference_server(cfg, params, pr, st, kw["max_len"],
                                   device)
            torch.save(dict(ref, prompts=torch.from_numpy(pr)),
                       os.path.join(ref_dir, f"7b_{label}.pt"))
            del params
        print(f"7b: gemma3-1b split-K decode on mesh (model {kw['model']}): "
              f"LMServer {kw['batch']} x {kw['prompt']} prompts then "
              f"{kw['steps']} greedy steps at max_len {kw['max_len']} "
              f"({kw['max_len'] // kw['model']} positions per rank), "
              f"{kw['layers']} layers bf16 (tolerance {LM_LOGIT_TOL}) and "
              f"{kw['f32_layers']} layers fp32 over {kw['f32_steps']} steps "
              f"(tolerance {SPLITK_F32_TOL}), in lockstep with the "
              f"single-card server (gather decode), every prefill "
              f"attention call held to its plain version; "
              + _cuts(kw, f"fp32 pass depth 26 -> {kw['f32_layers']}"),
              flush=True)
        if on_card:
            torch.cuda.empty_cache()
        # 7e: the single-card scatter path's loss and gradients
        kw = sizes["7e"]
        from repro_torch.models.layers import ParamTree
        torch.backends.cuda.matmul.allow_tf32 = False
        for label, dt, tokens in (("fp32", "float32", kw["f32_tokens"]),
                                  ("bf16", "bfloat16", kw["bf16_tokens"])):
            cfg = grad_cfg(kw["arch"], kw["layers"], dt,
                           kw.get("reduced", False))
            net = ParamTree(transformer.init_params(cfg, seed=seed,
                                                    device=device))
            t0 = time.perf_counter()
            loss, grads = lm_grads(net, grad_batch(seed, cfg, tokens, device),
                                   cfg)
            sync(device)
            secs = time.perf_counter() - t0
            gnorm = float(adamw.global_norm(grads))
            torch.save({"loss": loss, "gnorm": gnorm,
                        "scale": {k: float(g.float().abs().max())
                                  for k, g in grads.items()},
                        "grads": {k: g.cpu() for k, g in grads.items()}},
                       os.path.join(ref_dir, f"7e_{label}.pt"))
            res["7e_single"][f"{label}_s"] = secs
            del net, grads
            if on_card:
                torch.cuda.empty_cache()
        print(f"7e: {cfg.name} at full width, depth {kw['layers']}, MoE "
              f"layers on the all-to-all on mesh (model {kw['model']}), 4 "
              f"gloo ranks each holding {cfg.moe.n_experts // kw['model']} "
              f"experts: lm_loss and every gradient (what a Trainer step "
              f"differentiates) against the single-card scatter path, fp32 "
              f"at 1 x {kw['f32_tokens']} tokens (tolerance {A2A_TOL} of "
              f"each tensor's largest gradient) and bf16 at 1 x "
              f"{kw['bf16_tokens']} (tolerance {GRAD_BF16_TOL}); "
              f"single-card s {res['7e_single']['fp32_s']:.3f} / "
              f"{res['7e_single']['bf16_s']:.3f}; "
              + _cuts(kw, f"depth {get_arch(kw['arch']).config.n_layers} -> "
                      f"{kw['layers']}"), flush=True)
        # 7e step: one single-card Trainer step on the scatter path
        kw = sizes["7e_step"]
        cfg = step_cfg(kw["arch"], kw["layers"], kw["vocab"],
                       kw.get("reduced", False))
        full = get_arch(kw["arch"]).config
        tr, batch = step_trainer(seed, cfg, kw["tokens"], device,
                                 os.path.join(ref_dir, "step_single"))
        t0 = time.perf_counter()
        fit_step(tr, batch)
        sync(device)
        secs = time.perf_counter() - t0
        gnorm = float(tr.last_metrics["grad_norm"])
        torch.save({"loss": tr.history[-1]["loss"], "grad_norm": gnorm,
                    "mu": {k: v.cpu() for k, v in tr.opt_state.mu.items()}},
                   os.path.join(ref_dir, "7e_step.pt"))
        res["7e_single"]["step_s"] = secs
        n_par = sum(p.numel() for p in tr.model.parameters())
        del tr
        if on_card:
            torch.cuda.empty_cache()
        print(f"7e step: one Trainer step (AdamW, clip_norm "
              f"{STEP_OPT.clip_norm}, {cfg.dtype}) of {cfg.name} at depth "
              f"{kw['layers']}, vocab {cfg.vocab} ({n_par:,} "
              f"parameters), MoE layers on the all-to-all on mesh (model "
              f"{kw['model']}), 4 gloo ranks, 1 x {kw['tokens']} tokens, "
              f"against the single-card scatter path's step ({secs:.3f} s, "
              f"grad norm {gnorm:.6g}): loss, grad norm and each tensor's "
              f"first moment within {A2A_TOL} of the largest (experts "
              f"against the matching slice), each rank's update against "
              f"AdamW in fp64 within {GNN_STEP_TOL}; "
              + ("cuts: reduced config (rehearsal)" if kw.get("reduced")
                 else f"cuts: depth {full.n_layers} -> {kw['layers']}, vocab "
                 f"{full.vocab} -> {cfg.vocab}, the only width cut (at the "
                 f"full vocabulary each rank's fp32 step holds ~27 GB: 4 "
                 f"ranks do not fit one card; 7e's gradients above are at "
                 f"full width)"), flush=True)
        if not gnorm > STEP_OPT.clip_norm:
            raise PhaseError(f"7e step: grad norm {gnorm} does not exceed "
                             f"clip_norm {STEP_OPT.clip_norm}: the clip "
                             f"would not be checked")
        # 7e: dense top-100 over the whole catalogue on the single card
        kw = sizes["7e_topk"]
        from repro_torch.models import sasrec
        cfg = _arch_cfg(kw["arch"], kw.get("reduced", False))
        params = sasrec.init_params(cfg, seed=seed, device=device)
        hist = torch.from_numpy(rec_histories(seed, cfg, kw["batch"])
                                ).to(device)
        sasrec.set_use_kernel(False)
        try:
            scores = sasrec.score_catalog(params, hist, cfg)
        finally:
            sasrec.set_use_kernel(True)
        vals, idx = moe.top_k(scores, 101)
        torch.save({"values": vals.cpu(), "indices": idx.cpu()},
                   os.path.join(ref_dir, "7e_topk.pt"))
        del params, scores, vals, idx
        print(f"7e top-k: {cfg.name}'s published config ("
              f"{sasrec.table_rows(cfg)} x {cfg.d_embed} table), "
              f"{kw['batch']} users (serve_p99) on mesh (data, model) "
              f"{kw['mesh']}: sasrec.topk_catalog against dense "
              f"score_catalog + a stable sort on the single card (values "
              f"rtol {TOPK_RTOL}, indices where untied), the encode's "
              f"embedding_bag held against its plain twin; "
              + _cuts(kw, "none"), flush=True)
        if on_card:
            torch.cuda.empty_cache()
        kw = sizes["7c"]
        print(f"7c: grad_sync and cross_pod_allreduce over {kw['arch']}'s "
              f"parameter tree (a different one per rank) on mesh (pod, "
              f"data, model) {kw['mesh']}, plain and int8 across pods; "
              + _cuts(kw, "none"), flush=True)
        shared = ["cuda:0" if on_card else "cpu"]
        for world, plan in ((8, [("7a", sizes["7a"]), ("7c", sizes["7c"]),
                                 ("7e_topk", sizes["7e_topk"])]),
                            (4, [("7a_serve", sizes["7a_serve"]),
                                 ("7b", sizes["7b"]), ("7e", sizes["7e"]),
                                 ("7e_step", sizes["7e_step"])])):
            t0 = time.perf_counter()
            ranks = run_local(dist_ranks, world, "gloo",
                              args=(seed, plan, ref_dir, shared * world))
            for name, _ in plan:
                res[name] = [r[name] for r in ranks]
            print(f"7 spawn of {world} gloo ranks ({[n for n, _ in plan]}): "
                  f"{time.perf_counter() - t0:.2f} s host wall clock",
                  flush=True)
        for label in ("ample", "overflow"):
            g = res["7a"][0][f"grad_{label}"]
            print(f"7e moe layer rank 0, {label}: forward {g['fwd_s']:.3f} s "
                  f"(all-to-all {_op_bytes(g['fwd_sent'], 'all_to_all@')} "
                  f"B, gathers {_op_bytes(g['fwd_sent'], 'all_gather@')} B),"
                  f" backward {g['bwd_s']:.3f} s (all-to-all "
                  f"{_op_bytes(g['bwd_sent'], 'all_to_all.bwd@')} B, "
                  f"gathers {_op_bytes(g['bwd_sent'], 'all_gather.bwd@')} B,"
                  f" psum {_op_bytes(g['bwd_sent'], 'psum.bwd@')} B); "
                  f"worst error {max(g['errs'].values()):.3g}", flush=True)
        for label in ("fp32", "bf16"):
            r = [x[label] for x in res["7e"]]
            worst = max((x["worst"] for x in r), key=lambda w: w[1])
            print(f"7e {label}: loss err max "
                  f"{max(x['loss_err'] for x in r):.3g}, grad norm err max "
                  f"{max(x['gnorm_err'] for x in r):.3g}, worst tensor "
                  f"{worst}, rank 0 {r[0]['s']:.3f} s for loss + "
                  f"gradients, sent {json.dumps(r[0]['sent'])}", flush=True)
        r = res["7e_step"]
        print(f"7e step: loss err max {max(x['loss_err'] for x in r):.3g}, "
              f"grad norm err max {max(x['gnorm_err'] for x in r):.3g}, "
              f"worst moment {max((x['moment'] for x in r), key=lambda w: w[1])}"
              f", worst update {max((x['update'] for x in r), key=lambda w: w[1])}"
              f"; held {r[0]['held']}; rank 0 {r[0]['s']:.3f} s for the step"
              f"; peak GiB per rank {[x['peak_gib'] for x in r]}; sent "
              f"(rank 0) {json.dumps(r[0]['sent'])}", flush=True)
        t = res["7e_topk"]
        ms = [round(x["ms"], 3) for x in t]
        print(f"7e top-k: ms per call per rank {ms}, values max rel err "
              f"{max(x['rel_err'] for x in t):.3g}, tied places {t[0]['tied']}, encode kernel vs plain "
              f"{max(x['enc_err'] for x in t):.3g}, embedding_bag launches "
              f"per rank {[x['launches'] for x in t]}, sent (rank 0) "
              f"{json.dumps(t[0]['sent'])}", flush=True)
        # 7d: a world of one; NCCL on the card
        kw = dict(sizes["7a"], mesh=(1, 1))
        backend = "nccl" if on_card else "gloo"
        print(f"7d: a world of one on {backend}: 7a's a2a path and 7c's "
              f"syncs on (1, 1) meshes equal the single-device results "
              f"exactly; {_cuts(kw, 'as 7a')}", flush=True)
        res["7d"] = run_local(dist_ranks, 1, backend,
                              args=(seed, [("7d", kw)], ref_dir,
                                    shared))[0]["7d"]
        n_cards = torch.cuda.device_count() if on_card else 0
        if n_cards >= 2:
            world = 1 << (min(n_cards, 8).bit_length() - 1)
            kw = dict(sizes["7a"], mesh=(world // min(world, 4),
                                         min(world, 4)))
            res["7a_nccl"] = [r["7a"] for r in run_local(
                dist_ranks, world, "nccl",
                args=(seed, [("7a", kw)], ref_dir,
                      [f"cuda:{r}" for r in range(world)]))]
            print(f"7a on NCCL across {world} cards, mesh {kw['mesh']}: ran",
                  flush=True)
        else:
            print(f"7a on NCCL across cards: not run ({n_cards} card(s))",
                  flush=True)
    return res


# ---------------------------------------------------------------------------
# Phase 8: the dry run (launch/dryrun on fake tensors) against the card
# ---------------------------------------------------------------------------

# One cell per shape kind (dense and MoE LMs, each GNN kind, the three
# recsys kinds), each on both meshes: the whole grid (80 cells) takes
# minutes of host CPU and stays with ``python -m repro_torch.launch.dryrun``
DRYRUN_CELLS = {"lm_train": ("gemma3-1b", "train_4k"),
                "lm_prefill": ("moonshot-v1-16b-a3b", "prefill_32k"),
                "lm_decode": ("gemma3-1b", "long_500k"),
                "gnn_full": ("pna", "ogb_products"),
                "gnn_mini": ("dimenet", "minibatch_lg"),
                "gnn_mol": ("gat-cora", "molecule"),
                "rec_train": ("sasrec", "train_batch"),
                "rec_serve": ("sasrec", "serve_bulk"),
                "rec_retrieval": ("sasrec", "retrieval_cand")}
DRYRUN_WAIT_S = 300     # phase 8's longest wait for its cells


def dryrun_cells(outdir: str, device: str = "cuda") -> dict:
    """8's cells: ``python -m repro_torch.launch.dryrun --arch A --shape S
    --mesh both`` for each of ``DRYRUN_CELLS``, one subprocess each, all
    started together (fake tensors: host CPU only).  ``DRYRUN_CELLS``
    must name one non-skipped cell of each shape kind in the registry,
    and every cell must end ok."""
    from repro_torch.configs import ARCHS
    kinds = {sh.kind for spec in ARCHS.values()
             for sh in spec.shapes.values() if not sh.skip}
    got = {k: ARCHS[a].shapes[s].kind for k, (a, s) in DRYRUN_CELLS.items()}
    if set(DRYRUN_CELLS) != kinds or any(k != v for k, v in got.items()):
        raise PhaseError(f"8: DRYRUN_CELLS {got} does not hold one cell of "
                         f"each shape kind {sorted(kinds)}")
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    procs, rcs = {}, {}
    try:
        for kind, (arch, shape) in DRYRUN_CELLS.items():
            with open(os.path.join(outdir, f"{kind}.log"), "w") as log:
                procs[kind] = subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.dryrun",
                     "--arch", arch, "--shape", shape, "--mesh", "both",
                     "--outdir", os.path.join(outdir, "cells"), "--device",
                     device], stdout=log, stderr=subprocess.STDOUT,
                    cwd=str(root), env=env)
        for kind, proc in procs.items():
            left = DRYRUN_WAIT_S - (time.perf_counter() - t0)
            rcs[kind] = proc.wait(timeout=max(left, 1))
    except subprocess.TimeoutExpired:
        raise PhaseError(f"8: the dry-run cells did not end in "
                         f"{DRYRUN_WAIT_S} s")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    secs = {}
    for kind, rc in rcs.items():
        text = Path(outdir, f"{kind}.log").read_text()
        ok = [ln for ln in text.splitlines() if ln.startswith("[ok]")]
        if rc != 0 or len(ok) != 2 or "[FAIL]" in text:
            raise PhaseError(f"8: the dry run of {DRYRUN_CELLS[kind]} failed "
                             f"(exit {rc}): {text[-3000:]}")
        secs.update({ln.split()[1].rstrip(":"): float(ln.split()[2][:-1])
                     for ln in ok})
    return {"ok": len(secs), "secs": secs,
            "wall_s": time.perf_counter() - t0}


def phase_dryrun(seed: int, dist_res: dict, dist_sizes: dict, train_cfg,
                 batch: int, seq: int, device: str = "cuda") -> dict:
    """8: the dry run held against the card.  (1) One cell of each shape
    kind (``dryrun_cells``) ends ok on both meshes (seconds per cell
    printed).  (2) Cells shaped as phase 7a's
    layer and 7b's split-K decode count exactly the collective bytes per
    rank that those runs counted.  (3) The fake-tensor FLOP count of
    phase 6b's step (``train_cfg`` at ``batch`` x ``seq``) equals
    ``FlopCounterMode`` over one real step on the card; its measured ms
    beside the dry run's lower bound."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import dryrun, input_specs
    from repro_torch.models import transformer
    from repro_torch.models.layers import ParamTree
    from repro_torch.optim import make_train_step
    print(f"8 dry run: one cell per shape kind, {len(DRYRUN_CELLS)} kinds "
          f"on both meshes (baseline, fake tensors on {device}), each "
          f"through python -m repro_torch.launch.dryrun --arch --shape "
          f"--mesh both in a subprocess of its own, all at once; the whole "
          f"grid is left to the CLI (python -m repro_torch.launch.dryrun "
          f"--mesh both: minutes of host CPU); then a 7a- and a 7b-shaped "
          f"cell and 6b's step against the card", flush=True)
    with tempfile.TemporaryDirectory(prefix="dryrun_") as outdir:
        g = dryrun_cells(outdir, device)
    print(f"8 dry run: {g['ok']} cells ok, none failed, {g['wall_s']:.2f} s "
          f"wall clock; s per cell {json.dumps(g['secs'])}", flush=True)
    out = {"cells": g}
    # (2) 7a's layer and 7b's decode step, counted on fake tensors
    kw = dist_sizes["7a"]
    cfg = _arch_cfg(kw["arch"], kw.get("reduced", False))
    a = dryrun.count_on_mesh(
        kw["mesh"], ("data", "model"),
        lambda mesh: input_specs.moe_layer(cfg, kw["batch"], kw["seq"], mesh,
                                           1.25, device))
    measured = dist_res["7a"][0]["overflow"]["sent"]
    print(f"8 7a-shaped cell: {json.dumps(a['collectives']['by_op'])}; "
          f"phase 7a rank 0 counted {json.dumps(measured)}", flush=True)
    if a["collectives"]["by_op"] != measured:
        raise PhaseError(f"8: the 7a-shaped cell's bytes "
                         f"{a['collectives']['by_op']} != phase 7a's "
                         f"{measured}")
    kw = dist_sizes["7b"]
    cfg = _serve_cfgs("gemma3-1b", kw["layers"], kw.get("reduced", False),
                      decode_attn="splitk")
    b = dryrun.count_on_mesh(
        (kw["model"],), ("model",),
        lambda mesh: input_specs.build_cell(
            "lm_decode", cfg, {"batch": kw["batch"], "seq": kw["max_len"]},
            mesh, "decode_splitk", device))
    per_layer = b["collectives"]["total_bytes"] / cfg.n_layers
    r7b = dist_res["7b"][0]["bf16"]
    measured = sum(c["bytes"] for c in r7b["sent"].values()) \
        / (kw["steps"] * kw["layers"])
    print(f"8 7b-shaped cell: {per_layer:.0f} B per layer and step "
          f"({json.dumps(b['collectives']['by_op'])} over {cfg.n_layers} "
          f"layers); phase 7b counted {measured:.0f} B", flush=True)
    if not per_layer == measured == r7b["bytes_per_layer_step"]:
        raise PhaseError(f"8: the 7b-shaped cell's {per_layer} B per layer "
                         f"and step != phase 7b's {measured}")
    out["7a_cell"], out["7b_per_layer"] = a["collectives"], per_layer
    # (3) phase 6b's step: fake count against the card's
    c = dryrun.count_on_mesh(
        (1, 1), ("data", "model"),
        lambda mesh: input_specs.build_cell(
            "lm_train", train_cfg, {"batch": batch, "seq": seq}, mesh,
            "baseline", device))
    model = ParamTree(transformer.init_params(train_cfg, seed=seed,
                                              device=device))
    opt = adamw.init(dict(model.named_parameters()))
    step = make_train_step(
        lambda m, bb: transformer.lm_loss(m.tree(), bb, train_cfg),
        input_specs.OPT)
    toks = next(synth.token_batches(np.random.default_rng(seed + 5),
                                    train_cfg.vocab, batch, seq))
    tb = {k: torch.from_numpy(np.asarray(v)).to(device)
          for k, v in toks.items()}
    with FlopCounterMode(display=False) as fc:
        model, opt, _ = step(model, opt, tb)
    sync(device)
    real = fc.get_total_flops()
    t0 = time.perf_counter()
    model, opt, metrics = step(model, opt, tb)
    float(metrics["loss"])
    ms = (time.perf_counter() - t0) * 1e3
    r = c["roofline"]
    print(f"8 6b step ({train_cfg.name}, {train_cfg.n_layers} layers, "
          f"{batch} x {seq}, remat per layer): fake-tensor count "
          f"{c['cost']['flops_per_device']:.6e} FLOPs, FlopCounterMode over "
          f"one real step on {device} {real:.6e}; measured {ms:.2f} ms per "
          f"step against the dry run's step_s_lower_bound "
          f"{r['step_s_lower_bound'] * 1e3:.2f} ms (dominant {r['dominant']};"
          f" compute {r['compute_s'] * 1e3:.2f} ms, memory "
          f"{r['memory_s'] * 1e3:.2f} ms)", flush=True)
    del model, opt
    if device != "cpu":
        torch.cuda.empty_cache()
    if c["cost"]["flops_per_device"] != real:
        raise PhaseError(f"8: the fake-tensor FLOP count "
                         f"{c['cost']['flops_per_device']} != the card's "
                         f"{real}")
    out["6b"] = {"flops": real, "ms": ms, "roofline": r}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--users", type=int, default=100_000,
                    help="users of the main deployment (LiveJournal has "
                         "4.85M; ingest through the simulator bounds it)")
    ap.add_argument("--small-users", type=int, default=20_000)
    ap.add_argument("--kernel-n", type=int, default=LIVEJOURNAL_EDGES)
    ap.add_argument("--n-prog", type=int, default=50,
                    help="node programs of each kind per deployment")
    ap.add_argument("--n-tx", type=int, default=300)
    ap.add_argument("--serve-requests", type=int, default=20_000,
                    help="requests of the main deployment's first serving "
                         "loop (the second takes a fifth, the open loop a "
                         "quarter)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--mp-n", type=int, default=OGB_PRODUCTS[0],
                    help="nodes of the full-size segment_mp case "
                         "(ogb-products)")
    ap.add_argument("--mp-e", type=int, default=OGB_PRODUCTS[1],
                    help="edges of the full-size segment_mp case")
    ap.add_argument("--gnn-steps", type=int, default=12,
                    help="AdamW steps of gin-tu on the live snapshot")
    ap.add_argument("--flash-seq", type=int, default=LM_SEQ,
                    help="sequence of the full-size flash_attention cases "
                         "(prefill_32k / decode_32k)")
    ap.add_argument("--decode-batch", type=int, default=DECODE_BATCH)
    ap.add_argument("--lm-batch", type=int, default=8)
    ap.add_argument("--lm-prompt", type=int, default=1024)
    ap.add_argument("--lm-steps", type=int, default=32)
    ap.add_argument("--rec-batch", type=int, default=512,
                    help="users per top_k call (sasrec's serve_p99)")
    ap.add_argument("--rec-cands", type=int, default=1_000_000,
                    help="candidates scored (sasrec's retrieval_cand)")
    ap.add_argument("--train-sizes", choices=sorted(TRAIN_SIZES),
                    default="full", help="sizes of the training phases "
                    "6a-6d (TRAIN_SIZES)")
    ap.add_argument("--dist-sizes", choices=sorted(DIST_SIZES),
                    default="full", help="sizes of the distribution phase "
                    "7a-7d (DIST_SIZES)")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 2
    card = smi_line()
    print(f"device: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}",
          flush=True)

    t0 = time.perf_counter()
    paths = build.build_all()
    print(f"built {sorted(paths)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, log in build.build_log.items():
        for line in log.strip().splitlines():
            print(f"nvcc {name}: {line}")

    timings = phase_kernels(args.seed, args.kernel_n, args.reps)
    mp_timing = phase_segment_mp(args.seed, (args.mp_n, args.mp_e,
                                             *OGB_PRODUCTS[2:]), args.reps)
    # the 32k cases take up to a second per call: fewer reps
    big_reps = max(2, args.reps // 4)
    flash_timing = phase_flash(args.seed, args.flash_seq, args.decode_batch,
                               big_reps)
    bag_timing = phase_bag(args.seed, args.reps)

    main_counts, w, serve_counts = deployment(
        "main", args.seed, args.users, plane=True, n_prog=args.n_prog,
        n_tx=args.n_tx, oracle=False, keep=True,
        serve_requests=args.serve_requests)
    missing = [k for k in ("before", "before_pairs")
               if not (serve_counts or {}).get(k)]
    if missing:
        raise PhaseError(f"main: kernels {missing} were never launched in "
                         f"the serving steps: {serve_counts}")
    forms = plane_mask_forms(w.device_plane, args.reps)
    print(f"main: plane before_all over {forms['rows']} resident rows "
          f"({forms['synced_rows']} synced), median host ms of {args.reps} "
          f"calls: bytes {json.dumps(forms['bytes'])}, bits "
          f"{json.dumps(forms['bits'])}", flush=True)
    # phase 3c, on the card Weaver before phase 3b writes to it
    t0 = time.perf_counter()
    phase_traversals(w, args.seed, max(2, args.reps // 4))
    print(f"traversals phase: {time.perf_counter() - t0:.2f} s host wall "
          f"clock", flush=True)
    # the GNN slice's path, driven on the main deployment's card Weaver
    mvk.reset_launches()
    smpk.reset_launches()
    t0 = time.perf_counter()
    phase_gnn(w, args.seed, args.gnn_steps)
    torch.cuda.synchronize()
    gnn_counts = {**mvk.launches, **smpk.launches}
    print(f"gnn phase: {time.perf_counter() - t0:.2f} s host wall clock, "
          f"launches {gnn_counts}", flush=True)
    if not gnn_counts["segment_mp"]:
        raise PhaseError(f"gnn: segment_mp was never launched on the path: "
                         f"{gnn_counts}")
    gin = get_arch("gin-tu").config          # its two propagate widths
    want = {f"segment_mp_{o}": 0 for o in ("aggregate", "transform")}
    for d_in in (gin.d_feat, gin.d_hidden):
        want[f"segment_mp_{mp_order(d_in, gin.d_hidden, torch.float32)}"] \
            += args.gnn_steps
    if {k: gnn_counts[k] for k in want} != want:
        raise PhaseError(f"gnn: segment_mp orders {gnn_counts}, expected "
                         f"{want}")
    del w
    small_counts, *_ = deployment("host-global", args.seed + 1,
                                  args.small_users, plane=False,
                                  n_prog=max(1, args.n_prog // 5),
                                  n_tx=max(1, args.n_tx // 5), oracle=True)
    t0 = time.perf_counter()
    phase_entry_points()
    print(f"entry points phase: {time.perf_counter() - t0:.2f} s host wall "
          f"clock", flush=True)
    for label, counts in (("main", main_counts),
                          ("host-global", small_counts)):
        missing = [k for k in ("before", "before_pairs") if not counts[k]]
        if label == "main":
            missing += [] if counts["visibility"] else ["visibility"]
        if missing:
            raise PhaseError(f"{label}: kernels {missing} were never "
                             f"launched on the path: {counts}")

    # the LM slice's path, then the recsys slice's, each with its counts
    # set to 0 just before it and read just after
    lm = phase_lm(args.seed, args.lm_batch, args.lm_prompt, args.lm_steps)
    rec = phase_rec(args.seed, args.rec_batch, args.rec_cands)

    # the training slice: no kernel on the grad path, each no-grad path's
    # kernels counted from 0 inside its phase
    sizes = TRAIN_SIZES[args.train_sizes]
    lm_train = dict(sizes["6b"])
    gemma = dataclasses.replace(get_arch("gemma3-1b").config,
                                n_layers=lm_train.pop("layers"))
    for label, fn, kw in (("6a", phase_lm_lockstep, sizes["6a"]),
                          ("6b", phase_lm_train, dict(lm_train, cfg=gemma)),
                          ("6c", phase_moe, sizes["6c"]),
                          ("6d", phase_rec_train, sizes["6d"])):
        t0 = time.perf_counter()
        fn(args.seed, **kw)
        print(f"{label} phase: {time.perf_counter() - t0:.2f} s host wall "
              f"clock", flush=True)
    t0 = time.perf_counter()
    phase_train_entry_points()
    print(f"6e phase: {time.perf_counter() - t0:.2f} s host wall clock",
          flush=True)

    # the distribution slice, in spawned ranks (their kernels count there)
    t0 = time.perf_counter()
    dist_res = phase_dist(args.seed, DIST_SIZES[args.dist_sizes])
    print(f"7 phase: {time.perf_counter() - t0:.2f} s host wall clock",
          flush=True)

    # the dry run, cross-checked against phases 6b and 7
    t0 = time.perf_counter()
    phase_dryrun(args.seed, dist_res, DIST_SIZES[args.dist_sizes], gemma,
                 **{k: sizes["6b"][k] for k in ("batch", "seq")})
    print(f"8 phase: {time.perf_counter() - t0:.2f} s host wall clock",
          flush=True)

    rows = []
    for name in ("before", "visibility", "before_pairs"):
        t, replaces = timings[(name, 3)], KERNELS[name]
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/csrc/mv_visibility.cu",
                     "replaces": replaces, "launches": main_counts[name],
                     "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": "bytes", "library_ms": None})
    rows.append({"name": "segment_mp", "route": "cuda",
                 "source": "src/repro_torch/csrc/segment_mp.cu",
                 "replaces": KERNELS["segment_mp"],
                 "launches": gnn_counts["segment_mp"], **mp_timing})
    rows.append({"name": "flash_attention", "route": "cuda",
                 "source": "src/repro_torch/csrc/flash_attention_tc.cu",
                 "replaces": KERNELS["flash_attention"],
                 "launches": lm["variants"]["flash_tc"],
                 **flash_timing[f"prefill S={args.flash_seq} window=None"]})
    rows.append({"name": "flash_decode", "route": "cuda",
                 "source": "src/repro_torch/csrc/flash_decode.cu",
                 "replaces": KERNELS["flash_decode"],
                 "launches": lm["variants"]["flash_decode"],
                 **flash_timing[f"decode B={args.decode_batch} "
                                f"Sk={args.flash_seq} kv_len"]})
    rows.append({"name": "embedding_bag", "route": "cuda",
                 "source": "src/repro_torch/csrc/embedding_bag.cu",
                 "replaces": KERNELS["embedding_bag"],
                 "launches": rec["launches"],
                 "max_abs_err": bag_timing["max_abs_err"],
                 **bag_timing["runs"]["train_batch sum"]})
    print(json.dumps({"kernels": rows}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
