"""Split-K decode (``decode_attn="splitk"``, ``transformer.
_decode_attn_splitk``) on 8 gloo ranks of a (data 2, model 4) mesh, each
a spawned process on the CPU, at the reference test's reduced gemma3
config (3 layers, d 32, 4 heads over 1 KV head, window_pattern (4, 0),
fp32, max_len 16: 4 positions per rank).

* ``decode_step`` with the cache held as each rank's block against the
  port's gather decode over the whole cache, at the reference test's
  5e-5 relative, for every position from 8 to 15 (8 and 12 open a rank's
  block).
* ``_decode_attn_splitk`` of one layer against the reference's, jitted
  in a subprocess with 8 host devices (outside ``with mesh:``, which
  fails on this tree's jax), on rows at a block's first slot, inside a
  block and past a full cache (where no rank writes: the reference's
  split-K semantics, unlike gather decode's overwritten last slot);
  outputs and the updated caches.
* The counted collective bytes per layer and step: the partials (a
  pmax over (B, H), a psum over (B, H) and one over (B, H, dh), fp32)
  and the batch gather of the attention output, never a cache block.
* ``LMServer`` on the mesh gives the single-process server's tokens.
* The ``chip_smoke.py`` phase 7 rehearsal on the CPU (``phase_dist``).
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import dist
from repro_torch.configs import get_arch
from repro_torch.launch.mesh import run_local
from repro_torch.models import transformer as T
from repro_torch.runtime import LMServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 5e-5          # max |err| / max |logit|: the reference test's
CFG = dict(n_layers=3, d_model=32, n_heads=4, n_kv=1, d_head=8, d_ff=64,
           vocab=64, dtype="float32", window_pattern=(4, 0))
B, PROMPT, MAX_LEN = 2, 8, 16
# per-row lens of the one-layer cases: a block's first slot, inside
# blocks, the last slot, and past a full cache
LENS = [(8, 12), (13, 15), (12, 16), (16, 17)]


def cfg_for(decode_attn="gather"):
    return dataclasses.replace(get_arch("gemma3-1b").config,
                               decode_attn=decode_attn, **CFG)


def layer_inputs():
    rng = np.random.default_rng(3)
    d, dq, dkv = 32, 32, 8
    s = np.float32(1 / np.sqrt(d))
    return {"wq": rng.standard_normal((d, dq), np.float32) * s,
            "wk": rng.standard_normal((d, dkv), np.float32) * s,
            "wv": rng.standard_normal((d, dkv), np.float32) * s,
            "wo": rng.standard_normal((dq, d), np.float32) * s,
            "x": rng.standard_normal((B, 1, d), np.float32),
            "kc": rng.standard_normal((B, MAX_LEN, 1, 8), np.float32),
            "vc": rng.standard_normal((B, MAX_LEN, 1, 8), np.float32)}


JAX_SCRIPT = textwrap.dedent("""
    import dataclasses, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, {src!r})
    import numpy as np
    import jax
    import jax.numpy as jnp
    from repro.configs import get_arch
    from repro.models import transformer
    a = dict(np.load({inp!r}))
    cfg = dataclasses.replace(get_arch("gemma3-1b").config, **{cfg!r})
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    f = jax.jit(transformer._decode_attn_splitk, static_argnums=(2, 6, 7))
    p = {{k: jnp.asarray(a[k]) for k in ("wq", "wk", "wv", "wo")}}
    out = {{}}
    for lens in {lens!r}:
        for window in (4, 0):
            o, nk, nv = f(p, jnp.asarray(a["x"]), cfg, jnp.asarray(a["kc"]),
                          jnp.asarray(a["vc"]), jnp.asarray(lens, jnp.int32),
                          window, mesh)
            key = f"{{lens}}_{{window}}"
            out[key + "_o"] = np.asarray(o)
            out[key + "_k"] = np.asarray(nk)
            out[key + "_v"] = np.asarray(nv)
    np.savez({out!r}, **out)
""")


def splitk_ranks(rank, world, a):
    mesh = dist.make_mesh((2, 4), ("data", "model"))
    gather, splitk = cfg_for(), cfg_for("splitk")
    params = T.init_params(gather, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, gather.vocab, (B, PROMPT)))
    _, cg = T.prefill(params, toks, gather, max_len=MAX_LEN)
    dist.set_mesh(mesh)
    out = {"steps": []}
    try:
        _, cs = T.prefill(params, toks, splitk, max_len=MAX_LEN)
        out["block"] = tuple(cs["k"].shape)
        nxt = np.random.default_rng(2).integers(0, gather.vocab,
                                                (MAX_LEN - PROMPT, B, 1))
        for t in nxt:
            t = torch.from_numpy(t)
            pos = int(cg["len"][0])
            lg, cg = T.decode_step(params, cg, t, gather)
            dist.reset_counts()
            ls, cs = T.decode_step(params, cs, t, splitk)
            out["steps"].append((pos, lg.numpy(), ls.numpy(),
                                 dict(dist.counts)))
        # one layer against the reference's, whole caches cut to blocks
        p = {k: torch.from_numpy(a[k]) for k in ("wq", "wk", "wv", "wo")}
        spec = dist.P(("data",), "model", None, None)
        for lens in LENS:
            for window in (4, 0):
                kc = dist.local_block(torch.from_numpy(a["kc"]), spec,
                                      mesh).clone()
                vc = dist.local_block(torch.from_numpy(a["vc"]), spec,
                                      mesh).clone()
                o, nk, nv = T._decode_attn_splitk(
                    p, torch.from_numpy(a["x"]), splitk, kc, vc,
                    torch.tensor(lens, dtype=torch.int32), window, mesh)
                key = f"{lens}_{window}"
                out[key + "_o"] = o.numpy()
                out[key + "_k"] = dist.reassemble(nk, spec, mesh).numpy()
                out[key + "_v"] = dist.reassemble(nv, spec, mesh).numpy()
        # the server on the mesh
        srv = LMServer(params, splitk, batch=B, max_len=MAX_LEN,
                       device="cpu")
        first = srv.prefill_batch(toks.numpy())
        out["tokens"] = np.concatenate(
            [first[:, None], srv.decode(first, 6)], axis=1)
    finally:
        dist.set_mesh(None)
    srv = LMServer(params, gather, batch=B, max_len=MAX_LEN, device="cpu")
    first = srv.prefill_batch(toks.numpy())
    out["tokens_single"] = np.concatenate(
        [first[:, None], srv.decode(first, 6)], axis=1)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("splitk")
    a = layer_inputs()
    np.savez(tmp / "in.npz", **a)
    script = JAX_SCRIPT.format(src=os.path.join(REPO, "src"),
                               inp=str(tmp / "in.npz"),
                               out=str(tmp / "jax.npz"), cfg=CFG, lens=LENS)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", script], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        out = run_local(splitk_ranks, 8, "gloo", args=(a,))
    finally:
        _, se = ref.communicate(timeout=300)
    assert ref.returncode == 0, se[-3000:]
    return out, dict(np.load(tmp / "jax.npz"))


def rel(got, want) -> float:
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))


def test_decode_step_matches_gather_decode(ranks):
    out, _ = ranks
    for r in out:
        assert r["block"] == (3, 1, 4, 1, 8)      # (L, B/2, S/4, kv, dh)
        assert [s[0] for s in r["steps"]] == list(range(PROMPT, MAX_LEN))
        for pos, lg, ls, _ in r["steps"]:
            assert rel(ls, lg) < TOL, pos
            np.testing.assert_array_equal(ls, out[0]["steps"][pos - PROMPT][2])


@pytest.mark.parametrize("lens", LENS)
@pytest.mark.parametrize("window", [4, 0])
def test_layer_matches_reference(ranks, lens, window):
    out, ref = ranks
    key = f"{lens}_{window}"
    a = layer_inputs()
    for r in out:
        assert rel(r[key + "_o"], ref[key + "_o"]) < TOL
        for c in ("k", "v"):
            # the same slots written (one per row within the cache, none
            # past full), holding the new row within rounding of the
            # projection; every other slot untouched
            got, want = r[f"{key}_{c}"], ref[f"{key}_{c}"]
            written = np.any(got != a[c + "c"], axis=(2, 3))
            np.testing.assert_array_equal(
                written, np.any(want != a[c + "c"], axis=(2, 3)))
            assert written.sum() == sum(n < MAX_LEN for n in lens)
            assert rel(got, want) < TOL


def test_only_partials_cross_the_wire(ranks):
    """Per layer and step: a pmax of (B/2, H, 1), psums of (B/2, H, 1) and
    (B/2, 1, H, dh) in fp32, and the batch gather of the (B/2, 1, H, dh)
    output, and nothing else (at this size a cache block, 128 bytes, is
    no larger than a partial: the exact list is the check)."""
    out, _ = ranks
    L, bl, h, dh = CFG["n_layers"], B // 2, CFG["n_heads"], CFG["d_head"]
    want = {"pmax@model": {"calls": L, "bytes": L * bl * h * 4},
            "psum@model": {"calls": 2 * L,
                           "bytes": L * bl * h * (dh + 1) * 4},
            "all_gather@data": {"calls": L, "bytes": L * bl * h * dh * 4}}
    for r in out:
        for *_, sent in r["steps"]:
            assert sent == want


def test_server_on_the_mesh(ranks):
    out, _ = ranks
    for r in out:
        np.testing.assert_array_equal(r["tokens"], r["tokens_single"])


def test_dist_phase_rehearsal():
    """``chip_smoke.py`` phase 7 on the CPU: every sub-phase at reduced
    configs on gloo ranks (7d's world of one on gloo, not NCCL)."""
    sys.path.insert(0, REPO)
    import chip_smoke
    res = chip_smoke.phase_dist(0, chip_smoke.DIST_SIZES["rehearsal"],
                                device="cpu")
    assert set(res) == {"7a", "7a_serve", "7b", "7c", "7d"}, res
    kw = chip_smoke.DIST_SIZES["rehearsal"]
    for r in res["7a_serve"]:    # prefill and every step, each held
        assert r["attention"]["calls"] == \
            kw["7a_serve"]["layers"] * (kw["7a_serve"]["steps"] + 1)
    for r in res["7b"]:          # the prefills of both passes
        assert r["bf16"]["attention"]["calls"] == kw["7b"]["layers"]
        assert r["fp32"]["attention"]["calls"] == kw["7b"]["f32_layers"]
