"""The port's cell builder (``repro_torch.launch.input_specs``) against
the reference's ``launch/input_specs.py``.

* ``meta`` of every non-skipped cell of ``configs.ARCHS``, under every
  variant that applies to its kind, equals the reference's
  ``build(...).meta`` exactly; the reference builds on 8 host devices
  (mesh (data 2, model 4)) in a subprocess, the port on a fake process
  group of 8 ranks with the same mesh.
* ``sasrec.topk_catalog`` (``_rec_serve``'s distributed top-k) on 8 gloo ranks,
  mesh (data 2, model 4), equals dense ``score_catalog`` plus a stable
  argsort: values at rtol 1e-5, indices wherever the values are not
  tied (the port's check for the reference's failing
  ``test_serve_topk_matches_dense``).
* ``init_cache(window_bounded=True)`` has the reference's shape for a
  windowed-only config and for gemma3-1b, and ``decode_step`` on it gives
  the reference's logits (fp32, 2e-4: the dense LM tests' tolerance).
* The arguments are fake tensors (no memory) on the asked device, the
  seams are off inside a step and restored after it, even on an error.
"""

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import dist
from repro_torch.configs import ARCHS
from repro_torch.launch import dryrun, input_specs
from repro_torch.launch.mesh import run_local
from repro_torch.models import sasrec, transformer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = {"lm_train": ("baseline", "no_fsdp", "no_remat", "moe_a2a"),
            "lm_prefill": ("baseline", "no_fsdp"),
            "lm_decode": ("baseline", "no_fsdp", "decode_splitk",
                          "window_cache"),
            "gnn_full": ("baseline", "gnn_constrained", "gnn_nodes"),
            "gnn_mini": ("baseline", "gnn_constrained", "gnn_nodes"),
            "gnn_mol": ("baseline", "gnn_constrained", "gnn_nodes"),
            "rec_train": ("baseline",), "rec_serve": ("baseline",),
            "rec_retrieval": ("baseline",)}


def cells():
    out = []
    for aid, spec in ARCHS.items():
        for sname, sh in spec.shapes.items():
            if sh.skip:
                continue
            for v in VARIANTS[sh.kind]:
                if v == "moe_a2a" and spec.config.moe is None:
                    continue
                out.append((aid, sname, v))
    return out


REF_META = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, {src!r})
    import jax
    from repro import dist
    from repro.launch import input_specs
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    dist.set_mesh(mesh)
    out = {{}}
    for aid, sname, v in {cells!r}:
        out[f"{{aid}}/{{sname}}/{{v}}"] = input_specs.build(
            aid, sname, mesh, v).meta
    with open({out!r}, "w") as f:
        json.dump(out, f)
""")


@pytest.fixture(scope="module")
def ref_meta():
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "meta.json")
        proc = subprocess.run(
            [sys.executable, "-c", REF_META.format(
                src=os.path.join(REPO, "src"), cells=cells(), out=path)],
            capture_output=True, text=True, timeout=600,
            env=dict(os.environ, JAX_PLATFORMS="cpu"))
        assert proc.returncode == 0, proc.stderr[-3000:]
        with open(path) as f:
            return json.load(f)


@pytest.fixture(scope="module")
def port_meta():
    out = {}
    with dryrun.fake_world(8):
        mesh = dist.make_mesh((2, 4), ("data", "model"))
        dist.set_mesh(mesh)
        try:
            for aid, sname, v in cells():
                low = input_specs.build(aid, sname, mesh, v, device="cpu")
                out[f"{aid}/{sname}/{v}"] = json.loads(json.dumps(low.meta))
        finally:
            dist.set_mesh(None)
    return out


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_meta_matches_reference(ref_meta, port_meta, arch):
    assert len(port_meta) == len(cells()) > 100
    assert sorted(port_meta) == sorted(ref_meta)
    keys = [k for k in ref_meta if k.split("/")[0] == arch]
    assert keys
    for key in keys:
        assert port_meta[key] == ref_meta[key], key


def test_cells_hold_fake_tensors_on_the_asked_device():
    from torch._subclasses.fake_tensor import FakeTensor
    with dryrun.fake_world(8):
        mesh = dist.make_mesh((2, 4), ("data", "model"))
        dist.set_mesh(mesh)
        try:
            low = input_specs.build("qwen3-moe-235b-a22b", "train_4k", mesh,
                                    "moe_a2a", device="cpu")
            model, opt, batch = low.args
            params = dict(model.named_parameters())
            assert all(isinstance(p, FakeTensor) for p in params.values())
            assert all(p.device == torch.device("cpu")
                       for p in params.values())
            # this rank's 32 of the 128 experts; the rest whole
            assert params["layers.moe.w_gate"].shape == (94, 32, 4096, 1536)
            assert params["embed.table"].shape == (151936, 4096)
            assert batch["tokens"].shape == (256, 4096)
            low = input_specs.build("gemma3-1b", "decode_32k", mesh,
                                    "decode_splitk", device="cpu")
            cache = low.args[1]
            assert cache["k"].shape == (26, 64, 8192, 1, 256)   # the block
            assert "spec" in cache
        finally:
            dist.set_mesh(None)


def test_plain_math_restores_the_seams():
    from repro_torch.models import mp
    seams = (transformer, sasrec, mp)
    before = [m._USE_KERNEL for m in seams]
    with pytest.raises(RuntimeError, match="boom"):
        with input_specs.plain_math():
            assert not any(m._USE_KERNEL for m in seams)
            raise RuntimeError("boom")
    assert [m._USE_KERNEL for m in seams] == before


# ------------------------------------------------------- distributed top-k
TOPK_CFG = sasrec.SASRecConfig(name="t", n_items=4064, seq_len=8, d_embed=16)


def topk_hist():
    return np.random.default_rng(1).integers(
        1, TOPK_CFG.n_items + 1, (8, TOPK_CFG.seq_len))


def topk_ranks(rank, world):
    mesh = dist.make_mesh((2, 4), ("data", "model"))
    params = sasrec.init_params(TOPK_CFG, seed=0, device="cpu")
    dist.reset_counts()
    v, idx = sasrec.topk_catalog(params, torch.from_numpy(topk_hist()),
                                 TOPK_CFG, mesh)
    return v.numpy(), idx.numpy(), dict(dist.counts)


def test_rec_topk_matches_dense():
    ranks = run_local(topk_ranks, 8, "gloo")
    params = sasrec.init_params(TOPK_CFG, seed=0, device="cpu")
    scores = sasrec.score_catalog(params, torch.from_numpy(topk_hist()),
                                  TOPK_CFG).numpy()
    ref_idx = np.argsort(-scores, axis=1, kind="stable")[:, :100]
    ref_v = np.take_along_axis(scores, ref_idx, axis=1)
    for v, idx, sent in ranks:
        np.testing.assert_allclose(v, ref_v, rtol=1e-5)
        tied = np.isclose(ref_v[:, :, None], ref_v[:, None, :],
                          rtol=1e-5).sum(-1) > 1
        np.testing.assert_array_equal(idx[~tied], ref_idx[~tied])
        assert idx.dtype == np.int32
        # each rank's (4, 100) block of values and of indices, gathered
        # over data then model
        assert sent == {"all_gather@data": {"calls": 2,
                                            "bytes": 2 * 4 * 100 * 4},
                        "all_gather@model": {"calls": 2,
                                             "bytes": 2 * 8 * 100 * 4}}


# ------------------------------------------------------ window-bounded cache
def test_window_bounded_cache_matches_reference():
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch as ref_get_arch
    from repro.launch.train import reduced_config as ref_reduced
    from repro.models import transformer as RT
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import reduced_config

    # gemma3-1b: a global layer in the pattern, so max_len slots
    full_r, full_p = ref_get_arch("gemma3-1b").config, \
        get_arch("gemma3-1b").config
    want = jax.eval_shape(lambda: RT.init_cache(full_r, 2, 4096,
                                                window_bounded=True))
    mode = input_specs.fake_mode()
    with mode:
        got = transformer.init_cache(full_p, 2, 4096, device="cpu",
                                     window_bounded=True)
    assert tuple(got["k"].shape) == tuple(want["k"].shape)
    assert got["k"].shape[2] == 4096
    # windowed only: the largest window's slots
    rc = dataclasses.replace(ref_reduced(ref_get_arch("gemma3-1b")),
                             window_pattern=(4, 6), dtype="float32")
    pc = dataclasses.replace(reduced_config(get_arch("gemma3-1b")),
                             window_pattern=(4, 6), dtype="float32")
    rcache = RT.init_cache(rc, 2, 64, window_bounded=True)
    pcache = transformer.init_cache(pc, 2, 64, device="cpu",
                                    window_bounded=True)
    assert tuple(pcache["k"].shape) == tuple(rcache["k"].shape)
    assert pcache["k"].shape[2] == 6
    assert transformer.cache_len(pc, 64, window_bounded=True) == 6
    assert transformer.cache_len(pc, 64) == 64
    # decode_step on it, against the reference's, over 8 steps (past
    # the 6 slots: both write the last slot from then on)
    rp = RT.init_params(jax.random.PRNGKey(0), rc)
    pp = transformer.params_from_jax(jax.tree_util.tree_map(np.asarray, rp))
    toks = np.random.default_rng(2).integers(0, pc.vocab, (8, 2, 1))
    step = jax.jit(lambda p, c, t: RT.decode_step(p, c, t, rc))
    for t in toks:
        want, rcache = step(rp, rcache, jnp.asarray(t, jnp.int32))
        got, pcache = transformer.decode_step(
            pp, pcache, torch.from_numpy(t).to(torch.int32), pc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-4, atol=2e-4)
