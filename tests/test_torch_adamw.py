"""The port's AdamW (``repro_torch.optim.adamw``) == the reference's
(``repro.optim.adamw``): schedules at their edges, global-norm clipping
on both sides of the threshold, and several update steps (fp32 moments,
decay on every parameter, bf16 parameters), on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as ref
from repro_torch.optim import adamw


def cfgs(**kw):
    return ref.AdamWConfig(**kw), adamw.AdamWConfig(**kw)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "const"])
@pytest.mark.parametrize("warmup,total", [(0, 10), (1, 1), (5, 20),
                                          (100, 50)])
def test_schedule_lr_matches_reference(schedule, warmup, total):
    rc, pc = cfgs(lr=3e-3, warmup_steps=warmup, total_steps=total,
                  schedule=schedule)
    for step in (0, 1, warmup, warmup + 1, total, total + 7):
        want = float(ref.schedule_lr(rc, jnp.asarray(step, jnp.int32)))
        got = adamw.schedule_lr(pc, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=0)
        np.testing.assert_allclose(float(adamw.schedule_lr(pc, step)), want,
                                   rtol=1e-6, atol=0)


def tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": (rng.normal(size=(3, 4)) * scale).astype(np.float32),
            "b": (rng.normal(size=(5,)) * scale).astype(np.float32),
            "z": np.zeros((2,), np.float32)}


@pytest.mark.parametrize("scale,max_norm", [(1.0, 100.0), (1.0, 0.5),
                                            (0.0, 1.0)])
def test_clip_by_global_norm_matches_reference(scale, max_norm):
    g = tree(0, scale)
    want, wnorm = ref.clip_by_global_norm(
        jax.tree_util.tree_map(jnp.asarray, g), max_norm)
    got, norm = adamw.clip_by_global_norm(
        {k: torch.from_numpy(v) for k, v in g.items()}, max_norm)
    np.testing.assert_allclose(float(norm), float(wnorm), rtol=1e-6)
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=0)
    assert float(adamw.global_norm({})) == 0.0


@pytest.mark.parametrize("clip", [None, 0.3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_update_steps_match_reference(clip, dtype):
    rc, pc = cfgs(lr=1e-2, warmup_steps=2, total_steps=6, clip_norm=clip,
                  weight_decay=0.1)
    p0 = tree(1)
    jp = {k: jnp.asarray(v, dtype) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v).to(getattr(torch, dtype))
          for k, v in p0.items()}
    js, ts = ref.init(jp), adamw.init(tp)
    for step in range(5):
        g = tree(10 + step)
        g["z"][:] = 0.0                      # a parameter with no gradient
        jp, js, jm = ref.update(rc, {k: jnp.asarray(v, dtype)
                                     for k, v in g.items()}, js, jp)
        tp, ts, tm = adamw.update(pc, {k: torch.from_numpy(v).to(
            getattr(torch, dtype)) for k, v in g.items()}, ts, tp)
        assert int(ts.step) == int(js.step) == step + 1
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        tol = 1e-5 if dtype == "float32" else 1e-2
        for k in p0:
            assert tp[k].dtype == getattr(torch, dtype)
            assert ts.mu[k].dtype == ts.nu[k].dtype == torch.float32
            np.testing.assert_allclose(
                tp[k].float().numpy(), np.asarray(jp[k], np.float32),
                rtol=tol, atol=tol)
            np.testing.assert_allclose(ts.mu[k].numpy(), np.asarray(
                js.mu[k]), rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(ts.nu[k].numpy(), np.asarray(
                js.nu[k]), rtol=1e-5, atol=1e-9)


def test_train_step_copies_into_module_and_reports():
    lin = torch.nn.Linear(3, 2)
    before = {k: p.detach().clone() for k, p in lin.named_parameters()}
    ids = {k: id(p) for k, p in lin.named_parameters()}
    step = adamw.make_train_step(
        lambda m, b: (m(b).square().mean(), {"aux": m(b).sum()}),
        adamw.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=2))
    x = torch.ones(4, 3)
    lin, state, m = step(lin, adamw.init(dict(lin.named_parameters())), x)
    assert set(m) == {"aux", "lr", "grad_norm", "total_loss"}
    assert int(state.step) == 1
    for k, p in lin.named_parameters():
        assert id(p) == ids[k] and not torch.equal(p, before[k])
