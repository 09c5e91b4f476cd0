"""The port's step-cost counter (``repro_torch.launch.hlo_cost``), in the
form of ``tests/test_hlo_cost.py``: one eager run on fake tensors counts
every layer (Python's loop runs each), so the checks the reference makes
on its ``while``-loop correction become checks that the count is exact:

* a product counts 2 * M * N * K, a batched one B times that;
* n layers of a reduced LM count n times one layer plus the head (the
  embedding is a gather: no FLOPs), forward and with the backward;
* FLOPs equal the reference's ``hlo_cost.analyze`` of the same reduced
  cell compiled by JAX on the CPU, forward and ``jax.grad`` of
  ``lm_loss`` (remat per layer and per vocab chunk on both sides), within
  a relative 1e-6 (both count each product's 2 * M * N * K; they agree
  exactly on these cells);
* a collective inside a layer loop counts once per layer (calls and
  bytes), on a fake process group of 8 ranks;
* bytes: a product reads its inputs and writes its output once, a view
  moves nothing, a gather reads only the rows it selects.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.launch import hlo_cost as RH
from repro.launch.train import reduced_config as ref_reduced
from repro.models import transformer as RT
from repro_torch import dist
from repro_torch.configs import get_arch
from repro_torch.launch import dryrun, hlo_cost, input_specs
from repro_torch.launch.train import reduced_config
from repro_torch.models import transformer as PT
from repro_torch.models.layers import ParamTree

REF_TOL = 1e-6     # port FLOPs vs the reference's analyze(), relative


def fake(*shapes, dtypes=None):
    """Fake fp32 tensors of ``shapes`` (``dtypes`` per shape), in one
    fake-tensor mode."""
    mode = input_specs.fake_mode()
    dtypes = dtypes or [torch.float32] * len(shapes)
    with mode:
        return [torch.empty(s, dtype=dt) for s, dt in zip(shapes, dtypes)]


def test_dot_flops_exact():
    a, b = fake((32, 64), (64, 16))
    assert hlo_cost.analyze_fn(lambda x, y: x @ y, a, b).flops \
        == 2 * 32 * 64 * 16
    a, b = fake((5, 32, 64), (5, 64, 16))
    assert hlo_cost.analyze_fn(torch.bmm, a, b).flops \
        == 5 * 2 * 32 * 64 * 16


def test_bytes_rules():
    d = 256
    (x,) = fake((d, d))
    rep = hlo_cost.analyze_fn(lambda t: t @ t + 1.0, x)
    # the product reads x once and writes d*d; the add reads and writes
    assert rep.bytes_accessed == d * d * 4 * (2 + 2)
    view = hlo_cost.analyze_fn(lambda t: t.view(-1).narrow(0, 0, 10), x)
    assert view.bytes_accessed == 0
    table, idx = fake((10_000, 64), (7,),
                      dtypes=(torch.float32, torch.int64))
    rows = hlo_cost.analyze_fn(lambda t, i: t[i], table, idx)
    assert rows.bytes_accessed == 2 * 7 * 64 * 4       # not the table


def _lm(arch, n_layers=None):
    cfg = reduced_config(get_arch(arch))
    return cfg if n_layers is None else dataclasses.replace(
        cfg, n_layers=n_layers)


def _forward_flops(cfg, b=2, s=64):
    mode = input_specs.fake_mode()
    with mode:
        p = PT.init_params(cfg, device="cpu")
        t = torch.empty((b, s), dtype=torch.int32)
    with input_specs.plain_math():
        return hlo_cost.analyze_fn(lambda pp, tt: PT.forward(pp, tt, cfg),
                                   p, t).flops


def _grad_flops(cfg, b=2, s=64):
    mode = input_specs.fake_mode()
    with mode:
        p = PT.init_params(cfg, device="cpu")
        t = torch.empty((b, s), dtype=torch.int32)

    def grads(pp, tt):
        model = ParamTree(pp)
        loss, _ = PT.lm_loss(model.tree(), {"tokens": tt, "labels": tt}, cfg)
        return torch.autograd.grad(loss, list(model.parameters()))

    with input_specs.plain_math():
        return hlo_cost.analyze_fn(grads, p, t).flops


@pytest.mark.parametrize("arch", ["gemma3-1b", "moonshot-v1-16b-a3b"])
def test_layers_count_n_times_one_plus_head(arch):
    """F(n) = head + n * layer: F(4) - F(2) = 2 (F(2) - F(1)), and
    F(1) - layer is the head's 2 * T * d * V (the embedding gathers)."""
    b, s = 2, 64
    f = {n: _forward_flops(_lm(arch, n), b, s) for n in (1, 2, 4)}
    layer = f[2] - f[1]
    assert layer > 0
    assert f[4] - f[2] == 2 * layer
    cfg = _lm(arch)
    assert f[1] - layer == 2 * b * s * cfg.d_model * cfg.vocab
    g = {n: _grad_flops(_lm(arch, n), b, s) for n in (1, 2)}
    assert _grad_flops(_lm(arch, 3), b, s) - g[2] == g[2] - g[1]


def _ref_flops(arch, grad, b=2, s=64):
    cfg = ref_reduced(ref_get_arch(arch))
    params = jax.eval_shape(
        lambda: RT.init_params(jax.random.PRNGKey(0), cfg))
    toks = jax.ShapeDtypeStruct((b, s), jnp.int32)
    if grad:
        fn = jax.grad(lambda p, t: RT.lm_loss(
            p, {"tokens": t, "labels": t}, cfg)[0])
    else:
        fn = lambda p, t: RT.forward(p, t, cfg)   # noqa: E731
    hlo = jax.jit(fn).lower(params, toks).compile().as_text()
    return RH.analyze(hlo).flops


@pytest.mark.parametrize("arch", ["gemma3-1b", "moonshot-v1-16b-a3b",
                                  "chatglm3-6b"])
@pytest.mark.parametrize("grad", [False, True])
def test_flops_match_reference_analyze(arch, grad):
    want = _ref_flops(arch, grad)
    got = (_grad_flops if grad else _forward_flops)(_lm(arch))
    assert got == pytest.approx(want, rel=REF_TOL)


def test_collective_in_a_layer_loop_counts_per_layer():
    def loop(n):
        def build(mesh):
            mode = input_specs.fake_mode()
            with mode:
                x = torch.empty((8, 64), dtype=torch.float32)

            def body(xb):
                for _ in range(n):
                    xb = xb + dist.psum(xb, "model")
                return xb

            fn = dist.shard_map(body, mesh=mesh,
                                in_specs=(dist.P(("data", "model")),),
                                out_specs=dist.P(("data", "model")))
            return input_specs.Lowerable(fn, (x,), (), {})
        return dryrun.count_on_mesh((2, 4), ("data", "model"), build)

    one, eight = loop(1), loop(8)
    c1, c8 = one["collectives"], eight["collectives"]
    assert c1["counts"]["all-reduce"] == 1
    assert c8["counts"]["all-reduce"] == 8
    assert c8["bytes"]["all-reduce"] == 8 * c1["bytes"]["all-reduce"] \
        == 8 * 64 * 4
    # the output's block gather once in each
    assert c8["bytes"]["all-gather"] == c1["bytes"]["all-gather"] == 64 * 4
    assert eight["cost"]["flops_per_device"] == 0


def test_report_fields():
    a, b = fake((4, 4), (4, 4))
    rep = hlo_cost.analyze_fn(lambda x, y: x @ y, a, b)
    assert set(rep.collective_bytes) == set(RH.COLLECTIVES)
    assert rep.total_collective_bytes == 0 and rep.while_trips == {}
    assert np.isfinite(rep.bytes_accessed)
