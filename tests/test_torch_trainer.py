"""The port's training substrate == the reference's: the multi-version
checkpoint store (``repro_torch.checkpoint``), the fault-tolerant
``Trainer`` and ``HeartbeatMonitor`` (``repro_torch.runtime``) and int8
gradient compression (``repro_torch.optim.compress``).

The reference's own cases (``tests/test_substrates.py``:
``TestMVCheckpoint``, ``TestTrainerFaultTolerance``,
``TestGradCompression``) run on the port as one parametrised test; the
int8 quantizer's q, scale and residuals equal the reference's bit for
bit (half-way values included); a checkpoint written by either package
restores in the other, with identical leaf file names; a run resumed
after a failure repeats the uninterrupted run's losses; and
``launch.train.main --device cpu`` trains one architecture of each
family and resumes, as does ``examples.train_lm``."""

import contextlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import MVCheckpointStore as RefStore
from repro.configs import get_arch as ref_get_arch
from repro.launch.train import reduced_config as ref_reduced
from repro.models import sasrec as RS
from repro.models import transformer as RT
from repro.optim import adamw as ref_adamw
from repro.optim import compress as ref_compress
from repro_torch.checkpoint import MVCheckpointStore
from repro_torch.configs import get_arch
from repro_torch.core.clock import Order, compare
from repro_torch.data import synth
from repro_torch.examples import train_lm
from repro_torch.launch import train
from repro_torch.launch.train import reduced_config
from repro_torch.models import sasrec, transformer
from repro_torch.models.layers import ParamTree, flatten_tree
from repro_torch.optim import AdamWConfig, compress
from repro_torch.runtime import HeartbeatMonitor, Trainer, TrainerConfig


# ------------------------------------------- the reference's cases, ported
def quad_loss(model, batch):
    err = model.w @ batch["x"] - batch["y"]
    loss = torch.mean(torch.square(err))
    return loss, {"loss": loss}


def quad_model(rng):
    return ParamTree({"w": torch.from_numpy(
        rng.normal(size=(4, 4)).astype(np.float32))})


def make_batch(rng, d=4):
    x = rng.normal(size=(d, 8)).astype(np.float32)
    w_true = rng.normal(size=(d, d)).astype(np.float32)
    return {"x": x, "y": w_true @ x}


def repeat(batch):
    while True:
        yield batch


def int8_roundtrip_with_error_feedback(tmp_path):
    rng = np.random.default_rng(0)
    g = {"a": torch.from_numpy(rng.normal(size=(256,)).astype(np.float32))}
    ef = compress.init_error_feedback(g)
    total_sent = torch.zeros(256)
    total_true = torch.zeros(256)
    for _ in range(20):
        q, ef = compress.compress_grads(g, ef)
        total_sent += compress.decompress_grads(q)["a"]
        total_true += g["a"]
    # error feedback: accumulated quantized sum tracks the true sum
    np.testing.assert_allclose(total_sent.numpy(), total_true.numpy(),
                               rtol=0.02, atol=0.05)


def save_restore_roundtrip(tmp_path):
    store = MVCheckpointStore(str(tmp_path), n_writers=2, writer_id=0)
    params = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
              "b": {"x": torch.ones((4,), dtype=torch.bfloat16)}}
    store.save(params, step=5)
    got, info = store.restore(params)
    assert info.step == 5
    assert torch.equal(got["w"], params["w"])
    assert got["b"]["x"].dtype == torch.bfloat16


def latest_orders_by_stamp(tmp_path):
    store = MVCheckpointStore(str(tmp_path), n_writers=1)
    store.save({"w": torch.zeros((2,))}, step=1)
    store.save({"w": torch.ones((2,))}, step=2)
    assert store.latest().step == 2


def concurrent_writers_refined_consistently(tmp_path):
    """Two writers with concurrent stamps: the oracle decision is
    monotonic — latest() returns the same winner every time."""
    a = MVCheckpointStore(str(tmp_path), n_writers=2, writer_id=0)
    b = MVCheckpointStore(str(tmp_path), n_writers=2, writer_id=1)
    a.save({"w": torch.zeros((2,))}, step=10)
    b.save({"w": torch.ones((2,))}, step=11)
    reader = MVCheckpointStore(str(tmp_path), n_writers=2)
    first = reader.latest().path
    for _ in range(5):
        assert reader.latest().path == first


def epoch_bump_orders_after(tmp_path):
    store = MVCheckpointStore(str(tmp_path), n_writers=1)
    s1 = store.save({"w": torch.zeros((2,))}, step=50)
    store.bump_epoch()
    s2 = store.save({"w": torch.ones((2,))}, step=10)   # lower step!
    assert compare(s1, s2) is Order.BEFORE
    assert store.latest().step == 10                    # stamp wins


def gc_keeps_newest(tmp_path):
    store = MVCheckpointStore(str(tmp_path), n_writers=1, keep=2)
    for i in range(5):
        store.save({"w": torch.full((2,), float(i))}, step=i)
    assert len(store.list_checkpoints()) == 2
    assert store.latest().step == 4


def torn_checkpoint_ignored(tmp_path):
    store = MVCheckpointStore(str(tmp_path), n_writers=1)
    store.save({"w": torch.zeros((2,))}, step=1)
    os.makedirs(tmp_path / "v_e0_99", exist_ok=True)  # no MANIFEST
    assert store.latest().step == 1


def checkpoint_restart_resumes(tmp_path):
    rng = np.random.default_rng(0)
    model = quad_model(rng)
    w0 = model.w.detach().clone()
    batch = make_batch(rng)
    cfg = TrainerConfig(total_steps=30, ckpt_every=10,
                        ckpt_dir=str(tmp_path), log_every=1000)
    opt = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=30)
    t1 = Trainer(quad_loss, model, opt, cfg)
    t1.fit(repeat(batch), until=20)
    assert t1.step == 20
    # simulated crash: brand-new trainer resumes from stamp
    t2 = Trainer(quad_loss, ParamTree({"w": w0}), opt, cfg)
    assert t2.try_resume()
    assert t2.step == 20
    assert torch.equal(t2.model.w, t1.model.w)
    for k in t1.opt_state.mu:
        assert torch.equal(t2.opt_state.mu[k], t1.opt_state.mu[k])
        assert torch.equal(t2.opt_state.nu[k], t1.opt_state.nu[k])
    t2.fit(repeat(batch))
    assert t2.step == 30


def failure_bumps_epoch(tmp_path):
    rng = np.random.default_rng(0)
    model = quad_model(rng)
    batch = make_batch(rng)
    cfg = TrainerConfig(total_steps=20, ckpt_every=5,
                        ckpt_dir=str(tmp_path), log_every=1000)
    t = Trainer(quad_loss, model,
                AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=20), cfg)
    t.fit(repeat(batch), until=10)
    t.on_failure()
    assert t.store.epoch == 1
    assert t.step == 10
    t.fit(repeat(batch))
    assert t.store.latest().stamp.epoch == 1


def straggler_detection(tmp_path):
    m = HeartbeatMonitor(n_workers=3, factor=3.0)
    now = 0.0
    for step in range(8):
        for w in range(3):
            if not (w == 2 and step >= 4):
                m.beat(w, now + 0.01 * w)
        now += 1.0
    assert 2 in m.check(now)


CASES = {f.__name__: f for f in (
    int8_roundtrip_with_error_feedback, save_restore_roundtrip,
    latest_orders_by_stamp, concurrent_writers_refined_consistently,
    epoch_bump_orders_after, gc_keeps_newest, torn_checkpoint_ignored,
    checkpoint_restart_resumes, failure_bumps_epoch, straggler_detection)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_substrate_case(case, tmp_path):
    CASES[case](tmp_path)


# ------------------------------------------------ against the reference
def at(tree, path):
    for p in path:
        tree = tree[p.key]
    return tree


def test_int8_compression_matches_reference_bit_for_bit():
    rng = np.random.default_rng(1)
    grads = {"a": rng.normal(size=(300,)).astype(np.float32),
             "b": {"c": (rng.normal(size=(7, 5)) * 1e-3).astype(np.float32)},
             # max 127 -> scale 1: half-way values round to even
             "h": np.asarray([127, 63.5, 0.5, 1.5, -2.5, -0.5, 2.5],
                             np.float32)}
    jg = jax.tree_util.tree_map(jnp.asarray, grads)
    tg = jax.tree_util.tree_map(torch.from_numpy, grads)
    ref_ef = ref_compress.init_error_feedback(jg)
    ef = compress.init_error_feedback(tg)
    for _ in range(3):
        rq, ref_ef = ref_compress.compress_grads(jg, ref_ef)
        q, ef = compress.compress_grads(tg, ef)
        pairs = jax.tree_util.tree_leaves_with_path(
            rq, is_leaf=lambda x: isinstance(x, tuple))
        assert len(pairs) == 3
        for path, (want_q, want_s) in pairs:
            got_q, got_s = at(q, path)
            assert got_q.dtype == torch.int8
            np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
            assert got_s.item() == float(want_s)
            np.testing.assert_array_equal(at(ef.residual, path).numpy(),
                                          np.asarray(at(ref_ef.residual,
                                                        path)))
    hq, _ = compress.quantize_int8(torch.from_numpy(grads["h"]))
    assert hq.tolist() == [127, 64, 0, 2, -2, 0, 2]


def ref_state(arch_id, dtype, seed):
    """A reference {"params", "opt"} state with non-trivial moments."""
    import dataclasses
    cfg = dataclasses.replace(ref_reduced(ref_get_arch(arch_id)),
                              dtype=dtype)
    mod = RS if arch_id == "sasrec" else RT
    params = mod.init_params(jax.random.PRNGKey(seed), cfg)
    opt = ref_adamw.init(params)
    rng = np.random.default_rng(seed)
    rand = lambda x: jnp.asarray(                       # noqa: E731
        rng.normal(size=x.shape).astype(np.float32))
    opt = ref_adamw.AdamWState(step=jnp.asarray(7, jnp.int32),
                               mu=jax.tree_util.tree_map(rand, opt.mu),
                               nu=jax.tree_util.tree_map(rand, opt.nu))
    return {"params": params, "opt": opt}


def port_trainer(arch_id, dtype, tmp_path):
    import dataclasses
    cfg = dataclasses.replace(reduced_config(get_arch(arch_id)), dtype=dtype)
    mod = sasrec if arch_id == "sasrec" else transformer
    loss = sasrec.bce_loss if arch_id == "sasrec" else transformer.lm_loss
    model = ParamTree(mod.init_params(cfg, seed=9, device="cpu"))
    return Trainer(lambda m, b: loss(m.tree(), b, cfg), model,
                   AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10),
                   TrainerConfig(total_steps=10, ckpt_every=1,
                                 ckpt_dir=str(tmp_path), log_every=1000)), cfg


def leaf_files(path):
    return sorted(f for f in os.listdir(path) if f.endswith(".npy"))


@pytest.mark.parametrize("arch_id,dtype", [
    ("moonshot-v1-16b-a3b", "float32"), ("sasrec", "float32"),
    ("gemma3-1b", "bfloat16")])
def test_checkpoints_cross_between_packages(arch_id, dtype, tmp_path):
    # the reference writes, the port's Trainer resumes
    state = ref_state(arch_id, dtype, 3)
    RefStore(str(tmp_path / "ref")).save(state, step=7)
    t, cfg = port_trainer(arch_id, dtype, tmp_path / "ref")
    assert t.try_resume() and t.step == 7
    want = {f"params.{k}": v for k, v in flatten_tree(
        jax.tree_util.tree_map(np.asarray, state["params"])).items()}
    for part in ("mu", "nu"):
        want.update({f"{part}.{k}": v for k, v in flatten_tree(
            jax.tree_util.tree_map(np.asarray,
                                   getattr(state["opt"], part))).items()})
    got = {f"params.{k}": p for k, p in t.model.named_parameters()}
    got.update({f"mu.{k}": v for k, v in t.opt_state.mu.items()})
    got.update({f"nu.{k}": v for k, v in t.opt_state.nu.items()})
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert v.dtype == (torch.float32 if not k.startswith("params")
                           else getattr(torch, dtype)), k
        np.testing.assert_array_equal(v.detach().float().numpy(),
                                      np.asarray(want[k], np.float32),
                                      err_msg=k)
    assert int(t.opt_state.step) == 7

    # the port trains a step and writes; the reference restores
    if arch_id == "sasrec":
        b = synth.sasrec_batch(np.random.default_rng(0), cfg.n_items, 2,
                               cfg.seq_len)
    else:
        b = synth.lm_batch(np.random.default_rng(0), cfg.vocab, 2, 8)
    t.fit(repeat(b), until=8)
    port_dir = t.store.latest().path
    ref_dir = os.path.join(tmp_path / "ref", os.listdir(tmp_path / "ref")[0])
    assert leaf_files(port_dir) == leaf_files(ref_dir)
    with open(os.path.join(port_dir, "MANIFEST.json")) as f:
        port_leaves = json.load(f)["leaves"]
    with open(os.path.join(ref_dir, "MANIFEST.json")) as f:
        assert json.load(f)["leaves"] == port_leaves
    back, info = RefStore(str(tmp_path / "ref")).restore(state)
    assert info.step == 8 and int(back["opt"].step) == 8
    got = {f"params.{k}": np.asarray(v, np.float32) for k, v in flatten_tree(
        back["params"]).items()}
    for k, p in t.model.named_parameters():
        np.testing.assert_array_equal(got[f"params.{k}"],
                                      p.detach().float().numpy(), err_msg=k)
    mu = flatten_tree(back["opt"].mu)
    for k, v in t.opt_state.mu.items():
        np.testing.assert_array_equal(np.asarray(mu[k]), v.numpy())


def test_resume_after_a_failure_repeats_the_uninterrupted_losses(tmp_path):
    """Six steps uninterrupted (checkpoints at 3 and 6); the step-6 save
    torn (its manifest gone); on_failure resumes at step 3, and steps 4-6
    on the same batches repeat the uninterrupted losses."""
    cfg = reduced_config(get_arch("gemma3-1b"))
    rng = np.random.default_rng(0)
    batches = [synth.lm_batch(rng, cfg.vocab, 2, 8) for _ in range(6)]
    model = ParamTree(transformer.init_params(cfg, seed=0, device="cpu"))
    t = Trainer(lambda m, b: transformer.lm_loss(m.tree(), b, cfg), model,
                AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=6),
                TrainerConfig(total_steps=6, ckpt_every=3,
                              ckpt_dir=str(tmp_path), log_every=1000))
    t.fit(iter(batches))
    first = [h["loss"] for h in t.history]
    os.remove(os.path.join(t.store.latest().path, "MANIFEST.json"))
    t.on_failure()
    assert t.step == 3 and t.store.epoch == 1
    t.fit(iter(batches[3:]))
    again = [h["loss"] for h in t.history[6:]]
    np.testing.assert_allclose(again, first[3:], rtol=1e-6)
    assert t.store.latest().stamp.epoch == 1 and t.store.latest().step == 6


def run_main(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue()


@pytest.mark.parametrize("arch_id", ["moonshot-v1-16b-a3b", "gin-tu",
                                     "sasrec"])
def test_launch_train_main_on_the_cpu(arch_id, tmp_path):
    argv = ["--arch", arch_id, "--device", "cpu", "--ckpt-every", "2",
            "--ckpt-dir", str(tmp_path), "--steps"]
    rc, out = run_main(train.main, argv + ["4"])
    assert rc == 0, out
    last = out.strip().splitlines()[-1]
    assert last.startswith("final loss ") and last.endswith("after 4 steps")
    assert np.isfinite(float(last.split()[2]))
    rc, out = run_main(train.main, argv + ["6", "--resume"])
    assert rc == 0 and "resumed at step 4" in out, out
    assert out.strip().endswith("after 6 steps")


def test_example_train_lm_on_the_cpu(tmp_path):
    rc, out = run_main(train_lm.main, ["--device", "cpu", "--steps", "40",
                                       "--ckpt-dir", str(tmp_path)])
    assert rc == 0, out
    assert "simulating failure at step 20" in out
    assert "(epoch after failure: 1)" in out
