"""The port's snapshot pipeline (``repro_torch.data.pipeline``) over the
port's Weaver == the reference's over the reference Weaver: the same op
stream (the example's store and writer) gives identical batches with
dst-sorted edges at every step; then 5 AdamW steps of the example's GIN,
from the reference's JAX-initialised parameters, give matching losses.

Features and labels come from Python's salted ``hash(vid)`` in both
packages, so the comparison holds inside one process, which is where it
runs."""

import dataclasses

import jax
import numpy as np

from repro.configs import get_arch as ref_get_arch
from repro.core import Weaver as RefWeaver, WeaverConfig as RefConfig
from repro.data.pipeline import DynamicGraphPipeline as RefPipeline
from repro.models import gnn as ref_gnn
from repro.optim import AdamWConfig as RefAdamWConfig, adamw as ref_adamw
from repro.optim import make_train_step as ref_make_train_step
from repro_torch.data.pipeline import DynamicGraphPipeline, batch_to_torch
from repro_torch.examples import train_gnn_dynamic as ex
from repro_torch.models import gnn


def ref_stream():
    """The reference example's store, writer and pipeline."""
    w = RefWeaver(RefConfig(n_gatekeepers=2, n_shards=3, seed=3))
    tx = w.begin_tx()
    for i in range(24):
        tx.create_vertex(f"v{i}")
    rng = np.random.default_rng(0)
    for _ in range(60):
        a, b = rng.integers(0, 24, 2)
        if a != b:
            tx.create_edge(f"v{a}", f"v{b}")
    assert w.run_tx(tx).ok
    pipe = RefPipeline(w, d_feat=8, n_classes=3, pad_nodes=64,
                       pad_edges=256)
    return pipe.batches(mutate_between=ex.make_writer())


def test_batches_identical_and_dst_sorted():
    a, b = ref_stream(), ex.batches("cpu")
    for _ in range(6):
        x, y = next(a), next(b)
        assert x.keys() == y.keys()
        for k in x:
            if isinstance(x[k], np.ndarray):
                assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
        assert np.all(np.diff(y["edge_dst"]) >= 0)
        t = batch_to_torch(y, "cpu")
        assert t["n_graphs"] == 1 and t["x"].shape == (64, 8)


def test_snapshot_batch_fields_match():
    port = DynamicGraphPipeline(ex.build_store("cpu"), d_feat=4,
                                n_classes=2, pad_nodes=40, pad_edges=128)
    sb = port.snapshot_batch()
    assert sb.n_real_nodes == 24 and sb.n_graphs == 1
    assert int(sb.label_mask.sum()) == 24
    assert np.all(np.diff(sb.edge_dst) >= 0)
    assert (sb.edge_dst[-1], sb.edge_src[-1]) == (39, 39)   # pad sentinel
    assert port.snapshot_stats()


def test_five_training_steps_match_reference():
    cfg = ex.config()
    ref_cfg = dataclasses.replace(ref_get_arch("gin-tu").config, n_layers=2,
                                  d_hidden=16, d_feat=8, n_classes=3)
    params = ref_gnn.init_params(jax.random.PRNGKey(0), ref_cfg)
    model = gnn.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), cfg)
    step = ref_make_train_step(lambda p, b: ref_gnn.gnn_loss(p, b, ref_cfg),
                               RefAdamWConfig(lr=1e-2, warmup_steps=2,
                                              total_steps=30))
    opt = ref_adamw.init(params)
    want = []
    stream = ref_stream()
    for _ in range(5):
        b = next(stream)
        params, opt, m = step(params, opt, b)
        want.append(float(m["loss"]))
    got = ex.train("cpu", steps=5, model=model, log_every=0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_chip_smoke_gnn_phase_rehearses_on_cpu():
    """chip_smoke's phase 3b (gin-tu at its published width on a live
    snapshot, a writer between batches, kernel path held against fp64,
    card run against a CPU twin) runs end to end with both runs on the
    CPU, at a small deployment."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    *_, w = chip_smoke.run_on("cpu", 0, 300, True, 1, 10)
    r = chip_smoke.phase_gnn(w, 0, 2, device="cpu")
    assert len(r["losses"]) == 2
    assert r["errors"][2] <= chip_smoke.GNN_GRAD_TOL
    assert r["errors"][3] <= chip_smoke.GNN_STEP_TOL
