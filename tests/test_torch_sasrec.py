"""The port's SASRec (``repro_torch.models.sasrec``) == the reference's
(``repro.models.sasrec``) at ``launch.train.reduced_config`` (fp32), with
the reference's JAX-initialised parameters carried across by
``params_from_jax``: ``encode``, ``score_catalog`` and
``score_candidates`` at 1e-5, with the item lookups on the embedding_bag
path (the default; on CPU tensors its plain version) and on direct
indexing (``set_use_kernel(False)``), which agree bit for bit.
Histories hold pads (item 0) so that the padded-key mask acts."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.launch.train import reduced_config as ref_reduced
from repro.models import sasrec as R
from repro_torch.configs import get_arch
from repro_torch.launch.train import reduced_config
from repro_torch.models import sasrec as P

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def model():
    rcfg = ref_reduced(ref_get_arch("sasrec"))
    pcfg = reduced_config(get_arch("sasrec"))
    assert dataclasses.asdict(rcfg) == dataclasses.asdict(pcfg)
    assert P.table_rows(pcfg) == R.table_rows(rcfg)
    rp = R.init_params(jax.random.PRNGKey(0), rcfg)
    pp = P.params_from_jax(jax.tree_util.tree_map(np.asarray, rp))
    rng = np.random.default_rng(0)
    hist = rng.integers(1, pcfg.n_items + 1, (6, pcfg.seq_len))
    hist[rng.random(hist.shape) < 0.3] = 0          # pads
    hist[0, :5] = 0                                 # a short history
    cands = rng.integers(0, pcfg.n_items + 1, (6, 40))
    return rcfg, pcfg, rp, pp, hist, cands


@pytest.mark.parametrize("use_kernel", [True, False])
def test_encode_and_scores_match_reference(model, use_kernel):
    rcfg, pcfg, rp, pp, hist, cands = model
    P.set_use_kernel(use_kernel)
    try:
        h = torch.from_numpy(hist)
        c = torch.from_numpy(cands)
        for got, want in (
                (P.encode(pp, h, pcfg), R.encode(rp, jnp.asarray(hist), rcfg)),
                (P.score_catalog(pp, h, pcfg),
                 R.score_catalog(rp, jnp.asarray(hist), rcfg)),
                (P.score_candidates(pp, h, c, pcfg),
                 R.score_candidates(rp, jnp.asarray(hist), jnp.asarray(cands),
                                    rcfg))):
            assert tuple(got.shape) == tuple(want.shape)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    finally:
        P.set_use_kernel(True)


def test_bag_lookups_equal_direct_indexing(model):
    _, pcfg, _, pp, hist, cands = model
    h, c = torch.from_numpy(hist), torch.from_numpy(cands)
    on = (P.encode(pp, h, pcfg), P.score_candidates(pp, h, c, pcfg))
    P.set_use_kernel(False)
    try:
        off = (P.encode(pp, h, pcfg), P.score_candidates(pp, h, c, pcfg))
    finally:
        P.set_use_kernel(True)
    for a, b in zip(on, off):
        assert torch.equal(a, b)
    assert P.init_params(pcfg, seed=0, device="cpu")["item_emb"].shape == \
        pp["item_emb"].shape


def sasrec_batch(pcfg, seed=1):
    from repro_torch.data import synth
    b = synth.sasrec_batch(np.random.default_rng(seed), pcfg.n_items, 5,
                           pcfg.seq_len)
    b["pos"][0, :4] = 0                           # pad targets are masked
    b["hist"][1, :3] = 0
    return b


def test_bce_loss_value_and_grads_match_reference(model):
    """bce_loss and every parameter's gradient against
    jax.value_and_grad (loss 1e-5, gradients 1e-4 of each tensor's
    scale)."""
    from repro_torch.models.layers import ParamTree, flatten_tree
    rcfg, pcfg, rp, pp, _, _ = model
    b = sasrec_batch(pcfg)
    (lr, _), gr = jax.value_and_grad(
        lambda p: R.bce_loss(p, {k: jnp.asarray(v) for k, v in b.items()},
                             rcfg), has_aux=True)(rp)
    m = ParamTree(P.params_from_jax(jax.tree_util.tree_map(np.asarray, rp)))
    loss, metrics = P.bce_loss(m.tree(), {k: torch.from_numpy(v)
                                          for k, v in b.items()}, pcfg)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(lr), rtol=1e-5)
    assert metrics["loss"] is loss
    want = flatten_tree(jax.tree_util.tree_map(np.asarray, gr))
    got = dict(m.named_parameters())
    assert sorted(got) == sorted(want)
    for k, p in got.items():
        scale = max(1e-2, float(np.abs(want[k]).max()))
        np.testing.assert_allclose(p.grad.numpy(), want[k], rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=k)


def test_bce_loss_backward_with_the_kernel_seam_on(model, monkeypatch):
    """The bag wrapper refuses a table that requires grad (as the CUDA
    wrapper does): with the seam on, bce_loss must index directly while
    autograd records, with the seam-off gradients, and go through the bag
    (three lookups) under no_grad, with the seam-off loss bit for bit."""
    from repro_torch.models.layers import ParamTree
    _, pcfg, _, pp, _, _ = model
    calls = []
    bag = P.eb_ops.embedding_bag

    def refusing(table, idx, *a, **kw):
        if table.requires_grad:
            raise ValueError("embedding_bag has no backward")
        calls.append(idx.shape)
        return bag(table, idx, *a, **kw)

    monkeypatch.setattr(P.eb_ops, "embedding_bag", refusing)
    b = {k: torch.from_numpy(v) for k, v in sasrec_batch(pcfg, 2).items()}
    grads, nograd = {}, {}
    for seam in (True, False):
        P.set_use_kernel(seam)
        try:
            m = ParamTree({k: v.clone() for k, v in pp.items()
                           if k != "blocks"} | {"blocks": [
                               {k: v.clone() for k, v in blk.items()}
                               for blk in pp["blocks"]]})
            loss, _ = P.bce_loss(m.tree(), b, pcfg)
            loss.backward()
            grads[seam] = {k: p.grad for k, p in m.named_parameters()}
            n = len(calls)
            with torch.no_grad():
                nograd[seam], _ = P.bce_loss(m.tree(), b, pcfg)
            assert len(calls) - n == (3 if seam else 0)
        finally:
            P.set_use_kernel(True)
    assert torch.equal(nograd[True], nograd[False])
    for k, g in grads[True].items():
        assert torch.equal(g, grads[False][k]), k
