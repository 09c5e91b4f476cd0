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
