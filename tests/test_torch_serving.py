"""The port's serving loops (``repro_torch.runtime.server``) == the
reference's (``repro.runtime.server``) from the same weights, on the
CPU: ``LMServer`` greedy tokens (prefill then decode) for two dense
architectures at ``reduced_config``, ``RecServer`` top-k items and
candidate scores for SASRec; and the serving launcher
``python -m repro_torch.launch.serve --mode lm|rec --device cpu``, and
chip_smoke's serving phases rehearsed on the CPU."""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.launch.train import reduced_config as ref_reduced
from repro.models import sasrec as RS
from repro.models import transformer as RT
from repro.runtime import server as R
from repro_torch.configs import get_arch
from repro_torch.launch import serve
from repro_torch.launch.train import reduced_config
from repro_torch.models import sasrec as PS
from repro_torch.models import transformer as PT
from repro_torch.runtime import server as P


@pytest.mark.parametrize("arch_id", ["gemma3-1b", "chatglm3-6b"])
def test_lm_server_tokens_match_reference(arch_id):
    rcfg = ref_reduced(ref_get_arch(arch_id))
    pcfg = reduced_config(get_arch(arch_id))
    rp = RT.init_params(jax.random.PRNGKey(0), rcfg)
    pp = PT.params_from_jax(jax.tree_util.tree_map(np.asarray, rp))
    prompts = np.random.default_rng(0).integers(0, pcfg.vocab, (4, 12))
    ref = R.LMServer(rp, rcfg, batch=4, max_len=24)
    port = P.LMServer(pp, pcfg, batch=4, max_len=24, device="cpu")
    first = port.prefill_batch(prompts)
    np.testing.assert_array_equal(first, ref.prefill_batch(prompts))
    np.testing.assert_array_equal(port.decode(first, steps=8),
                                  ref.decode(first, steps=8))
    assert port.cache["len"].tolist() == [20] * 4


def test_rec_server_matches_reference():
    rcfg = ref_reduced(ref_get_arch("sasrec"))
    pcfg = reduced_config(get_arch("sasrec"))
    rp = RS.init_params(jax.random.PRNGKey(0), rcfg)
    pp = PS.params_from_jax(jax.tree_util.tree_map(np.asarray, rp))
    rng = np.random.default_rng(1)
    hist = rng.integers(1, pcfg.n_items + 1, (8, pcfg.seq_len))
    cands = rng.integers(1, pcfg.n_items + 1, (8, 30))
    ref, port = R.RecServer(rp, rcfg), P.RecServer(pp, pcfg, device="cpu")
    np.testing.assert_array_equal(port.top_k(hist, k=10),
                                  ref.top_k(hist, k=10))
    np.testing.assert_allclose(port.score(hist, cands),
                               ref.score(hist, cands), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["lm", "rec"])
def test_serve_launcher(mode, capsys):
    assert serve.main(["--mode", mode, "--device", "cpu"]) == 0
    assert "on cpu" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            serve.main(["--mode", mode])


def test_chip_smoke_serving_phases_rehearse_on_cpu():
    """chip_smoke's phases 4 and 5 on the CPU at reduced configs (bf16 LM
    with a window shorter than the prompt): the kernel path and its plain
    twin agree, and no kernel launches off the card."""
    import dataclasses
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    cfg = dataclasses.replace(reduced_config(get_arch("gemma3-1b")),
                              dtype="bfloat16", window_pattern=(8, 0))
    lm = chip_smoke.phase_lm(0, 2, 24, 4, device="cpu", cfg=cfg)
    assert lm["launches"] == 0 and len(lm["errors"]) == 5
    assert max(lm["errors"]) <= chip_smoke.LM_LOGIT_TOL
    rec = chip_smoke.phase_rec(0, 16, 300, device="cpu",
                               cfg=reduced_config(get_arch("sasrec")))
    assert rec["launches"] == 0 and rec["score_err"] == 0.0


@pytest.mark.parametrize("where", ["hist", "candidates"])
@pytest.mark.parametrize("bad", ["negative", "past_table"])
def test_rec_server_bad_item_id_raises_and_server_answers_on(where, bad):
    """An item id outside [0, table rows) raises IndexError before any
    upload (numpy array or CPU tensor), and the same server then answers
    the next good call as the reference does."""
    rcfg = ref_reduced(ref_get_arch("sasrec"))
    pcfg = reduced_config(get_arch("sasrec"))
    rp = RS.init_params(jax.random.PRNGKey(0), rcfg)
    pp = PS.params_from_jax(jax.tree_util.tree_map(np.asarray, rp))
    rng = np.random.default_rng(2)
    hist = rng.integers(1, pcfg.n_items + 1, (4, pcfg.seq_len))
    cands = rng.integers(1, pcfg.n_items + 1, (4, 20))
    ref, port = R.RecServer(rp, rcfg), P.RecServer(pp, pcfg, device="cpu")
    rows = pp["item_emb"].shape[0]
    wrong = -1 if bad == "negative" else rows
    h_bad, c_bad = hist.copy(), cands.copy()
    (h_bad if where == "hist" else c_bad)[1, 3] = wrong
    with pytest.raises(IndexError, match=f"item id {wrong} outside"):
        port.score(h_bad, c_bad)
    with pytest.raises(IndexError, match=str(rows)):
        port.score(torch.from_numpy(h_bad), torch.from_numpy(c_bad))
    if where == "hist":
        with pytest.raises(IndexError):
            port.top_k(h_bad, k=5)
    np.testing.assert_array_equal(port.top_k(hist, k=5),
                                  ref.top_k(hist, k=5))
    np.testing.assert_allclose(port.score(hist, cands),
                               ref.score(hist, cands), rtol=1e-5, atol=1e-5)
