"""The port's dry run (``repro_torch.launch.dryrun``) on fake process
groups, in one process, on the CPU.

* ``run_cell`` on one production-mesh cell per family (gemma3-1b's
  decode_32k, gin-tu's molecule, sasrec's serve_p99) writes the
  reference's JSON keys, with ``temp_bytes`` and ``alias_bytes`` null and
  the H100's roofline terms; a skipped cell says why; the CLI runs a cell
  on both meshes and ``--skip-existing`` skips it after.
* Cells shaped as ``chip_smoke.py``'s phase 7a (one MoE layer through
  the all-to-all on (data 2, model 4)) and 7b (split-K decode on (model
  4)), at test sizes: their collective bytes per rank equal the formulas
  the chip run checks at full size (1,074,003,968 B of all-to-all and
  16,777,728 B of gathers per block call; 33,024 B per layer and step),
  and 7a's equal a real 8-rank gloo run's ``dist.counts`` exactly.
* The ``moe_a2a`` training cell counts the backward's wire (the
  all-to-alls again, the whole inputs' gathers, the held experts' psum
  over data), and a dense cell on 256 ranks reads a useful FLOP fraction
  of ~1/256: the port runs the dense parts whole on every rank.
"""

import dataclasses
import json

import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.launch import dryrun, input_specs
from repro_torch.launch.mesh import run_local
from repro_torch.launch.train import reduced_config
from repro_torch.models import moe
from repro_torch.models.transformer import LMConfig

KEYS = {"arch", "shape", "mesh", "variant", "status", "n_chips", "memory",
        "cost", "collectives", "roofline", "model_flops",
        "useful_flops_fraction", "meta"}


@pytest.mark.parametrize("arch,shape", [("gemma3-1b", "decode_32k"),
                                        ("gin-tu", "molecule"),
                                        ("sasrec", "serve_p99")])
def test_run_cell_writes_the_reference_keys(tmp_path, arch, shape):
    rec = dryrun.run_cell(arch, shape, "single", "baseline", tmp_path,
                          device="cpu")
    assert rec["status"] == "ok"
    assert KEYS <= set(rec)
    on_disk = json.loads((tmp_path / f"{arch}__{shape}__single__baseline"
                          ".json").read_text())
    assert KEYS <= set(on_disk)
    assert rec["n_chips"] == 256
    mem = rec["memory"]
    assert mem["temp_bytes"] is None and mem["alias_bytes"] is None
    assert mem["argument_bytes"] > 0
    assert mem["peak_estimate_bytes"] >= mem["argument_bytes"]
    r = rec["roofline"]
    assert r["compute_s"] == rec["cost"]["flops_per_device"] / 989e12
    assert r["memory_s"] == rec["cost"]["bytes_accessed_per_device"] \
        / 3.35e12
    assert r["step_s_lower_bound"] == max(r["compute_s"], r["memory_s"],
                                          r["collective_s"])
    assert set(rec["collectives"]["bytes"]) == {
        "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
        "collective-permute"}
    assert 0 < rec["useful_flops_fraction"] < 1


def test_skipped_cell_and_cli(tmp_path, capsys):
    rec = dryrun.run_cell("phi4-mini-3.8b", "long_500k", "single",
                          "baseline", tmp_path)
    assert rec["status"] == "skipped" and "sub-quadratic" \
        in rec["skip_reason"]
    argv = ["--arch", "sasrec", "--shape", "retrieval_cand", "--mesh",
            "both", "--outdir", str(tmp_path), "--device", "cpu"]
    assert dryrun.main(argv) == 0
    for mk, n in (("single", 256), ("multi", 512)):
        rec = json.loads((tmp_path / f"sasrec__retrieval_cand__{mk}__"
                          f"baseline.json").read_text())
        assert rec["status"] == "ok" and rec["n_chips"] == n
    assert dryrun.main(argv + ["--skip-existing"]) == 0
    out = capsys.readouterr().out
    assert out.count("[skip-existing]") == 2
    assert "done: 2 cells, 0 failures" in out


def test_dense_cell_shows_the_ports_redundancy():
    """gemma3-1b decode on 256 ranks: every rank runs the whole step, so
    the model's FLOPs are about 1/256 of what all ranks run."""
    one = dryrun.count_on_mesh(
        (1, 1), ("data", "model"),
        lambda mesh: input_specs.build("gemma3-1b", "decode_32k", mesh,
                                       device="cpu"))
    many = dryrun.count_on_mesh(
        (16, 16), ("data", "model"),
        lambda mesh: input_specs.build("gemma3-1b", "decode_32k", mesh,
                                       device="cpu"))
    assert many["cost"]["flops_per_device"] == one["cost"]["flops_per_device"]
    assert many["useful_flops_fraction"] == pytest.approx(
        one["useful_flops_fraction"] / 256)


# ------------------------------------------------- phase 7-shaped cells
MOE = moe.MoEConfig(n_experts=8, top_k=2, d_expert=16, capacity_factor=1.25)
LM = LMConfig(name="moe-tiny", n_layers=1, d_model=32, n_heads=4, n_kv=1,
              d_head=8, d_ff=64, vocab=64, moe=MOE, dtype="float32")
B, S = 4, 64


def a2a_expected(m, t, n_dp, n_model, d, elt):
    """7a's per-rank bytes per block call at the static c_dev: three
    all-to-alls (activations both ways, expert ids) and two gathers (the
    (E,) int32 counts, this rank's token block of the output)."""
    t_loc = t // (n_dp * n_model)
    cap = moe.capacity(t, m)
    c_dev = max(8, int(-(-t_loc * m.top_k * m.capacity_factor
                         // n_model) // 8 * 8 + 8))
    c_dev = max(c_dev, min(t_loc * m.top_k, m.n_experts // n_model * cap))
    return (2 * n_model * c_dev * d * elt + n_model * c_dev * 4,
            m.n_experts * 4 + t_loc * d * elt)


def test_7a_shaped_cell_bytes():
    # full size first: the numbers phase 7a counted on the card
    qwen = get_arch("qwen3-moe-235b-a22b").config
    assert a2a_expected(qwen.moe, 4 * 4096, 2, 4, 4096, 2) \
        == (1_074_003_968, 16_777_728)
    rec = dryrun.count_on_mesh(
        (2, 4), ("data", "model"),
        lambda mesh: input_specs.moe_layer(LM, B, S, mesh, 1.25,
                                           device="cpu"))
    a2a, gathers = a2a_expected(MOE, B * S, 2, 4, 32, 4)
    assert rec["collectives"]["by_op"] == {
        "all_to_all@model": {"calls": 3, "bytes": a2a},
        "all_gather@data+model": {"calls": 2, "bytes": gathers}}
    assert rec["collectives"]["bytes"]["all-to-all"] == a2a


def real_7a_ranks(rank, world):
    from repro_torch import dist
    mesh = dist.make_mesh((2, 4), ("data", "model"))
    m = dataclasses.replace(MOE, moe_impl="a2a")
    p = moe.expert_block(moe.init_moe(torch.Generator().manual_seed(0), 32,
                                      m, torch.float32), mesh)
    x = torch.randn((B, S, 32), generator=torch.Generator().manual_seed(1))
    dist.set_mesh(mesh)
    try:
        dist.reset_counts()
        moe.moe_block(p, x, m)
        return dict(dist.counts)
    finally:
        dist.set_mesh(None)


def test_7a_shaped_cell_equals_a_real_run():
    rec = dryrun.count_on_mesh(
        (2, 4), ("data", "model"),
        lambda mesh: input_specs.moe_layer(LM, B, S, mesh, 1.25,
                                           device="cpu"))
    for sent in run_local(real_7a_ranks, 8, "gloo"):
        assert sent == rec["collectives"]["by_op"]


def test_7b_shaped_cell_bytes():
    cfg = dataclasses.replace(reduced_config(get_arch("gemma3-1b")),
                              decode_attn="splitk")
    batch = 8
    rec = dryrun.count_on_mesh(
        (4,), ("model",),
        lambda mesh: input_specs.build_cell(
            "lm_decode", cfg, {"batch": batch, "seq": 64}, mesh,
            "decode_splitk", device="cpu"))
    per_layer = batch * cfg.n_heads * (cfg.d_head + 2) * 4
    # gemma3-1b at full size: 8 x 4 x 258 x 4
    assert 8 * 4 * (256 + 2) * 4 == 33_024
    by_op = rec["collectives"]["by_op"]
    assert by_op == {
        "pmax@model": {"calls": cfg.n_layers,
                       "bytes": cfg.n_layers * batch * cfg.n_heads * 4},
        "psum@model": {"calls": 2 * cfg.n_layers,
                       "bytes": cfg.n_layers * batch * cfg.n_heads
                       * (cfg.d_head + 1) * 4}}
    assert rec["collectives"]["total_bytes"] == cfg.n_layers * per_layer


def test_moe_a2a_training_cell_counts_the_backward():
    cfg = dataclasses.replace(reduced_config(get_arch("moonshot-v1-16b-a3b")),
                              n_layers=2)
    rec = dryrun.count_on_mesh(
        (2, 4), ("data", "model"),
        lambda mesh: input_specs.build_cell(
            "lm_train", cfg, {"batch": 2, "seq": 32}, mesh, "moe_a2a",
            device="cpu"))
    by_op = rec["collectives"]["by_op"]
    # remat per layer: each layer's forward runs twice
    assert by_op["all_to_all@model"]["calls"] == 2 * 3 * cfg.n_layers
    assert by_op["all_to_all.bwd@model"]["calls"] == 2 * cfg.n_layers
    assert by_op["all_gather.bwd@data+model"]["calls"] == 2 * cfg.n_layers
    assert by_op["psum.bwd@data"]["calls"] == 3 * cfg.n_layers
    assert rec["cost"]["flops_per_device"] > 0
