"""The port's attention wrapper (``repro_torch.kernels.flash_attention``)
on CPU tensors, i.e. its plain version, against the reference's Pallas
kernel in interpret mode at the reference tests' cases and tolerances
(tests/test_kernels.py): 2e-5 fp32, 3e-2 bf16.  Also the GQA wrapper
against the reference model's ``layers.attention``, causal Sq > Sk (rows
with no valid key get the mean of v, as the reference), per-row
``kv_len`` against the Pallas kernel over the truncated keys (decode
alignment), and the constant-v row-sum property."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as ref_ops
from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.models.layers import attention as ref_attention
from repro_torch.kernels.flash_attention import kernel, ops
from repro_torch.kernels.flash_attention.ref import attention_ref

BF16 = "bfloat16"


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a, dtype):
    """numpy -> torch in ``dtype`` (bf16 through fp32, as jnp rounds)."""
    t = torch.from_numpy(np.asarray(a, np.float32))
    return t.to(torch.bfloat16) if dtype == BF16 else t


@pytest.mark.parametrize("bh,sq,sk,d,causal,window,dtype", [
    (2, 128, 128, 64, True, None, "float32"),
    (1, 256, 256, 32, True, None, "float32"),
    (3, 128, 128, 64, False, None, "float32"),
    (2, 128, 128, 64, True, 64, "float32"),
    (2, 128, 256, 64, True, None, "float32"),      # decode-ish sk > sq
    (2, 256, 256, 128, True, None, BF16),
    (2, 128, 64, 64, True, None, "float32"),       # sq > sk: masked rows
    (1, 192, 64, 32, True, 32, BF16),
])
def test_plain_version_matches_pallas(bh, sq, sk, d, causal, window, dtype):
    rng = np.random.default_rng(sq + sk + d)
    q, k, v = (rng.normal(size=(bh, s, d)).astype(np.float32)
               for s in (sq, sk, sk))
    jd = jnp.bfloat16 if dtype == BF16 else jnp.float32
    want = flash_attention_pallas(jnp.asarray(q, jd), jnp.asarray(k, jd),
                                  jnp.asarray(v, jd), causal=causal,
                                  window=window, block_q=64, block_k=64)
    got = attention_ref(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                        causal=causal, window=window)
    tol = 3e-2 if dtype == BF16 else 2e-5
    assert got.dtype == (torch.bfloat16 if dtype == BF16 else torch.float32)
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=tol,
                               atol=tol)
    # the same rows q_chunk at a time (how chip_smoke fits 32k)
    chunked = attention_ref(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                            causal=causal, window=window, q_chunk=48)
    assert torch.equal(chunked, got)


def test_fully_masked_rows_average_v():
    """Causal with Sq > Sk: rows at q_pos < 0 see no key and average v
    over every key (the -1e30 mask, not -inf), in the reference too."""
    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(size=(1, s, 16)).astype(np.float32)
               for s in (128, 64, 64))
    got = attention_ref(_t(q, "f"), _t(k, "f"), _t(v, "f"), causal=True)
    np.testing.assert_allclose(got[0, :64].numpy(),
                               np.broadcast_to(v[0].mean(0), (64, 16)),
                               rtol=1e-5, atol=1e-6)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True, block_q=64,
                                  block_k=64)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("hq,hkv", [(8, 2), (4, 1), (8, 8)])
def test_gqa_wrapper_matches_model_attention(hq, hkv):
    rng = np.random.default_rng(5)
    b, s, d = 2, 128, 32
    q = rng.normal(size=(b, s, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(s), (b, s))
    want = ref_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         pos, pos, causal=True)
    got = ops.mha(torch.from_numpy(q), torch.from_numpy(k),
                  torch.from_numpy(v), causal=True)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=2e-5, atol=2e-5)
    via_ref = ref_ops.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=True, use_ref=True)
    np.testing.assert_allclose(got.numpy(), _np(via_ref), rtol=2e-5,
                               atol=2e-5)
    assert kernel.launches["flash_attention"] == 0     # CPU: no launch


@pytest.mark.parametrize("window", [None, 64])
def test_kv_len_is_attention_over_the_first_kv_len_keys(window):
    """Row b with kv_len L == the Pallas kernel over keys [0, L): queries
    end-aligned at L - Sq + i, keys past L ignored; kv_len = Sk is the
    kernel's function exactly; past Sk every key stays valid."""
    rng = np.random.default_rng(7)
    b, sq, sk, h, d = 3, 64, 256, 2, 32
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, sk, h, d)).astype(np.float32)
    v = rng.normal(size=(b, sk, h, d)).astype(np.float32)
    lens = np.array([128, 256, 64], np.int32)
    got = ops.mha(torch.from_numpy(q), torch.from_numpy(k),
                  torch.from_numpy(v), causal=True, window=window,
                  kv_len=torch.from_numpy(lens)).numpy()
    for i, n in enumerate(lens):
        want = ref_ops.mha(jnp.asarray(q[i:i + 1]),
                           jnp.asarray(k[i:i + 1, :n]),
                           jnp.asarray(v[i:i + 1, :n]), causal=True,
                           window=window)
        np.testing.assert_allclose(got[i:i + 1], _np(want), rtol=2e-5,
                                   atol=2e-5)
    full = ops.mha(torch.from_numpy(q), torch.from_numpy(k),
                   torch.from_numpy(v), causal=True, window=window)
    same = ops.mha(torch.from_numpy(q), torch.from_numpy(k),
                   torch.from_numpy(v), causal=True, window=window,
                   kv_len=torch.full((b,), sk, dtype=torch.int32))
    assert torch.equal(full, same)
    past = ops.mha(torch.from_numpy(q), torch.from_numpy(k),
                   torch.from_numpy(v), causal=True, window=window,
                   kv_len=torch.full((b,), sk + 5, dtype=torch.int32))
    q_pos = np.arange(sq)[:, None] + sk + 5 - sq
    k_pos = np.arange(sk)[None, :]
    mask = k_pos <= q_pos
    if window is not None:
        mask &= q_pos - k_pos < window
    logits = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(d)
    logits = np.where(mask[None, None], logits, -1e30)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    np.testing.assert_allclose(past.numpy(),
                               np.einsum("bhqk,bkhd->bqhd", p, v),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("sq,sk,d,seed", [(64, 64, 32, 0), (128, 64, 64, 1),
                                          (64, 128, 32, 2)])
def test_constant_v_rows_sum_to_one(sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(1, sq, d)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, sk, d)).astype(np.float32))
    v = torch.full((1, sk, d), 3.5)
    got = attention_ref(q, k, v, causal=False)
    np.testing.assert_allclose(got.numpy(), 3.5, rtol=1e-5)


def test_cpu_tensors_never_launch_and_kernel_refuses_them():
    q = torch.zeros((1, 3, 2, 8))
    k = torch.zeros((1, 5, 1, 8))
    assert ops.mha(q, k, k).shape == (1, 3, 2, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.flash_attention(q, k, k)
    assert kernel.launches["flash_attention"] == 0


@pytest.mark.parametrize("sq,sk,window", [(20, 256, 16), (40, 256, 32)])
def test_rows_whose_window_lies_past_a_full_cache_average_v(sq, sk, window):
    """kv_len = Sk + Sq puts the last rows' windows wholly past the cache:
    those rows see no key and average v over every key, while the first
    rows still see the last keys."""
    rng = np.random.default_rng(sq)
    q = rng.normal(size=(1, sq, 2, 32)).astype(np.float32)
    k, v = (rng.normal(size=(1, sk, 1, 32)).astype(np.float32)
            for _ in range(2))
    got = ops.mha(torch.from_numpy(q), torch.from_numpy(k),
                  torch.from_numpy(v), causal=True, window=window,
                  kv_len=torch.tensor([sk + sq], dtype=torch.int32)).numpy()
    q_pos = np.arange(sq)[:, None] + sk
    k_pos = np.arange(sk)[None, :]
    mask = (k_pos <= q_pos) & (q_pos - k_pos < window)
    blind = ~mask.any(1)
    assert blind.sum() == sq - window + 1 and not blind[0]
    logits = np.einsum("bqhd,bkd->bhqk", q, k[:, :, 0]) / np.sqrt(32)
    logits = np.where(mask[None, None], logits, -1e30)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    np.testing.assert_allclose(got, np.einsum("bhqk,bkd->bqhd", p, v[:, :, 0]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[0, blind],
                               np.broadcast_to(v[0, :, 0].mean(0),
                                               (int(blind.sum()), 2, 32)),
                               rtol=1e-5, atol=1e-6)


def _masked_attention(q, k, v, keep):
    """fp32 attention of q (1, S, Hq, D) over one KV head with an explicit
    (S, Sk) mask: what a kernel with a faulty mask would compute."""
    logits = torch.einsum("bqhd,bkd->bhqk", q.float(),
                          k[:, :, 0].float()) / q.shape[-1] ** 0.5
    logits = torch.where(keep[None, None], logits, -1e30)
    return torch.einsum("bhqk,bkd->bqhd", torch.softmax(logits, -1),
                        v[:, :, 0].float())


@pytest.mark.parametrize("window", [None, 128])
def test_chip_smoke_bf16_check_passes_rounding_and_catches_mask_faults(window):
    """chip_smoke's bf16 check (flash_check) at gemma3-1b's heads: the
    reference's own bf16 rounding passes it; a 64-key tile dropped, the
    own key dropped, or one future key seen, each only for the late rows
    (whose outputs are small), fails it."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    rng = np.random.default_rng(13)
    s, hq, d = 512, 4, 256
    q = torch.from_numpy(rng.normal(size=(1, s, hq, d)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(1, s, 1, d)).astype(np.float32))
            for _ in range(2))
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    ok, _, rel, words = chip_smoke.flash_check(
        ops.mha_ref(q, k, v, causal=True, window=window), q, k, v, True,
        window, None, "plain")
    assert ok, words
    assert rel <= chip_smoke.FLASH_ROW_TOL / 2
    q_pos = torch.arange(s)[:, None]
    k_pos = torch.arange(s)[None, :]
    keep = k_pos <= q_pos
    lo = torch.zeros_like(q_pos)
    if window is not None:
        keep &= q_pos - k_pos < window
        lo = (q_pos - window + 1).clamp(min=0)
    late = q_pos >= s // 2
    first = lo // 64 * 64
    faults = {
        "tile dropped": keep & ~(late & (k_pos >= first) & (k_pos < first + 64)),
        "own key dropped": keep & ~(late & (k_pos == q_pos)),
        "future key seen": keep | (late & (k_pos == q_pos + 1)),
    }
    for name, mask in faults.items():
        got = _masked_attention(q, k, v, mask).to(torch.bfloat16)
        ok, _, rel, words = chip_smoke.flash_check(got, q, k, v, True, window,
                                                   None, "plain")
        assert not ok, f"{name} passed: {words}"


def _chip_smoke():
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


# (bh, sq, sk, d, causal, window, kv_len or None, held to Pallas): every
# kind of chip_smoke.FLASH_CASES on one head: causal, non-causal, window,
# Sq < Sk and Sq > Sk causal (rows with no valid key), a window without
# the causal mask, per-row kv_len with 0 and past a full cache (decode and
# a short prompt), and kv_past (the last rows' windows past the cache)
SPLIT_CASES = [
    (2, 128, 128, 32, True, None, None, True),
    (2, 128, 128, 32, False, None, None, True),
    (2, 128, 128, 32, True, 64, None, True),
    (2, 128, 256, 32, True, None, None, True),
    (2, 128, 64, 32, True, None, None, True),
    (2, 64, 128, 32, False, 30, None, True),
    (3, 1, 96, 32, True, None, (0, 50, 99), False),
    (3, 4, 96, 32, True, 7, (0, 50, 99), False),
    (1, 20, 64, 32, True, 16, (84,), False),
]
_PALLAS = {}


@pytest.mark.parametrize("chunk", [1, 7, 64, None])
@pytest.mark.parametrize("case", range(len(SPLIT_CASES)))
def test_split_twin_matches_pallas_and_reference(case, chunk):
    """The decode variant's algorithm (chunked partials, band-skipped
    chunks left empty, an ordered combine), in fp32 at the reference
    tolerance (2e-5), against attention_ref and, where the reference
    kernel takes the case, the Pallas kernel in interpret mode; chunk
    None is one chunk."""
    from repro_torch.kernels.flash_attention.ref import attention_split_ref
    bh, sq, sk, d, causal, window, lens, pallas = SPLIT_CASES[case]
    rng = np.random.default_rng(case)
    q, k, v = (rng.normal(size=(bh, s, d)).astype(np.float32)
               for s in (sq, sk, sk))
    kv_len = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = attention_split_ref(tq, tk, tv, causal=causal, window=window,
                              kv_len=kv_len, chunk=chunk)
    want = attention_ref(tq, tk, tv, causal=causal, window=window,
                         kv_len=kv_len)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)
    if pallas:
        if case not in _PALLAS:
            _PALLAS[case] = _np(flash_attention_pallas(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                causal=causal, window=window, block_q=64, block_k=64))
        np.testing.assert_allclose(got.numpy(), _PALLAS[case], rtol=2e-5,
                                   atol=2e-5)


def test_split_twin_blind_rows_average_v_in_every_split():
    """kv_len 0 (no valid key) and a window past a full cache: the row
    group's band is every key, every chunk contributes, the blind rows
    get the mean of v."""
    from repro_torch.kernels.flash_attention.ref import attention_split_ref
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, s, 16))
                                .astype(np.float32)) for s in (4, 40, 40))
    got = attention_split_ref(q, k, v, causal=True, window=2,
                              kv_len=torch.tensor([0, 44], dtype=torch.int32),
                              chunk=8)
    mean = v.mean(1)
    np.testing.assert_allclose(got[0].numpy(),
                               mean[0].expand(4, 16).numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got[1, 1:].numpy(),
                               mean[1].expand(3, 16).numpy(), rtol=1e-5,
                               atol=1e-6)


# the variant select_variant gives each chip_smoke.FLASH_CASES entry
FLASH_VARIANTS = (["simt"] * 5 + ["tc", "simt", "tc", "tc"] + ["simt"] * 3
                  + ["decode", "tc", "decode", "simt", "simt", "tc", "tc",
                     "decode", "simt", "tc", "tc", "tc", "tc"]
                  + ["decode"] * 6 + ["simt", "simt"])


def test_variant_rule_on_chip_smoke_cases():
    """Every FLASH_CASES entry goes to the variant the rule names, and
    each variant meets every kind of case (plain, kv_len, kv_past,
    const_v where its dtype allows)."""
    cs = _chip_smoke()
    assert len(FLASH_VARIANTS) == len(cs.FLASH_CASES)
    rng = np.random.default_rng(0)
    kinds = {}
    for case, want in zip(cs.FLASH_CASES, FLASH_VARIANTS):
        q, k, v, _ = cs.flash_case(rng, case, "cpu")
        aligned = kernel._vec_ok((q, k, v), q.shape[-1])
        assert kernel.select_variant(q.dtype, q.shape, k.shape,
                                     aligned) == want, case
        kinds.setdefault(want, set()).add((case[6], case[7] is not None,
                                           case[1] > case[2], case[-1]))
    for variant in ("tc", "decode", "simt"):
        got = kinds[variant]
        assert {x[3] for x in got} >= {"plain", "kv_len", "kv_past"}, variant
        assert any(not x[0] for x in got), f"{variant}: no non-causal case"
        assert any(x[1] for x in got), f"{variant}: no window"
        assert any(x[2] and x[0] for x in got), f"{variant}: no Sq > Sk"
    assert "const_v" in {x[3] for x in kinds["decode"] | kinds["simt"]}


def test_variant_rule_on_phase_4_shapes():
    """gemma3-1b's prefill (bf16, 8 x 1,024) goes to the tensor-core
    variant and its decode over the cache (8 x 1 over 1,056 slots, read
    in place) to the split decode; fp32, a misaligned row, D not a
    multiple of 16 and too many heads per KV head take the CUDA-core
    variant; the split count follows from the shapes alone."""
    from repro_torch.configs import get_arch
    cfg = get_arch("gemma3-1b").config
    hq, hkv, d = cfg.n_heads, cfg.n_kv, cfg.d_head
    bf = torch.bfloat16
    q = torch.zeros((8, 1024, hq, d), dtype=bf)
    kv = torch.zeros((8, 1024, hkv, d), dtype=bf)

    def rule(q, k):
        return kernel.select_variant(q.dtype, q.shape, k.shape,
                                     kernel._vec_ok((q, k, k), q.shape[-1]))

    assert rule(q, kv) == "tc"
    cache = torch.zeros((2, 8, 1056, hkv, d), dtype=bf)[1]
    assert rule(torch.zeros((8, 1, hq, d), dtype=bf), cache) == "decode"
    assert rule(q.float(), kv.float()) == "simt"
    assert rule(torch.zeros((1, 64, 4, 40), dtype=bf),
                torch.zeros((1, 64, 1, 40), dtype=bf)) == "simt"
    wide = torch.zeros((1, 64, 2, 260), dtype=bf)[..., 1:257]
    assert rule(wide, wide) == "simt"                 # rows off 16 bytes
    assert rule(torch.zeros((1, 64, 129, 64), dtype=bf),
                torch.zeros((1, 64, 1, 64), dtype=bf)) == "simt"
    assert rule(torch.zeros((2, 4, 4, 64)), torch.zeros((2, 9, 1, 64))) \
        == "decode"                                   # fp32 decode
    assert kernel.decode_splits(8, 1, 1056) == 9
    assert kernel.decode_splits(128, 1, 32768) == 3
    assert kernel.decode_splits(4, 2, 300) == 3
    assert kernel.decode_splits(1, 1, 100) == 1
    assert kernel.decode_rows_padded(4) == 4
    assert kernel.decode_rows_padded(16) == 16
