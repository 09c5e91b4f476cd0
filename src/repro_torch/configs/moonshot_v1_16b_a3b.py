"""moonshot-v1-16b-a3b — Moonlight-16B-A3B [hf:moonshotai/Moonlight-16B-A3B].

48L d_model=2048 16H (GQA kv=16 == MHA) d_ff=1408(expert) vocab=163840,
MoE 64 experts top-6 (+2 Moonlight shared experts).
"""
from repro_torch.configs.base import ArchSpec, lm_shapes
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="moonshot-v1-16b-a3b",
    n_layers=48, d_model=2048, n_heads=16, n_kv=16, d_head=128,
    d_ff=1408, vocab=163840,
    moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared=2),
)

SPEC = ArchSpec(
    arch_id="moonshot-v1-16b-a3b", family="lm", config=CONFIG,
    shapes=lm_shapes(pure_full_attention=True),
    citation="hf:moonshotai/Moonlight-16B-A3B",
)
