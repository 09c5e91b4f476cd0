"""qwen3-moe-235b-a22b — Qwen3-MoE [hf:Qwen/Qwen3-30B-A3B family].

94L d_model=4096 64H (GQA kv=4) d_ff=1536(expert) vocab=151936,
MoE 128 experts top-8.  d_head=128 (explicit; 64 heads x 128 > d_model).
"""
from repro_torch.configs.base import ArchSpec, lm_shapes
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="qwen3-moe-235b-a22b",
    n_layers=94, d_model=4096, n_heads=64, n_kv=4, d_head=128,
    d_ff=1536, vocab=151936,
    moe=MoEConfig(n_experts=128, top_k=8, d_expert=1536),
)

SPEC = ArchSpec(
    arch_id="qwen3-moe-235b-a22b", family="lm", config=CONFIG,
    shapes=lm_shapes(pure_full_attention=True),
    citation="hf:Qwen/Qwen3-30B-A3B",
)
