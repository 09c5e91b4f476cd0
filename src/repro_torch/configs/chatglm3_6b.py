"""chatglm3-6b [arXiv:2406.12793] — RoPE 2d (partial rotary), GQA kv=2.

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024, d_head=128,
rotary on half the head dims, QKV bias.
"""
from repro_torch.configs.base import ArchSpec, lm_shapes
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="chatglm3-6b",
    n_layers=28, d_model=4096, n_heads=32, n_kv=2, d_head=128,
    d_ff=13696, vocab=65024,
    rope_fraction=0.5, qkv_bias=True,
)

SPEC = ArchSpec(
    arch_id="chatglm3-6b", family="lm", config=CONFIG,
    shapes=lm_shapes(pure_full_attention=True),
    citation="arXiv:2406.12793",
)
