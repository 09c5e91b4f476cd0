"""phi4-mini-3.8b [arXiv:2412.08905] — dense, RoPE SwiGLU GQA.

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064, d_head=128.
"""
from repro_torch.configs.base import ArchSpec, lm_shapes
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="phi4-mini-3.8b",
    n_layers=32, d_model=3072, n_heads=24, n_kv=8, d_head=128,
    d_ff=8192, vocab=200064,
)

SPEC = ArchSpec(
    arch_id="phi4-mini-3.8b", family="lm", config=CONFIG,
    shapes=lm_shapes(pure_full_attention=True),
    citation="arXiv:2412.08905",
)
