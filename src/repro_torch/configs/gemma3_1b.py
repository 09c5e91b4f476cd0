"""gemma3-1b [hf:google/gemma-3-1b-pt] — 5:1 local:global, 128k-capable.

26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144, d_head=256,
sliding window 512 on local layers, embeddings scaled by sqrt(d).
Hybrid local/global => the ONE LM arch that runs long_500k decode.
"""
from repro_torch.configs.base import ArchSpec, lm_shapes
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="gemma3-1b",
    n_layers=26, d_model=1152, n_heads=4, n_kv=1, d_head=256,
    d_ff=6912, vocab=262144,
    window_pattern=(512, 512, 512, 512, 512, 0),   # 5 local : 1 global
    embed_scale=True,
)

SPEC = ArchSpec(
    arch_id="gemma3-1b", family="lm", config=CONFIG,
    shapes=lm_shapes(pure_full_attention=False),
    citation="hf:google/gemma-3-1b-pt",
)
