"""sasrec [arXiv:1808.09781] — embed_dim=50, 2 blocks, 1 head, seq 50.

Item table sized at 1M rows so the retrieval_cand shape (1M candidates)
is well-defined at production scale (taxonomy §B.6: 10^6-10^9 rows)."""
from repro_torch.configs.base import ArchSpec, recsys_shapes
from repro_torch.models.sasrec import SASRecConfig

CONFIG = SASRecConfig(
    name="sasrec", n_items=1_000_000, seq_len=50, d_embed=50,
    n_blocks=2, n_heads=1,
)

SPEC = ArchSpec(arch_id="sasrec", family="recsys", config=CONFIG,
                shapes=recsys_shapes(), citation="arXiv:1808.09781")
