"""dimenet [arXiv:2003.03123] — 6 blocks d=128, n_bilinear=8,
n_spherical=7, n_radial=6 (directional message passing over triplets).

Triplet counts are bounded by the radius cutoff in molecular practice;
the grid's non-molecular cells cap triplets at 8 per edge (DESIGN.md)."""
from repro_torch.configs.base import ArchSpec, gnn_shapes
from repro_torch.models.gnn import GNNConfig

CONFIG = GNNConfig(
    name="dimenet", kind="dimenet", n_layers=6, d_hidden=128,
    d_feat=16, n_classes=1, n_bilinear=8, n_spherical=7, n_radial=6,
    task="energy",
)

SPEC = ArchSpec(arch_id="dimenet", family="gnn", config=CONFIG,
                shapes=gnn_shapes(), citation="arXiv:2003.03123")
