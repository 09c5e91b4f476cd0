"""gat-cora [arXiv:1710.10903] — 2 layers, 8 heads x d=8, attn agg."""
from repro_torch.configs.base import ArchSpec, gnn_shapes
from repro_torch.models.gnn import GNNConfig

CONFIG = GNNConfig(
    name="gat-cora", kind="gat", n_layers=2, d_hidden=8, n_heads=8,
    d_feat=1433, n_classes=7, task="node",
)

SPEC = ArchSpec(arch_id="gat-cora", family="gnn", config=CONFIG,
                shapes=gnn_shapes(), citation="arXiv:1710.10903")
