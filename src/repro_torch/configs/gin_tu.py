"""gin-tu [arXiv:1810.00826] — GIN, 5 layers d=64, sum agg, learnable eps."""
from repro_torch.configs.base import ArchSpec, gnn_shapes
from repro_torch.models.gnn import GNNConfig

CONFIG = GNNConfig(
    name="gin-tu", kind="gin", n_layers=5, d_hidden=64,
    d_feat=16, n_classes=2, eps_learnable=True, task="node",
)

SPEC = ArchSpec(arch_id="gin-tu", family="gnn", config=CONFIG,
                shapes=gnn_shapes(), citation="arXiv:1810.00826")
