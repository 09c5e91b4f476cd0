"""pna [arXiv:2004.05718] — 4 layers d=75, mean/max/min/std aggregators,
identity/amplification/attenuation scalers."""
from repro_torch.configs.base import ArchSpec, gnn_shapes
from repro_torch.models.gnn import GNNConfig

CONFIG = GNNConfig(
    name="pna", kind="pna", n_layers=4, d_hidden=75,
    d_feat=16, n_classes=2,
    aggregators=("mean", "max", "min", "std"),
    scalers=("identity", "amplification", "attenuation"),
    task="node",
)

SPEC = ArchSpec(arch_id="pna", family="gnn", config=CONFIG,
                shapes=gnn_shapes(), citation="arXiv:2004.05718")
