"""The paper system's own deployment config (Weaver itself, §5).

44-machine cluster of the paper mapped to simulator parameters; used by
benchmarks and the serving examples.
"""
from repro_torch.core.gatekeeper import CostModel
from repro_torch.core.simulation import NetworkModel
from repro_torch.core.weaver import WeaverConfig

PAPER_DEPLOYMENT = WeaverConfig(
    n_gatekeepers=4,
    n_shards=8,
    tau=0.2e-3,           # vector-clock announce period (swept in Fig. 14;
                          # §3.5: tuned to the workload — serving mixes
                          # run tight announce cadence)
    tau_nop=0.1e-3,
    gc_period=50e-3,
    cost=CostModel(),
    network=NetworkModel(base_latency=100e-6, bandwidth=125e6),
)
