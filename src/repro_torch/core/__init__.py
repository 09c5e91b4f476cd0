"""Weaver core: refinable timestamps, timeline oracle, MVCC graph store.

The paper's primary contribution (refinable timestamps — proactive vector
clocks + reactive timeline oracle) plus every substrate it depends on:
gatekeepers, shard servers, the strictly serializable backing store, the
cluster manager with epoch barriers, node programs and distributed GC.
"""

from .clock import Order, Stamp, compare, happens_before, concurrent, merge, zero
from .gatekeeper import CostModel, Gatekeeper
from .mvgraph import MVGraphPartition
from .nodeprog import REGISTRY, NodeProgram, register
from .oracle import CycleError, OracleServer, TimelineOracle
from .shard import Shard
from .simulation import NetworkModel, Simulator
from .store import BackingStore
from .txn import Transaction, TxResult
from .weaver import ProgCoordinator, Weaver, WeaverConfig

__all__ = [
    "Order", "Stamp", "compare", "happens_before", "concurrent", "merge",
    "zero", "CostModel", "Gatekeeper", "MVGraphPartition", "REGISTRY",
    "NodeProgram", "register", "CycleError", "OracleServer", "TimelineOracle",
    "Shard", "NetworkModel", "Simulator", "BackingStore", "Transaction",
    "TxResult", "ProgCoordinator", "Weaver", "WeaverConfig",
]
