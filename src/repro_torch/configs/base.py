"""Config schema: architectures x input shapes.

The registry of the port holds the GNN architectures; the LM and recsys
config types come with their slices.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.models.gnn import GNNConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell for an architecture.

    kind: gnn_full / gnn_mini / gnn_mol (GNN family).
    dims: family-specific sizes.
    skip: non-empty => cell skipped, with the reason recorded.
    """

    name: str
    kind: str
    dims: Dict[str, int]
    skip: str = ""


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                     # gnn
    config: GNNConfig
    shapes: Dict[str, ShapeSpec]
    citation: str = ""


def gnn_shapes() -> Dict[str, ShapeSpec]:
    # minibatch_lg: Reddit-scale graph, layer-wise fanout 15-10 from 1024
    # seeds -> 169,984 nodes / 168,960 edges in the sampled subgraph
    # (d_feat=602 per the Reddit dataset; the grid spec pins only the
    # full-graph cells' feature widths).
    return {
        "full_graph_sm": ShapeSpec("full_graph_sm", "gnn_full",
                                   {"n_nodes": 2708, "n_edges": 10556,
                                    "d_feat": 1433, "n_classes": 7}),
        "minibatch_lg": ShapeSpec("minibatch_lg", "gnn_mini",
                                  {"graph_nodes": 232965,
                                   "graph_edges": 114615892,
                                   "batch_nodes": 1024,
                                   "fanout1": 15, "fanout2": 10,
                                   "n_nodes": 169984, "n_edges": 168960,
                                   "d_feat": 602, "n_classes": 41}),
        "ogb_products": ShapeSpec("ogb_products", "gnn_full",
                                  {"n_nodes": 2449029, "n_edges": 61859140,
                                   "d_feat": 100, "n_classes": 47}),
        "molecule": ShapeSpec("molecule", "gnn_mol",
                              {"n_nodes": 30, "n_edges": 64, "batch": 128,
                               "d_feat": 16, "n_classes": 2}),
    }
