"""Config schema: architectures x input shapes."""

from __future__ import annotations

import dataclasses
from typing import Dict, Union

from repro_torch.models.gnn import GNNConfig
from repro_torch.models.sasrec import SASRecConfig
from repro_torch.models.transformer import LMConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell for an architecture.

    kind:
      lm_train / lm_prefill / lm_decode         (LM family)
      gnn_full / gnn_mini / gnn_mol             (GNN family)
      rec_train / rec_serve / rec_retrieval     (recsys family)
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
    family: str                     # lm | gnn | recsys
    config: Union[LMConfig, GNNConfig, SASRecConfig]
    shapes: Dict[str, ShapeSpec]
    citation: str = ""


def lm_shapes(pure_full_attention: bool) -> Dict[str, ShapeSpec]:
    skip = ("pure full-attention arch: long_500k requires sub-quadratic "
            "attention (DESIGN.md §Arch-applicability)"
            if pure_full_attention else "")
    return {
        "train_4k": ShapeSpec("train_4k", "lm_train",
                              {"seq": 4096, "batch": 256}),
        "prefill_32k": ShapeSpec("prefill_32k", "lm_prefill",
                                 {"seq": 32768, "batch": 32}),
        "decode_32k": ShapeSpec("decode_32k", "lm_decode",
                                {"seq": 32768, "batch": 128}),
        "long_500k": ShapeSpec("long_500k", "lm_decode",
                               {"seq": 524288, "batch": 1}, skip=skip),
    }


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


def recsys_shapes() -> Dict[str, ShapeSpec]:
    return {
        "train_batch": ShapeSpec("train_batch", "rec_train",
                                 {"batch": 65536}),
        "serve_p99": ShapeSpec("serve_p99", "rec_serve", {"batch": 512}),
        "serve_bulk": ShapeSpec("serve_bulk", "rec_serve",
                                {"batch": 262144}),
        "retrieval_cand": ShapeSpec("retrieval_cand", "rec_retrieval",
                                    {"batch": 1, "n_candidates": 1_000_000}),
    }
