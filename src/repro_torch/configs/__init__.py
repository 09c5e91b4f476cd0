"""Architecture registry: ``get_arch(<id>)`` resolution.

The reference's ten architectures (5 LM: moonshot and qwen3-moe with
MoE layers, phi4-mini, gemma3-1b, chatglm3-6b; 4 GNN: gin-tu, pna,
gat-cora, dimenet; sasrec), each with its shape set, and the paper
system's own deployment config.
"""

from __future__ import annotations

from typing import Dict, List

from .base import ArchSpec, ShapeSpec

from . import (chatglm3_6b, dimenet, gat_cora, gemma3_1b, gin_tu,
               moonshot_v1_16b_a3b, phi4_mini_3p8b, pna, qwen3_moe_235b_a22b,
               sasrec)
from .weaver_store import PAPER_DEPLOYMENT

_MODULES = [moonshot_v1_16b_a3b, qwen3_moe_235b_a22b, phi4_mini_3p8b,
            gemma3_1b, chatglm3_6b, gin_tu, pna, dimenet, gat_cora, sasrec]

ARCHS: Dict[str, ArchSpec] = {m.SPEC.arch_id: m.SPEC for m in _MODULES}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def all_cells(include_skipped: bool = True) -> List[tuple]:
    """Every (arch_id, shape_name, ShapeSpec) cell of the grid."""
    out = []
    for aid, spec in ARCHS.items():
        for sname, sh in spec.shapes.items():
            if include_skipped or not sh.skip:
                out.append((aid, sname, sh))
    return out


__all__ = ["ARCHS", "get_arch", "all_cells", "ArchSpec", "ShapeSpec",
           "PAPER_DEPLOYMENT"]
