"""Training launcher helpers.  ``reduced_config`` gives the REDUCED
config of an architecture that the CPU tests and the serving launcher
run (same code path as the full config).  The training entry point
(``main``) comes with the training slice of the port."""

from __future__ import annotations

import dataclasses


def reduced_config(spec):
    cfg = spec.config
    if spec.family == "lm":
        if cfg.moe is not None:
            raise NotImplementedError(
                f"{spec.arch_id}: MoE layers are not ported yet")
        return dataclasses.replace(
            cfg, n_layers=2, d_model=64, n_heads=4,
            n_kv=max(1, cfg.n_kv * 4 // cfg.n_heads), d_head=16, d_ff=128,
            vocab=512, dtype="float32")
    if spec.family == "gnn":
        return dataclasses.replace(cfg, d_hidden=32, d_feat=16, n_classes=4)
    return dataclasses.replace(cfg, n_items=1000, seq_len=16, d_embed=32)
