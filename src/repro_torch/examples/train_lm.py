"""End-to-end LM training example: a small dense LM for a few hundred
steps with checkpoint/restart through the refinable-timestamp
multi-version checkpoint store.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 200]
    PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu

The reference example's (``examples/train_lm.py``) model, data and
schedule: a simulated failure at half the steps, then resume from the
stamped checkpoint; the run fails unless the loss decreased.  Trains on
``--device`` (the card by default).
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_example_lm_ckpt"))
    args = ap.parse_args(argv)

    from repro_torch.core.analytics import check_device
    from repro_torch.data import synth
    from repro_torch.models import transformer
    from repro_torch.models.layers import ParamTree
    from repro_torch.models.transformer import LMConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import Trainer, TrainerConfig

    check_device(args.device)
    cfg = LMConfig(name="tiny-lm", n_layers=2, d_model=64, n_heads=4,
                   n_kv=2, d_head=16, d_ff=192, vocab=256, dtype="float32",
                   loss_chunks=0)
    model = ParamTree(transformer.init_params(cfg, seed=0,
                                              device=args.device))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {n_params/1e6:.2f}M params")

    rng = np.random.default_rng(0)
    gen = synth.token_batches(rng, cfg.vocab, batch=8, seq=32)

    shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    trainer = Trainer(lambda m, b: transformer.lm_loss(m.tree(), b, cfg),
                      model,
                      AdamWConfig(lr=3e-3, warmup_steps=10,
                                  total_steps=args.steps),
                      TrainerConfig(total_steps=args.steps, ckpt_every=50,
                                    ckpt_dir=args.ckpt_dir, log_every=25))
    trainer.fit(gen, until=args.steps // 2)
    print(f"-- simulating failure at step {trainer.step}; resuming from the "
          f"stamped checkpoint --")
    trainer.on_failure()
    trainer.fit(gen)
    first, last = trainer.history[0]["loss"], trainer.history[-1]["loss"]
    print(f"loss {first:.3f} -> {last:.3f} over {trainer.step} steps "
          f"(epoch after failure: {trainer.store.epoch})")
    if not last < first:
        print("loss should decrease", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
