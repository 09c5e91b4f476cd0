"""Serving launcher: ``python -m repro_torch.launch.serve --mode <lm|rec>``.

lm / rec: batched model serving on reduced configs, on the card by
default (``--device cpu`` runs the kernels' plain versions on the CPU).
The database's ``--mode graph`` comes with its serving slice.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def serve_lm(args) -> int:
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import reduced_config
    from repro_torch.models import transformer
    from repro_torch.runtime import LMServer

    spec = get_arch(args.arch or "gemma3-1b")
    cfg = reduced_config(spec)
    params = transformer.init_params(cfg, seed=0, device=args.device)
    rng = np.random.default_rng(args.seed)
    srv = LMServer(params, cfg, batch=args.batch, max_len=64,
                   device=args.device)
    prompts = rng.integers(0, cfg.vocab, (args.batch, 16))
    first = srv.prefill_batch(prompts)
    toks = srv.decode(first, steps=16)
    print(f"decoded {toks.shape} tokens for {args.batch} sessions on "
          f"{args.device}")
    return 0


def serve_rec(args) -> int:
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import reduced_config
    from repro_torch.models import sasrec
    from repro_torch.runtime import RecServer

    cfg = reduced_config(get_arch("sasrec"))
    params = sasrec.init_params(cfg, seed=0, device=args.device)
    rng = np.random.default_rng(args.seed)
    srv = RecServer(params, cfg, device=args.device)
    hist = rng.integers(1, cfg.n_items + 1, (args.batch, cfg.seq_len))
    top = srv.top_k(hist, k=10)
    print(f"top-10 recommendations for {args.batch} users: {top.shape} on "
          f"{args.device}")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["lm", "rec"], required=True)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device} needs a CUDA device and "
                           f"none is available; pass --device cpu")
    return {"lm": serve_lm, "rec": serve_rec}[args.mode](args)


if __name__ == "__main__":
    sys.exit(main())
