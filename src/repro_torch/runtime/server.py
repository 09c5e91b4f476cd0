"""Batched model serving loops.

* :class:`LMServer` — LM decode serving with a batch of sessions over a
  shared KV cache (prefill + decode_step), greedy sampling.
* :class:`RecServer` — SASRec scoring (catalog or candidate mode).

Both run on ``device`` ("cuda" by default; without a card that raises,
and ``device="cpu"`` runs the kernels' plain versions).  The reference's
``jax.jit`` wrappers have no counterpart: PyTorch runs eagerly.  The
reference's ``GraphQueryServer`` (node programs against a Weaver
deployment) comes with the database's serving slice.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from repro_torch.core.analytics import check_device
from repro_torch.models import sasrec, transformer


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _ids(device, a) -> torch.Tensor:
    """Token or item ids (a numpy array, or a tensor on any device) as
    int64 on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device).long()
    return torch.as_tensor(np.asarray(a), device=device).long()


@dataclasses.dataclass
class LMSession:
    sid: int
    prompt: np.ndarray
    generated: List[int] = dataclasses.field(default_factory=list)


class LMServer:
    """Batch decode server (greedy sampling) over one KV cache of
    ``batch`` rows and ``max_len`` slots."""

    def __init__(self, params, cfg: transformer.LMConfig, batch: int,
                 max_len: int, device="cuda"):
        check_device(device)
        self.device = torch.device(device)
        self.params = _to(params, self.device)
        self.cfg = cfg
        self.batch = batch
        self.max_len = max_len
        self.cache = transformer.init_cache(cfg, batch, max_len,
                                            device=self.device)

    def prefill(self, prompts: np.ndarray) -> torch.Tensor:
        """Run the prompts (B, S) into a fresh cache: last-position
        logits (B, V) on the device."""
        logits, self.cache = transformer.prefill(
            self.params, _ids(self.device, prompts), self.cfg,
            max_len=self.max_len)
        return logits[:, -1, :]

    def step(self, tokens) -> torch.Tensor:
        """Feed one token per row (B,): next-token logits (B, V)."""
        logits, self.cache = transformer.decode_step(
            self.params, self.cache, _ids(self.device, tokens)[:, None],
            self.cfg)
        return logits[:, -1, :]

    def prefill_batch(self, prompts: np.ndarray) -> np.ndarray:
        return torch.argmax(self.prefill(prompts), dim=-1).cpu().numpy()

    def decode(self, tokens: np.ndarray, steps: int) -> np.ndarray:
        out = []
        cur = _ids(self.device, tokens)
        for _ in range(steps):
            cur = torch.argmax(self.step(cur), dim=-1)
            out.append(cur.cpu().numpy())
        return np.stack(out, axis=1)


class RecServer:
    """SASRec serving: catalog top-k and candidate scores.

    Item ids given as a numpy array or a CPU tensor are checked on the
    host before they are uploaded: an id outside ``[0, table rows)``
    raises ``IndexError`` and the server stays usable.  Ids given as a
    CUDA tensor go to the kernel unchecked (checking them would read the
    card); the embedding_bag kernel traps on one past the table, which
    ends the process's CUDA context.
    """

    def __init__(self, params, cfg: sasrec.SASRecConfig, device="cuda"):
        check_device(device)
        self.device = torch.device(device)
        self.params = _to(params, self.device)
        self.cfg = cfg

    def _items(self, a) -> torch.Tensor:
        """Item ids as int64 on the server's device, range-checked on the
        host unless they already lie on a CUDA device."""
        if isinstance(a, torch.Tensor) and a.device.type != "cpu":
            return a.to(self.device).long()
        host = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        rows = self.params["item_emb"].shape[0]
        if host.size:
            lo, hi = host.min(), host.max()
            if lo < 0 or hi >= rows:
                raise IndexError(f"item id {lo if lo < 0 else hi} outside "
                                 f"[0, {rows}), the item table's rows")
        return _ids(self.device, host)

    def top_k(self, hist: np.ndarray, k: int = 10) -> np.ndarray:
        scores = sasrec.score_catalog(self.params, self._items(hist),
                                      self.cfg)
        _, idx = torch.topk(scores, k)
        return idx.cpu().numpy()

    def score(self, hist: np.ndarray, candidates: np.ndarray) -> np.ndarray:
        return sasrec.score_candidates(
            self.params, self._items(hist), self._items(candidates),
            self.cfg).cpu().numpy()
