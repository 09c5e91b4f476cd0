"""SASRec (Self-Attentive Sequential Recommendation, arXiv:1808.09781):
``encode``, the training loss ``bce_loss`` (the paper's BCE with one
sampled negative per position), ``score_catalog`` and
``score_candidates``.

Item-embedding table (the huge-sparse-table regime) + 2 causal
self-attention blocks over length-50 histories + dot-product scoring.
The item lookups (histories, targets and candidates) go through the
embedding_bag kernel as one-index bags, sum mode, weight 1
(``kernels/embedding_bag``: CUDA tensors launch it, CPU tensors take its
plain version): row 0 is a real row, so the result is the direct gather
bit for bit.  The reference indexes ``item_emb`` directly although its
docstring routes the lookups through the bag; the port does route them
while :func:`set_use_kernel` is on (the default), except where autograd
records through the table (the kernel has no backward): then, and
whenever the seam is off, it indexes directly, as the reference.
``score_catalog``'s ``h @ item_emb.T`` stays a plain matrix product, and
the blocks' attention stays plain torch: it masks padded keys, which the
flash kernel cannot express.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.analytics import check_device
from repro_torch.kernels.embedding_bag import ops as eb_ops

from .layers import params_from_jax

Param = dict

__all__ = ["SASRecConfig", "bce_loss", "encode", "init_params",
           "params_from_jax", "score_candidates", "score_catalog",
           "set_use_kernel", "table_rows"]

_USE_KERNEL = True


def set_use_kernel(flag: bool) -> None:
    """Route the item lookups through the embedding_bag kernel (the
    default, off the grad path), or index the table directly when off."""
    global _USE_KERNEL
    _USE_KERNEL = flag


@dataclasses.dataclass(frozen=True)
class SASRecConfig:
    name: str
    n_items: int
    seq_len: int = 50
    d_embed: int = 50
    n_blocks: int = 2
    n_heads: int = 1
    dtype: str = "float32"

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def table_rows(cfg: SASRecConfig, multiple: int = 32) -> int:
    """Embedding-table rows: n_items + 1 pad row, rounded up so the
    row-sharded table divides the mesh 'model' axis."""
    rows = cfg.n_items + 1
    return -(-rows // multiple) * multiple


def init_params(cfg: SASRecConfig, seed: int = 0, device="cuda") -> Param:
    """Random parameters on ``device`` from a ``torch.Generator`` seeded
    with ``seed`` (the reference's distributions, not its random bits)."""
    check_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = cfg.tdtype
    d = cfg.d_embed

    def normal(shape, std):
        return (torch.randn(shape, generator=gen, device=device) * std).to(dt)

    p = {
        # row 0 is the padding item; tail rows are sharding pad (unused)
        "item_emb": normal((table_rows(cfg), d), 0.02),
        "pos_emb": normal((cfg.seq_len, d), 0.02),
        "blocks": [],
    }
    for _ in range(cfg.n_blocks):
        p["blocks"].append({
            "wq": normal((d, d), 1 / np.sqrt(d)),
            "wk": normal((d, d), 1 / np.sqrt(d)),
            "wv": normal((d, d), 1 / np.sqrt(d)),
            "ln1": torch.ones((d,), dtype=dt, device=device),
            "w1": normal((d, d), 1 / np.sqrt(d)),
            "w2": normal((d, d), 1 / np.sqrt(d)),
            "ln2": torch.ones((d,), dtype=dt, device=device),
        })
    return p


def _ln(x, scale, eps=1e-6):
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps) * scale


def _lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` (idx of any shape): one-index bags of the
    embedding_bag kernel while the kernel is on, unless autograd records
    through ``table``."""
    if not _USE_KERNEL or (torch.is_grad_enabled() and table.requires_grad):
        return table[idx]
    # nothing records here: a trained parameter goes in detached (the
    # wrapper refuses any tensor that requires grad)
    rows = eb_ops.embedding_bag(table.detach(), idx.reshape(-1, 1),
                                mode="sum")
    return rows.reshape(*idx.shape, table.shape[1])


def encode(params: Param, hist: torch.Tensor, cfg: SASRecConfig):
    """hist (B, S) item ids (0 = pad) -> hidden states (B, S, d)."""
    b, s = hist.shape
    x = _lookup(params["item_emb"], hist) * np.sqrt(cfg.d_embed)
    x = x + params["pos_emb"][None, :s, :]
    pad_mask = hist > 0                                    # (B, S)
    causal = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                   device=hist.device))
    mask = causal[None, :, :] & pad_mask[:, None, :]
    h = cfg.n_heads
    dh = cfg.d_embed // h
    for blk in params["blocks"]:
        xn = _ln(x, blk["ln1"])
        q = (xn @ blk["wq"]).reshape(b, s, h, dh)
        k = (xn @ blk["wk"]).reshape(b, s, h, dh)
        v = (xn @ blk["wv"]).reshape(b, s, h, dh)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(dh)
        logits = torch.where(mask[:, None, :, :], logits, -1e30)
        att = torch.softmax(logits, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(b, s, -1)
        x = x + o
        xn = _ln(x, blk["ln2"])
        x = x + torch.relu(xn @ blk["w1"]) @ blk["w2"]
    return x * pad_mask[:, :, None]


def bce_loss(params: Param, batch: dict, cfg: SASRecConfig):
    """batch: hist (B,S), pos (B,S) next-item targets, neg (B,S) sampled
    negatives; 0 = pad."""
    h = encode(params, batch["hist"], cfg)                 # (B, S, d)
    pe = _lookup(params["item_emb"], batch["pos"])
    ne = _lookup(params["item_emb"], batch["neg"])
    pos_logit = torch.sum(h * pe, dim=-1)
    neg_logit = torch.sum(h * ne, dim=-1)
    mask = (batch["pos"] > 0).to(h.dtype)
    loss = -(F.logsigmoid(pos_logit) + F.logsigmoid(-neg_logit)) * mask
    loss = torch.sum(loss) / torch.clamp(torch.sum(mask), min=1.0)
    return loss, {"loss": loss}


@torch.no_grad()
def score_catalog(params: Param, hist: torch.Tensor, cfg: SASRecConfig):
    """Serve: score every item for each user (B, n_items+1)."""
    h = encode(params, hist, cfg)[:, -1, :]                # (B, d)
    return h @ params["item_emb"].T


@torch.no_grad()
def score_candidates(params: Param, hist: torch.Tensor,
                     candidates: torch.Tensor, cfg: SASRecConfig):
    """Retrieval: hist (B,S), candidates (B, C) -> scores (B, C)."""
    h = encode(params, hist, cfg)[:, -1, :]                # (B, d)
    ce = _lookup(params["item_emb"], candidates)           # (B, C, d)
    return torch.einsum("bd,bcd->bc", h, ce)
