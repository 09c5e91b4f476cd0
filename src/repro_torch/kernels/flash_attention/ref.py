"""Plain PyTorch version of causal (optionally sliding-window) attention.

q (BH, Sq, D), k/v (BH, Sk, D), batch*heads folded into the leading dim
(GQA head-group expansion happens in ops.py).  A copy of the reference's
jnp oracle: logits in fp32, masked logits set to -1e30, softmax, the
probabilities cast to q's dtype before the p @ v product.  It runs on
whatever device the tensors lie on; this is what the CPU path runs and
what the CUDA kernel is held against on the card.

``kv_len`` (BH,) extends the reference for decode over a padded cache:
row r's keys at positions >= min(kv_len[r], Sk) are masked and its
queries sit at ``kv_len[r] - Sq + i`` (a negative kv_len counts as 0; a
kv_len past Sk leaves every key valid, as decode past a full cache
does).  Without it, every row
has Sk keys, which is the reference's function exactly.  ``q_chunk``
computes the same result ``q_chunk`` query rows at a time, so that long
sequences fit in memory.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: Optional[int] = None,
                  kv_len: Optional[torch.Tensor] = None,
                  q_chunk: Optional[int] = None) -> torch.Tensor:
    bh, sq, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    if kv_len is None:
        shift = torch.full((bh, 1, 1), sk - sq, dtype=torch.int64,
                           device=dev)
        lens = torch.full((bh, 1, 1), sk, dtype=torch.int64, device=dev)
    else:
        kvl = kv_len.to(dev, torch.int64).clamp(min=0).view(bh, 1, 1)
        lens = kvl.clamp(max=sk)
        shift = kvl - sq
    k_pos = torch.arange(sk, device=dev)[None, None, :]
    step = sq if q_chunk is None else q_chunk
    outs = []
    for i0 in range(0, sq, max(step, 1)):
        qc = q[:, i0:i0 + step]
        logits = torch.einsum("bqd,bkd->bqk", qc.float(), k.float()) * scale
        q_pos = torch.arange(i0, i0 + qc.shape[1], device=dev)[None, :, None] \
            + shift
        mask = k_pos < lens
        if causal:
            mask = mask & (k_pos <= q_pos)
        if window is not None:
            mask = mask & (q_pos - k_pos < window)
        logits = torch.where(mask, logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        del logits
        outs.append(torch.einsum("bqk,bkd->bqd", probs.to(q.dtype), v))
    if len(outs) == 1:
        return outs[0]
    return torch.cat(outs, dim=1) if outs else q.new_empty((bh, 0, d))
