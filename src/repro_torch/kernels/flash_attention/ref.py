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

``attention_split_ref`` is the decode variant's algorithm (flash-decoding)
in torch: per chunk of keys a partial (m, l, acc) in fp32, a chunk wholly
outside the band of keys the rows can see left empty, and the partials
combined in order.  It computes attention_ref's function.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def _rows(q, k, kv_len):
    """(lens, shift), each (BH, 1, 1) int64: keys below lens exist and are
    valid, query i sits at i + shift."""
    bh, sq, _ = q.shape
    sk = k.shape[1]
    dev = q.device
    if kv_len is None:
        return (torch.full((bh, 1, 1), sk, dtype=torch.int64, device=dev),
                torch.full((bh, 1, 1), sk - sq, dtype=torch.int64,
                           device=dev))
    kvl = kv_len.to(dev, torch.int64).clamp(min=0).view(bh, 1, 1)
    return kvl.clamp(max=sk), kvl - sq


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: Optional[int] = None,
                  kv_len: Optional[torch.Tensor] = None,
                  q_chunk: Optional[int] = None) -> torch.Tensor:
    bh, sq, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    lens, shift = _rows(q, k, kv_len)
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


def attention_split_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: Optional[int] = None,
                        kv_len: Optional[torch.Tensor] = None,
                        chunk: Optional[int] = None) -> torch.Tensor:
    """attention_ref's function by the decode variant's algorithm: keys in
    chunks of ``chunk`` (None: one chunk); per chunk and row the partial
    m = max logit, l = sum exp(logit - m), acc = p.to(v.dtype) @ v (fp32);
    a chunk wholly outside the band [k_begin, k_end) of keys that the
    row group's first and last rows can see (every key when either sees
    none) is the empty partial (m = -1e30, l = 0, acc = 0); then, in
    chunk order, M = max m, w = exp(m - M), o = sum(w acc) / max(sum(w
    l), 1e-30) in q's dtype."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    lens, shift = _rows(q, k, kv_len)
    q_pos = torch.arange(sq, device=dev)[None, :, None] + shift
    k_pos = torch.arange(sk, device=dev)[None, None, :]
    mask = k_pos < lens
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window is not None:
        mask = mask & (q_pos - k_pos < window)
    logits = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    logits = torch.where(mask, logits, NEG_INF)

    # the band of the row group, as the kernels compute it
    n, pos_lo, pos_hi = lens.view(bh), shift.view(bh), shift.view(bh) + sq - 1
    zero = torch.zeros_like(n)

    def band(pos):
        lo = (pos - window + 1).clamp(min=0) if window is not None else zero
        hi = torch.minimum(n, pos + 1) if causal else n
        return lo, hi

    lo_first, hi_first = band(pos_lo)
    lo_last, hi_last = band(pos_hi)
    blind = (hi_first <= lo_first) | (hi_last <= lo_last)
    k_begin = torch.where(blind, zero, lo_first)
    k_end = torch.where(blind, torch.full_like(n, sk), hi_last)

    step = sk if chunk is None else chunk
    ms, ls, accs = [], [], []
    for c0 in range(0, sk, step):
        c1 = min(sk, c0 + step)
        part = logits[:, :, c0:c1]
        m = part.max(-1, keepdim=True).values
        p = torch.exp(part - m)
        l = p.sum(-1, keepdim=True)
        acc = torch.einsum("bqk,bkd->bqd", p.to(v.dtype).float(),
                           v[:, c0:c1].float())
        empty = ((c1 <= k_begin) | (c0 >= k_end)).view(bh, 1, 1)
        ms.append(torch.where(empty, NEG_INF, m))
        ls.append(torch.where(empty, 0.0, l))
        accs.append(torch.where(empty, 0.0, acc))
    big = torch.stack(ms).max(0).values
    den = torch.zeros_like(big)
    num = torch.zeros((bh, sq, d), dtype=torch.float32, device=dev)
    for m, l, acc in zip(ms, ls, accs):
        w = torch.exp(m - big)
        den = den + w * l
        num = num + w * acc
    return (num / den.clamp(min=1e-30)).to(q.dtype)
