"""Public wrapper: (B, S, H, D) GQA layout.

A CUDA tensor goes to the CUDA kernel, which reads K/V in place through
their strides and indexes KV head ``h // n_rep`` (it launches or raises).
A CPU tensor, or ``use_ref=True``, goes to the plain version: KV heads
repeated, heads folded into the batch, :func:`.ref.attention_ref`.  The
reference's shape padding is not carried over: the kernel masks its own
ragged edges.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import kernel
from .ref import attention_ref


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool = True, window: Optional[int] = None,
            kv_len: Optional[torch.Tensor] = None,
            q_chunk: Optional[int] = None) -> torch.Tensor:
    """The plain version of :func:`mha`, on the tensors' device."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    n_rep = hq // hkv
    if n_rep > 1:
        k = torch.repeat_interleave(k, n_rep, dim=2)
        v = torch.repeat_interleave(v, n_rep, dim=2)
    qf = q.transpose(1, 2).reshape(b * hq, sq, d)
    kf = k.transpose(1, 2).reshape(b * hq, sk, d)
    vf = v.transpose(1, 2).reshape(b * hq, sk, d)
    lens = None if kv_len is None else torch.repeat_interleave(
        kv_len.to(q.device), hq)
    of = attention_ref(qf, kf, vf, causal=causal, window=window, kv_len=lens,
                       q_chunk=q_chunk)
    return of.reshape(b, hq, sq, d).transpose(1, 2)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        causal: bool = True, window: Optional[int] = None,
        kv_len: Optional[torch.Tensor] = None,
        use_ref: bool = False) -> torch.Tensor:
    """q (B, Sq, Hq, D); k/v (B, Sk, Hkv, D) -> (B, Sq, Hq, D).

    ``kv_len`` (B,) int32: keys at positions >= kv_len[b] are masked and
    the queries of row b end at position kv_len[b] - 1 (decode over a
    padded cache); without it every row has Sk keys.

    CUDA tensors go to one of three kernels by a static rule of dtype,
    shapes and strides (``kernel.select_variant``), with no fallback
    between them: the *decode* variant (split over the key axis, fp32 or
    bf16) when every row start of q, k and v is 16-byte aligned with D
    filling whole 16-byte slices and Sq * Hq / Hkv <= 16; else the
    *tc* variant (bf16 ``wgmma`` fed by TMA) for bf16 with those
    alignments, D a multiple of 16 and Hq / Hkv <= 128; else the *simt*
    variant (fp32 FMAs on the CUDA cores): fp32 prefill, whose reference
    tolerance (2e-5) TF32 tensor cores would miss, and rows that TMA
    cannot read."""
    if use_ref or q.device.type == "cpu":
        return mha_ref(q, k, v, causal=causal, window=window, kv_len=kv_len)
    if kv_len is not None:
        kv_len = kv_len.to(torch.int32).contiguous()
    return kernel.flash_attention(q, k, v, causal=causal, window=window,
                                  kv_len=kv_len)
