"""Gradient compression for the cross-pod hop: int8 quantization with
error feedback (1-bit-Adam-family trick adapted to int8).

Quantizing the cross-pod summand of a gradient all-reduce to int8 with
per-tensor scales cuts that traffic 4x (bf16) while error feedback keeps
convergence (residuals re-injected next step).  Gradient trees are nested
dicts and lists of tensors (the optimizer's ``{name: tensor}`` dicts
among them), walked by ``layers.map_tree``; ``torch.round`` rounds half to even, as ``jnp.round`` does,
so q and the scale are the reference's bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.models.layers import map_tree


class EFState(NamedTuple):
    residual: dict          # same tree as grads, fp32


def _pair(x) -> bool:
    return type(x) is tuple       # a (q, scale) or (pair, residual) leaf


def init_error_feedback(params) -> EFState:
    return EFState(residual=map_tree(
        lambda _, p: torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device), params))


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization; returns (q, scale)."""
    x32 = x.to(torch.float32)
    scale = torch.clamp(torch.max(torch.abs(x32)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_grads(grads, ef: EFState) -> Tuple[dict, EFState]:
    """Quantize grads+residual to int8; new residual = quantization error.

    The returned tree holds (q, scale) pairs; ``decompress_grads``
    reconstructs fp32.
    """
    def one(_, g, r):
        tot = g.to(torch.float32) + r
        q, s = quantize_int8(tot)
        return (q, s), tot - dequantize_int8(q, s)

    both = map_tree(one, grads, ef.residual)
    return (map_tree(lambda _, qr: qr[0], both, is_leaf=_pair),
            EFState(residual=map_tree(lambda _, qr: qr[1], both,
                                      is_leaf=_pair)))


def decompress_grads(qtree) -> dict:
    return map_tree(lambda _, qs: dequantize_int8(*qs), qtree, is_leaf=_pair)
