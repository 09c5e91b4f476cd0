"""CUDA kernel: online-softmax attention forward with GQA, causal and
sliding-window masks and per-row key lengths.

The source is ``src/repro_torch/csrc/flash_attention.cu``
(``flash_attention``), built for ``sm_90a`` at first use and bound with
``ctypes`` (see :mod:`repro_torch.kernels.build`).  The wrapper takes CUDA
tensors only in the (B, S, H, D) layout, reads k and v through their
strides (a padded KV cache in place) and indexes KV head ``h // n_rep``
for query head ``h`` instead of repeating K/V.  It checks its inputs,
allocates the output with ``torch.empty`` and launches on the current
stream without synchronising.  ``launches["flash_attention"]`` counts
its calls that launched.

There is no backward: the reference kernel has none and no reference
model differentiates through it, so the wrapper raises on an input that
requires grad rather than return a result without a gradient.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

from .. import build

SOURCE = "flash_attention"
#: widest head the kernel takes (its shared-memory tiles pad D to 256)
MAX_D = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: launches per kernel since :func:`reset_launches`
launches: Dict[str, int] = {"flash_attention": 0}

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
_ARGTYPES = ([_P] * 5 + [_I32] * 6 + [_I64] * 9
             + [_I32, _I32, ctypes.c_float, _I32, _I32, _P])
_bound = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _lib():
    global _bound
    if _bound is None:
        lib = build.load(SOURCE)
        lib.flash_attention.argtypes = _ARGTYPES
        lib.flash_attention.restype = ctypes.c_int
        _bound = lib
    return _bound


def check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          window: Optional[int], kv_len: Optional[torch.Tensor]) -> None:
    """Raise unless the inputs are what the kernel takes: CUDA tensors on
    one device, none requiring grad; q (B, Sq, Hq, D) and k, v (B, Sk,
    Hkv, D) of one dtype (fp32 or bf16) with a contiguous last dim, Sk >=
    1, 1 <= D <= MAX_D and Hq a multiple of Hkv; window None or >= 1;
    kv_len None or contiguous int32 (B,)."""
    ts = [q, k, v] + ([] if kv_len is None else [kv_len])
    for t in ts:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"expected a torch.Tensor, got {type(t)}")
    if any(t.requires_grad for t in ts):
        raise ValueError("flash_attention has no backward: its inputs must "
                         "not require grad (use the plain version to train)")
    if q.device.type != "cuda":
        raise ValueError(f"the flash_attention kernel takes CUDA tensors, "
                         f"got {q.device}")
    for t in ts:
        if t.device != q.device:
            raise ValueError(f"tensors on {t.device} and {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share fp32 or bf16, got {q.dtype}, "
                        f"{k.dtype} and {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    b, _, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or k.shape[1] < 1:
        raise ValueError(f"k {tuple(k.shape)} does not fit q {tuple(q.shape)}")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"D = {d} outside 1..{MAX_D}")
    if hq % k.shape[2]:
        raise ValueError(f"{hq} query heads for {k.shape[2]} KV heads")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k and v need a contiguous last dim")
    if window is not None and window < 1:
        raise ValueError(f"window = {window}: None or >= 1")
    if kv_len is not None and (kv_len.dtype != torch.int32
                               or tuple(kv_len.shape) != (b,)
                               or not kv_len.is_contiguous()):
        raise ValueError(f"kv_len must be contiguous int32 ({b},)")


def _vec_ok(ts, d: int) -> bool:
    """Every row start of every tensor is 16-byte aligned and D fills
    whole 16-byte loads."""
    vec = 16 // ts[0].element_size()
    return d % vec == 0 and all(
        t.data_ptr() % 16 == 0 and all(s % vec == 0 for s in t.stride()[:3])
        for t in ts)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """o (B, Sq, Hq, D) in q's dtype: attention of q over k/v with KV head
    ``h // (Hq // Hkv)`` for query head h; query i of batch row b sits at
    position ``kv_len[b] - Sq + i`` (``Sk - Sq + i`` without kv_len) and
    sees the keys below ``min(kv_len[b], Sk)``, those at or
    before its position when ``causal``, and those less than ``window``
    positions back when ``window`` is set."""
    check(q, k, v, window, kv_len)
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    o = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _lib().flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if kv_len is None else kv_len.data_ptr(),
            b, sq, sk, hq, hkv, d, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], int(causal), window or 0, 1.0 / math.sqrt(d),
            _DTYPES[q.dtype], int(_vec_ok((q, k, v), d)), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed with CUDA error "
                           f"{rc}")
    launches["flash_attention"] += 1
    return o
