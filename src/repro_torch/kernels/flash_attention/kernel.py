"""CUDA kernels: online-softmax attention forward with GQA, causal and
sliding-window masks and per-row key lengths, in three variants.

* ``tc`` (``src/repro_torch/csrc/flash_attention_tc.cu``): bf16 prefill
  on the tensor cores (``wgmma``), K/V fed by TMA through an mbarrier
  ring;
* ``decode`` (``csrc/flash_decode.cu``): at most :data:`DECODE_ROWS` query
  rows per (batch row, KV head), fp32 or bf16, the key axis split across
  CTAs (:func:`decode_splits`) and the partials combined by a second
  kernel in a fixed order;
* ``simt`` (``csrc/flash_attention.cu``): fp32 FMAs on the CUDA cores,
  for what the other two do not take (fp32 prefill, whose fp32 tolerance
  TF32 tensor cores would miss, and rows that TMA cannot read).

:func:`select_variant` is the static rule; there is no fallback: the
chosen variant launches or the wrapper raises.  Each source is built for
``sm_90a`` at first use and bound with ``ctypes`` (see
:mod:`repro_torch.kernels.build`).  The wrapper takes CUDA tensors only
in the (B, S, H, D) layout, reads k and v through their strides (a
padded KV cache in place) and indexes KV head ``h // n_rep`` for query
head ``h`` instead of repeating K/V.  It checks its inputs, allocates the
output (and the decode variant's fp32 scratch) with ``torch.empty`` and
launches on the current stream without synchronising.
``launches["flash_attention"]`` counts every call that launched, and
``launches["flash_tc"]``, ``["flash_decode"]`` and ``["flash_simt"]`` the
calls of each variant (a decode call, split kernel and combine, is one).

There is no backward: the reference kernel has none and no reference
model differentiates through it, so the wrapper raises on an input that
requires grad rather than return a result without a gradient.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Sequence

import torch

from .. import build

#: variant -> CUDA source (``csrc/<name>.cu``)
SOURCES = {"tc": "flash_attention_tc", "decode": "flash_decode",
           "simt": "flash_attention"}
#: widest head the kernels take (their tiles pad D to 256)
MAX_D = 256
#: most query rows per (batch row, KV head) that the decode variant takes
DECODE_ROWS = 16
#: most query heads per KV head that the prefill variant's 128-row tiles
#: take (a tile holds 128 // n_rep positions)
TC_MAX_REP = 128
#: fewest keys per split of the decode variant
DECODE_MIN_CHUNK = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: launches per kernel since :func:`reset_launches`
launches: Dict[str, int] = {"flash_attention": 0, "flash_tc": 0,
                            "flash_decode": 0, "flash_simt": 0}

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
_COMMON = [_P] * 5 + [_I32] * 6 + [_I64] * 9 + [_I32, _I32, ctypes.c_float]
ARGTYPES = {"simt": _COMMON + [_I32, _I32, _P],      # dtype, vec, stream
            "tc": _COMMON + [_P],                   # stream
            "decode": _COMMON + [_I32, _I32, _P, _P, _P]}  # dtype, splits,
#                                                  part_ml, part_acc, stream
_bound: Dict[str, ctypes.CDLL] = {}
_n_sm: Dict[int, int] = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def bind(variant: str, lib: ctypes.CDLL) -> None:
    """Use ``lib`` (a build of the variant's source) for ``variant``."""
    fn = getattr(lib, SOURCES[variant])
    fn.argtypes = ARGTYPES[variant]
    fn.restype = ctypes.c_int
    _bound[variant] = lib


def _fn(variant: str):
    if variant not in _bound:
        bind(variant, build.load(SOURCES[variant]))
    return getattr(_bound[variant], SOURCES[variant])


def select_variant(dtype: torch.dtype, q_shape: Sequence[int],
                   kv_shape: Sequence[int], aligned: bool) -> str:
    """The variant that runs q of ``q_shape`` (B, Sq, Hq, D) over k/v of
    ``kv_shape`` (B, Sk, Hkv, D) in ``dtype``; ``aligned``: every row
    start of q, k and v is 16-byte aligned and D fills whole 16-byte
    slices (:func:`_vec_ok`).

    ``decode`` when aligned with Sq * Hq / Hkv <= DECODE_ROWS; else
    ``tc`` when bf16, aligned, D a multiple of 16 and Hq / Hkv <=
    TC_MAX_REP; else ``simt``."""
    _, sq, hq, d = q_shape
    n_rep = hq // kv_shape[2]
    if aligned and sq * n_rep <= DECODE_ROWS:
        return "decode"
    if dtype == torch.bfloat16 and aligned and d % 16 == 0 \
            and n_rep <= TC_MAX_REP:
        return "tc"
    return "simt"


def decode_splits(b: int, hkv: int, sk: int, n_sm: int = 132) -> int:
    """Chunks of the key axis for the decode variant, from the shapes
    alone (never kv_len, which would cost a device sync): enough CTAs to
    fill the ``n_sm`` SMs twice, and at least DECODE_MIN_CHUNK keys each."""
    want = -(-2 * n_sm // (b * hkv))
    return max(1, min(want, -(-sk // DECODE_MIN_CHUNK)))


def decode_rows_padded(rows: int) -> int:
    """Rows the decode kernel computes per (batch row, KV head)."""
    return 4 if rows <= 4 else 16


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


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _n_sm:
        _n_sm[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _n_sm[idx]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """o (B, Sq, Hq, D) in q's dtype: attention of q over k/v with KV head
    ``h // (Hq // Hkv)`` for query head h; query i of batch row b sits at
    position ``kv_len[b] - Sq + i`` (``Sk - Sq + i`` without kv_len) and
    sees the keys below ``min(kv_len[b], Sk)``, those at or
    before its position when ``causal``, and those less than ``window``
    positions back when ``window`` is set.  The variant is
    :func:`select_variant`'s."""
    check(q, k, v, window, kv_len)
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    o = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    aligned = _vec_ok((q, k, v), d)
    variant = select_variant(q.dtype, q.shape, k.shape, aligned)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if kv_len is None else kv_len.data_ptr(),
            b, sq, sk, hq, hkv, d, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], int(causal), window or 0, 1.0 / math.sqrt(d)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if variant == "tc":
            rc = _fn("tc")(*args, stream)
        elif variant == "decode":
            splits = decode_splits(b, hkv, sk, _sm_count(q.device))
            parts = b * hkv * splits * 4 * decode_rows_padded(sq * hq // hkv)
            ml = torch.empty(parts * 2, dtype=torch.float32, device=q.device)
            acc = torch.empty(parts * d, dtype=torch.float32, device=q.device)
            rc = _fn("decode")(*args, _DTYPES[q.dtype], splits,
                               ml.data_ptr(), acc.data_ptr(), stream)
        else:
            rc = _fn("simt")(*args, _DTYPES[q.dtype], int(aligned), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention ({variant}) launch failed with "
                           f"CUDA error {rc}")
    launches["flash_attention"] += 1
    launches[f"flash_{variant}"] += 1
    return o
