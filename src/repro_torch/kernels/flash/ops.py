"""Wrappers of the flash-attention CUDA kernel (K4): a prefill form and a
decode form, with the reference's signatures and semantics
(``repro.kernels.flash.ops.flash_attention_tpu`` / ``flash_decode_tpu``).

A CUDA tensor launches ``csrc/flash_attn.cu`` (or raises); a CPU tensor
takes the plain version in ref.py; any other device raises.  Operands may
be strided views (a slice of a KV cache, a head split of a projection):
only the last dim must be contiguous.  Both forms count as launches of
``flash_attention``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _build, _checks
from .ref import attention_ref

KERNEL = "flash_attention"
_I, _LL, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
_PREFILL_ARGTYPES = ((_P,) * 4 + (_I,) * 7 + (_LL,) * 9
                     + (_I, _I, ctypes.c_float, _P))
_DECODE_ARGTYPES = ((_P,) * 4 + (_I,) * 6 + (_LL,) * 8
                    + (ctypes.c_float, _P))


def _strides(t: torch.Tensor):
    return t.stride(0), t.stride(1), t.stride(2)


def _dtype_code(t: torch.Tensor) -> int:
    return _checks.ATTENTION_DTYPES.index(t.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Skv, Hkv, D), GQA with g = H // Hkv.
    Query i sees key j when j <= i (``causal``) and j > i - window
    (``window``).  Returns (B, Sq, H, D) in q's dtype."""
    if window is not None and window < 1:
        raise ValueError(f"{KERNEL}: window {window} must be at least 1")
    if _checks.attention(KERNEL, q, k, v) == "cpu":
        return attention_ref(q, k, v, causal=causal,
                             window=window).to(q.dtype)
    B, Sq, H, D = q.shape
    _, Skv, Hkv, _ = k.shape
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    if Sq == 0:
        return out
    fn = _build.function("flash_attn", "flash_attn_launch",
                         _PREFILL_ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch(KERNEL, fn, out.data_ptr(), q.data_ptr(),
                      k.data_ptr(), v.data_ptr(), _dtype_code(q), B, H, Hkv,
                      D, Sq, Skv, *_strides(q), *_strides(k), *_strides(v),
                      int(causal), window or 0, 1.0 / math.sqrt(D), stream)
    return out


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, *, window=None) -> torch.Tensor:
    """One-token decode: q (B, 1, H, D) against every key of the
    (B, S, Hkv, D) caches it is given, no mask.  As in the reference, the
    query sits at position 0, so ``window`` drops no key: a caller passes
    the span of the cache it wants seen."""
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"{KERNEL}: decode takes q of shape (B, 1, H, D), "
                         f"got {tuple(q.shape)}")
    if _checks.attention(KERNEL, q, k_cache, v_cache) == "cpu":
        return attention_ref(q, k_cache, v_cache,
                             causal=False).to(q.dtype)
    B, _, H, D = q.shape
    _, Skv, Hkv, _ = k_cache.shape
    out = torch.empty((B, 1, H, D), dtype=q.dtype, device=q.device)
    fn = _build.function("flash_attn", "flash_decode_launch",
                         _DECODE_ARGTYPES)
    qsb, _, qsh = _strides(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch(KERNEL, fn, out.data_ptr(), q.data_ptr(),
                      k_cache.data_ptr(), v_cache.data_ptr(), _dtype_code(q),
                      B, H, Hkv, D, Skv, qsb, qsh, *_strides(k_cache),
                      *_strides(v_cache), 1.0 / math.sqrt(D), stream)
    return out
