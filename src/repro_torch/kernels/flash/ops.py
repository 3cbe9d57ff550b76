"""Wrappers of the flash-attention CUDA kernel (K4): its prefill forms
and its decode form, with the reference's signatures and semantics
(``repro.kernels.flash.ops.flash_attention_tpu`` / ``flash_decode_tpu``).

A CUDA tensor launches ``csrc/flash_attn.cu`` (or raises); a CPU tensor
takes the plain version in ref.py; any other device raises.  Operands may
be strided views (a slice of a KV cache, a head split of a projection):
only the last dim must be contiguous.  A bf16 prefill goes to the
tensor-core form (``csrc/flash_attn_mma.cuh``), which copies 16-byte rows:
its operands must also meet ``_checks.mma_misalignment``'s rule, or the
wrapper raises (there is no other bf16 prefill form to fall back to).  An
f32 prefill goes to the SIMT form.

Every launch counts under ``flash_attention`` and under its form,
``flash_attention:<form>`` for the forms of ``FORMS``; ``form_launches``
reads the latter.
"""
from __future__ import annotations

import ctypes
import math
import re

import torch

from .. import _build, _checks
from .ref import attention_ref

KERNEL = "flash_attention"
FORMS = ("prefill_mma", "prefill_simt", "decode")
_I, _LL, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
_PREFILL_ARGTYPES = ((_P,) * 4 + (_I,) * 7 + (_LL,) * 9
                     + (_I, _I, ctypes.c_float, _P))
_DECODE_ARGTYPES = ((_P,) * 4 + (_I,) * 6 + (_LL,) * 8
                    + (ctypes.c_float, _P))
_SCORES_ARGTYPES = (_P,) * 3 + (_I,) * 6 + (_LL,) * 6 + (_P,)

# a kernel of the library by its mangled name: form, type, head dim
_ENTRY = re.compile(r"(flash_(?:mma|prefill|decode)_kernel)I(.*?)Li(\d+)E")
_FORM_OF = {"flash_mma_kernel": "prefill_mma",
            "flash_prefill_kernel": "prefill_simt",
            "flash_decode_kernel": "decode"}


def resources(built: _build.Built) -> dict:
    """Per form, then per type and head dim ("bf16_d256"): ptxas's
    registers, stack and spill bytes for each kernel of a built
    ``flash_attn`` library, and the tensor-core form's shared bytes per
    block."""
    smem = built.lib.flash_mma_smem_bytes
    smem.argtypes, smem.restype = [ctypes.c_int], ctypes.c_int
    out = {}
    for name, use in _build.ptxas_usage(built.log).items():
        m = _ENTRY.search(name)
        if not m:
            continue
        form, D = _FORM_OF[m.group(1)], int(m.group(3))
        dtype = "f32" if m.group(2) == "f" else "bf16"
        entry = dict(use)
        if form == "prefill_mma":
            entry["smem_bytes"] = smem(D)
        out.setdefault(form, {})[f"{dtype}_d{D}"] = entry
    return out


def _strides(t: torch.Tensor):
    return t.stride(0), t.stride(1), t.stride(2)


def _dtype_code(t: torch.Tensor) -> int:
    return _checks.ATTENTION_DTYPES.index(t.dtype)


def prefill_form(dtype: torch.dtype) -> str:
    """The prefill form a CUDA operand of ``dtype`` launches."""
    return "prefill_mma" if dtype == torch.bfloat16 else "prefill_simt"


def form_launches() -> dict:
    """Launches of each form of ``FORMS`` since the last
    ``registry.reset_launch_counts``."""
    return {f: _build.launch_count(f"{KERNEL}:{f}") for f in FORMS}


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
    form = prefill_form(q.dtype)
    if form == "prefill_mma":
        _checks.mma_aligned(KERNEL, q=q, k=k, v=v)
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
                      int(causal), window or 0, 1.0 / math.sqrt(D), stream,
                      form=form)
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
                      *_strides(v_cache), 1.0 / math.sqrt(D), stream,
                      form="decode")
    return out


def mma_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The tensor-core form's raw scores q . k^T, unscaled and unmasked,
    as f32 (B, H, Sq, Skv): its QK^T fragments alone, for a card test.
    bf16 CUDA operands only; counted under ``flash_mma_scores``, not as a
    launch of K4."""
    if q.dtype != torch.bfloat16 or q.device.type != "cuda":
        raise ValueError("mma_scores takes bf16 CUDA operands")
    _checks.attention(KERNEL, q, k, k)
    _checks.mma_aligned(KERNEL, q=q, k=k)
    B, Sq, H, D = q.shape
    _, Skv, Hkv, _ = k.shape
    out = torch.empty((B, H, Sq, Skv), dtype=torch.float32, device=q.device)
    fn = _build.function("flash_attn", "flash_mma_scores_launch",
                         _SCORES_ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("flash_mma_scores", fn, out.data_ptr(), q.data_ptr(),
                      k.data_ptr(), B, H, Hkv, D, Sq, Skv, *_strides(q),
                      *_strides(k), stream)
    return out
