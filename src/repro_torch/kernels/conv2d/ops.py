"""Wrapper of the conv2d CUDA kernel (K1) and its HWImg-site adapter.

A CUDA tensor launches ``csrc/conv2d.cu`` (or raises); a CPU tensor takes
the plain version in ref.py; any other device raises.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build, _checks
from ..util import shift2d
from .ref import conv2d_ref

_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 8 + (ctypes.c_void_p,)


def conv2d_stencil(p: torch.Tensor, k: torch.Tensor, shift: int = 11
                   ) -> torch.Tensor:
    """'Valid' convolution on pre-padded frames (see ref.py contract).

    p: (N, H + kh - 1, W + kw - 1) int32; k: (kh, kw) int32 on p's device.
    Returns (N, H, W) int32 == (conv >> shift) & 0xFF; one launch for all
    N frames.
    """
    _checks.int32_tensor("p", p, 3)
    _checks.int32_tensor("k", k, 2)
    if shift < 0:
        raise ValueError(f"conv2d: negative shift {shift}")
    n, hp, wp = p.shape
    kh, kw = k.shape
    h, w = hp - kh + 1, wp - kw + 1
    if h < 1 or w < 1:
        raise ValueError(f"conv2d: plane {tuple(p.shape)} is smaller than "
                         f"the {kh}x{kw} taps")
    if _checks.route("conv2d", p, k) == "cpu":
        return conv2d_ref(p, k, shift)
    out = torch.empty((n, h, w), dtype=torch.int32, device=p.device)
    if n == 0:
        return out
    fn = _build.function("conv2d", "conv2d_launch", _ARGTYPES)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("conv2d", fn, out.data_ptr(), p.data_ptr(),
                      k.data_ptr(), n, h, w, hp, wp, kh, kw, shift, stream)
    return out


def conv2d_hwimg_site(x: torch.Tensor, k: torch.Tensor, *, l: int, b: int,
                      shift: int) -> torch.Tensor:
    """HWImg-site adapter (registry fusion ``conv2d``): implements the fused
    Stencil(l,r,b,t) -> Map(Mul)(., Const(k)) -> Reduce(Add) -> Rshift ->
    RemoveMSBs(->u8) subgraph on (N, h, w) frames.

    The stencil's window offsets are realized by zero-fill pre-shifting
    (the executor's stencil semantics); the kernel then runs its
    0..kh-1 / 0..kw-1 tap loops on the shifted int32 planes.  The rule's
    guard proves every value fits int32.
    """
    kh, kw = k.shape
    h, w = x.shape[1:3]
    p = shift2d(x.to(torch.int32), b, l, h + kh - 1, w + kw - 1)
    return conv2d_stencil(p, k, shift=shift)
