"""Wrapper of the SAD CUDA kernel (K2) and its HWImg-site adapter.

A CUDA tensor launches ``csrc/sad.cu`` (or raises); a CPU tensor takes the
plain version in ref.py; any other device raises.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build, _checks
from .ref import sad_ref

_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 8 + (ctypes.c_void_p,)


def sad_disparity(l: torch.Tensor, r: torch.Tensor, *, nd: int = 64,
                  bh: int = 8, bw: int = 8) -> torch.Tensor:
    """Best-match disparity per pixel (see ref.py contract).

    l, r: (N, H + bh - 1, W + bw - 1 + nd - 1) int32 on one device.
    Returns (N, H, W) int32; one launch for all N frames.
    """
    _checks.int32_tensor("l", l, 3)
    _checks.int32_tensor("r", r, 3)
    if l.shape != r.shape:
        raise ValueError(f"sad: l {tuple(l.shape)} and r {tuple(r.shape)} "
                         f"differ")
    if min(nd, bh, bw) < 1:
        raise ValueError(f"sad: nd={nd}, bh={bh}, bw={bw} must be >= 1")
    n, hp, wp = l.shape
    h, w = hp - bh + 1, wp - bw + 1 - (nd - 1)
    if h < 1 or w < 1:
        raise ValueError(f"sad: planes {tuple(l.shape)} are too small for "
                         f"nd={nd} and {bh}x{bw} blocks")
    if _checks.route("sad", l, r) == "cpu":
        return sad_ref(l, r, nd=nd, bh=bh, bw=bw)
    out = torch.empty((n, h, w), dtype=torch.int32, device=l.device)
    if n == 0:
        return out
    fn = _build.function("sad", "sad_launch", _ARGTYPES)
    with torch.cuda.device(l.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("sad", fn, out.data_ptr(), l.data_ptr(), r.data_ptr(),
                      n, h, w, hp, wp, nd, bh, bw, stream)
    return out


def sad_hwimg_site(left: torch.Tensor, right: torch.Tensor, *, nd: int,
                   bh: int, bw: int) -> torch.Tensor:
    """HWImg-site adapter (registry fusion ``sad``): implements the fused
    Stencil(-(nd-1),0,0,0) -> Map(AbsDiff)(Replicate(left), .) ->
    Stencil(-(bw-1),0,-(bh-1),0) -> ReducePatch(Add) -> ArgMin subgraph on
    (N, h, w) frame pairs (trailing-window STEREO form).

    Both images are placed at row offset bh-1 / column offset nd-1+bw-1 in
    zero-extended int32 planes, which makes the kernel's tap reads
    reproduce the executor's per-level zero-fill exactly (out-of-range
    candidate reads hit zeros, out-of-range patch taps read |0-0|).
    """
    left, right = torch.broadcast_tensors(left, right)
    n, h, w = left.shape
    shape = (n, h + bh - 1, w + bw - 1 + nd - 1)
    planes = []
    for img in (left, right):
        plane = torch.zeros(shape, dtype=torch.int32, device=img.device)
        plane[:, bh - 1:, nd - 1 + bw - 1:] = img
        planes.append(plane)
    return sad_disparity(planes[0], planes[1], nd=nd, bh=bh, bw=bw)
