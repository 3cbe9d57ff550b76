"""Plain PyTorch version of the conv2d kernel (K1, csrc/conv2d.cu).

Contract ("valid" convolution on pre-padded frames):
    out[n, y, x] = ((sum_{dy,dx} P[n, y+dy, x+dx] * K[dy, dx]) >> shift) & 0xFF
with P of shape (N, H + KH - 1, W + KW - 1) int32, K (KH, KW) int32 and out
(N, H, W) int32.  Sums wrap as int32; a shift of 31 or more yields the sign
fill, as the kernel's clamped shift does.
"""
from __future__ import annotations

import torch


def conv2d_ref(p: torch.Tensor, k: torch.Tensor, shift: int = 11
               ) -> torch.Tensor:
    kh, kw = k.shape
    h = p.shape[1] - kh + 1
    w = p.shape[2] - kw + 1
    acc = torch.zeros((p.shape[0], h, w), dtype=torch.int32, device=p.device)
    for dy in range(kh):
        for dx in range(kw):
            acc += k[dy, dx] * p[:, dy:dy + h, dx:dx + w]
    return (acc >> min(shift, 31)) & 0xFF
