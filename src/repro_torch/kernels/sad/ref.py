"""Plain PyTorch version of the SAD block-matching kernel (K2, csrc/sad.cu).

Contract: inputs are zero-extended so every window/disparity read is in
range. For output pixel (n, y, x):
    sad[d] = sum_{dy<bh, dx<bw} |L[n, y+dy, x+dx+nd-1] - R[n, y+dy, x+dx+d]|
    out[n, y, x] = argmin_d sad[d]      (first minimum wins)
with L, R of shape (N, H + bh - 1, W + bw - 1 + nd - 1) int32, out (N, H, W).
The left image is read at horizontal offset nd-1 (disparity 0 aligns with
d = nd-1; d < nd-1 looks left by (nd-1-d)).  Arithmetic wraps as int32.
"""
from __future__ import annotations

import torch


def sad_ref(l: torch.Tensor, r: torch.Tensor, *, nd: int, bh: int, bw: int
            ) -> torch.Tensor:
    n = l.shape[0]
    h = l.shape[1] - bh + 1
    w = l.shape[2] - bw + 1 - (nd - 1)
    best = torch.full((n, h, w), torch.iinfo(torch.int32).max,
                      dtype=torch.int32, device=l.device)
    best_d = torch.zeros((n, h, w), dtype=torch.int32, device=l.device)
    for d in range(nd):
        acc = torch.zeros((n, h, w), dtype=torch.int32, device=l.device)
        for dy in range(bh):
            for dx in range(bw):
                lw = l[:, dy:dy + h, nd - 1 + dx:nd - 1 + dx + w]
                rw = r[:, dy:dy + h, d + dx:d + dx + w]
                acc += torch.abs(lw - rw)
        take = acc < best
        best = torch.where(take, acc, best)
        best_d = torch.where(take, d, best_d)
    return best_d
