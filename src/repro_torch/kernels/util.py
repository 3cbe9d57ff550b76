"""Shared helpers for HWImg-site kernel adapters."""
from __future__ import annotations

import torch


def shift2d(x: torch.Tensor, top: int, left: int, oh: int, ow: int
            ) -> torch.Tensor:
    """out[:, i, j] = x[:, i + top, j + left], zero-filled outside x.

    ``x`` carries a leading frame axis.  This is the zero-fill placement of
    the executor's stencil: a tap at window offset (dy, dx) of a
    Stencil(l, r, b, t) site reads x[y + b + dy, x + l + dx], so a
    pre-shifted plane with top=b, left=l turns arbitrary window offsets
    into the kernels' 0..k-1 tap loops.
    """
    n, h, w = x.shape[:3]
    out = x.new_zeros((n, oh, ow) + tuple(x.shape[3:]))
    i0, i1 = max(0, -top), min(oh, h - top)
    j0, j1 = max(0, -left), min(ow, w - left)
    if i0 < i1 and j0 < j1:
        out[:, i0:i1, j0:j1] = x[:, i0 + top:i1 + top, j0 + left:j1 + left]
    return out
