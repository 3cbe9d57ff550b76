"""STEREO (paper §7): 8x8 block matching over 64 disparities, SAD cost,
on a 720x400 image pair. Returns the argmin disparity per pixel.
"""
from __future__ import annotations

import numpy as np

from ..core import (AbsDiff, AddAsync, AddMSBs, ArgMin, Array2d, Map,
                    ReducePatch, Replicate, Stencil, TupleT, UInt,
                    UserFunction)

W, H = 720, 400
ND = 64          # disparities
BW, BH = 8, 8    # block size


class Stereo(UserFunction):
    def __init__(self, w: int = W, h: int = H, nd: int = ND):
        img = Array2d(UInt(8), w, h)
        super().__init__("stereo", TupleT((img, img)))
        self.w, self.h, self.nd = w, h, nd

    def define(self, inp):
        left, right = inp[0], inp[1]
        # 64 horizontal candidates per right pixel: offsets -63..0
        cand = Stencil(-(self.nd - 1), 0, 0, 0)(right)    # (h,w,1,nd)
        left_b = Replicate(self.nd, 1)(left)              # broadcast wires
        diff = Map(AbsDiff)(left_b, cand)                 # u8 per (px, d)
        wide = Map(AddMSBs(8))(diff)                      # u16 accumulators
        # SAD over the 8x8 block for every disparity lane
        patches = Stencil(-(BW - 1), 0, -(BH - 1), 0)(wide)   # (h,w,8,8,1,nd)
        sad = ReducePatch(AddAsync)(patches)              # (h,w,1,nd) u16
        return ArgMin(sad)                                # disparity index u6


def bench_case(w: int = 64, h: int = 24, nd: int = 8):
    """Small instance + random-input builder (see convolution.bench_case)."""
    uf = Stereo(w=w, h=h, nd=nd)

    def inputs(rng, frames=None):
        shape = (h, w) if frames is None else (frames, h, w)
        left = rng.randint(0, 256, shape).astype(np.int64)
        right = np.roll(left, 3, axis=-1)
        return {"stereo.in": (left, right)}

    return uf, inputs


def golden_stereo(left: np.ndarray, right: np.ndarray, nd: int = ND
                  ) -> np.ndarray:
    h, w = left.shape
    # candidates: cand[y, x, d] = right[y, x - (nd-1) + d], zero out of range
    ext = np.zeros((h, w + nd - 1), dtype=np.int64)
    ext[:, nd - 1:] = right
    cand = np.lib.stride_tricks.sliding_window_view(ext, nd, axis=1)  # (h,w,nd)
    diff = np.abs(left[:, :, None].astype(np.int64) - cand)
    # 8x8 block sums with the same zero-extension as Stencil(-7,0,-7,0)
    ext2 = np.zeros((h + BH - 1, w + BW - 1, nd), dtype=np.int64)
    ext2[BH - 1:, BW - 1:] = diff
    win = np.lib.stride_tricks.sliding_window_view(ext2, (BH, BW), axis=(0, 1))
    sad = win.sum(axis=(-2, -1)) & 0xFFFF                 # u16 wrap
    return np.argmin(sad, axis=-1)


# STEREO has no bursty border/sparse modules: the hand-tuned allocation
# annotates nothing, so auto-vs-hand differs only by what the solver adds
HAND_FIFO = {}

# design-space axes for the explorer: the ladder starts at the sim_case
# target T=1/2 (the ArgMin reduction tree can't sustain T=1 at these sizes)
EXPLORE = {
    "t_ladder": ("1/2", "1/4", "1/8"),
    "solvers": ("lp", "asap"),
    "scales": (0.5, 0.75, 1.25),
    "jitter": 4,
}


def sim_case(w: int = 64, h: int = 24, nd: int = 8):
    """Small instance + target throughput + hand FIFO annotations for the
    cycle simulator (see convolution.sim_case)."""
    from fractions import Fraction
    return Stereo(w=w, h=h, nd=nd), Fraction(1, 2), HAND_FIFO
