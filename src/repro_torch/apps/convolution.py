"""CONVOLUTION (paper §7, fig. 1): 8x8 convolution on a 1080p image.

"Our simplest pipeline, but a challenging test of hardware quality: it does
relatively little compute compared to the other tests, so any unnecessary
hardware overhead produced by the compiler will be apparent."
"""
from __future__ import annotations

from fractions import Fraction

import numpy as np

from ..core import (AddAsync, AddMSBs, Array2d, Const, Crop, Map, Mul, Pad,
                    Reduce, RemoveMSBs, Rshift, Stencil, UInt, UserFunction)

W, H = 1920, 1080
KW, KH = 8, 8
SHIFT = 11


def default_kernel() -> np.ndarray:
    """A fixed 8x8 blur-ish kernel with sum < 2**SHIFT (RegCoeffs analog)."""
    rng = np.random.RandomState(0)
    k = rng.randint(1, 64, size=(KH, KW)).astype(np.int64)
    k = (k * (2 ** SHIFT - 1) // max(1, k.sum())).astype(np.int64)
    return np.clip(k, 0, 255)


def separable_kernel() -> np.ndarray:
    """A rank-1 (tent x tent) 8x8 kernel with sum < 2**SHIFT: triggers the
    lowering compiler's separable-filter split on the torch backend."""
    tent = np.array([1, 2, 3, 4, 4, 3, 2, 1], dtype=np.int64)
    k = np.outer(tent, tent)
    if k.sum() >= 2 ** SHIFT:
        raise AssertionError(f"separable kernel sum {k.sum()} >= 2**{SHIFT}")
    return k


class Convolution(UserFunction):
    """Paper fig. 1 (ConvTop/ConvInner), Python-flavored HWImg."""

    def __init__(self, w: int = W, h: int = H, kernel: np.ndarray = None):
        super().__init__("convolution", Array2d(UInt(8), w, h))
        self.kernel = default_kernel() if kernel is None else kernel
        self.w, self.h = w, h

    def define(self, inp):
        pad = Pad(8, 8, 4, 4)(inp)
        stencils = Stencil(-7, 0, -7, 0)(pad)
        coeff = Const(Array2d(UInt(8), KW, KH), self.kernel)
        products = Map(Mul)(stencils, coeff)              # u8*u8 -> u16
        widened = Map(AddMSBs(16))(products)              # u32 accumulators
        sums = Reduce(AddAsync)(widened)                  # 64-tap adder tree
        shifted = Map(Rshift(SHIFT))(sums)
        narrowed = Map(RemoveMSBs(24))(shifted)           # back to u8
        return Crop(12, 4, 8, 0)(narrowed)


def bench_case(w: int = 96, h: int = 40):
    """Small instance + random-input builder: the uniform app surface used
    by the cross-backend tests. ``inputs(rng)`` makes one frame;
    ``inputs(rng, frames=n)`` a batch for run_batch."""
    uf = Convolution(w=w, h=h)

    def inputs(rng, frames=None):
        shape = (h, w) if frames is None else (frames, h, w)
        return {"convolution.in": rng.randint(0, 256, shape).astype(np.int64)}

    return uf, inputs


def golden_convolution(img: np.ndarray, kernel: np.ndarray = None
                       ) -> np.ndarray:
    """Independent numpy reference (sliding windows, not the executor)."""
    kernel = default_kernel() if kernel is None else kernel
    h, w = img.shape
    # Pad(8,8,4,4): l=8, r=8, b=4, t=4
    padded = np.zeros((h + 8, w + 16), dtype=np.int64)
    padded[4:4 + h, 8:8 + w] = img
    ph, pw = padded.shape
    # Stencil(-7,0,-7,0): patch[y,x,dy,dx] = padded[y-7+dy, x-7+dx]
    ext = np.zeros((ph + 7, pw + 7), dtype=np.int64)
    ext[7:, 7:] = padded
    win = np.lib.stride_tricks.sliding_window_view(ext, (8, 8))  # (ph, pw, 8, 8)
    sums = np.einsum("hwij,ij->hw", win, kernel.astype(np.int64))
    shifted = sums >> SHIFT
    out8 = shifted & 0xFF
    # Crop(12,4,8,0): rows t..ph-b = 0..ph-8, cols l..pw-r = 12..pw-4
    return out8[0:ph - 8, 12:pw - 4]


# paper §7.2: the hand annotation zeroes the burst slack of the DMA-backed
# border modules (the AXI memory system absorbs their bursts)
HAND_FIFO = {"pad": 0, "crop": 0}

# design-space axes for the explorer
EXPLORE = {
    "t_ladder": ("1", "1/2", "1/4"),
    "solvers": ("lp", "asap"),
    "scales": (0.5, 0.75, 1.25),
    "jitter": 4,
}

# paper fig. 9: CONVOLUTION at 1920x1080 at each requested throughput ->
# (the paper's T, its cycles per frame); the T column is rounded to 2-3
# digits
PAPER_CONV = {
    Fraction(1, 8): (0.12, 16_851_000),
    Fraction(1, 4): (0.25, 8_425_000),
    Fraction(1, 2): (0.49, 4_213_000),
    Fraction(1): (0.98, 2_106_000),
    Fraction(2): (1.97, 1_053_000),
    Fraction(4): (3.94, 527_000),
    Fraction(8): (7.87, 263_000),
}


def sim_case(w: int = 96, h: int = 40):
    """Small instance + target throughput + hand FIFO annotations: the
    uniform surface for the cycle simulator (hwsim/ and
    tests/test_torch_hw.py)."""
    return Convolution(w=w, h=h), Fraction(1), HAND_FIFO
