"""PYRAMID: a two-level residual pyramid (beyond the paper's four apps).

Exercises the lowering compiler's algebraic rewrite rules: the Downsample
and Upsample chains collapse to single combined-stride nodes
(``pyramid_down_down`` / ``pyramid_up_up``), and the residual is the
pixelwise |x - reconstruct(x)| — a Laplacian-pyramid-style detail band.
"""
from __future__ import annotations

import numpy as np

from ..core import (AbsDiff, Array2d, Downsample, Map, UInt, Upsample,
                    UserFunction)

W, H = 1920, 1080


class Pyramid(UserFunction):
    def __init__(self, w: int = W, h: int = H, levels: int = 2):
        super().__init__("pyramid", Array2d(UInt(8), w, h))
        self.w, self.h, self.levels = w, h, levels

    def define(self, inp):
        coarse = inp
        for _ in range(self.levels):          # collapses to Downsample(2^L)
            coarse = Downsample(2, 2)(coarse)
        recon = coarse
        for _ in range(self.levels):          # collapses to Upsample(2^L)
            recon = Upsample(2, 2)(recon)
        return Map(AbsDiff)(inp, recon)


def bench_case(w: int = 96, h: int = 64, levels: int = 2):
    """Small instance + random inputs (see convolution.bench_case)."""
    uf = Pyramid(w=w, h=h, levels=levels)

    def inputs(rng, frames=None):
        shape = (h, w) if frames is None else (frames, h, w)
        return {"pyramid.in": rng.randint(0, 256, shape).astype(np.int64)}

    return uf, inputs


def golden_pyramid(img: np.ndarray, levels: int = 2) -> np.ndarray:
    s = 2 ** levels
    coarse = img[::s, ::s]
    recon = np.repeat(np.repeat(coarse, s, axis=0), s, axis=1)
    return np.abs(img.astype(np.int64) - recon.astype(np.int64))


# the hand annotation zeroes the DMA-absorbed Downsample bursts (the same
# reasoning as convolution's pad/crop)
HAND_FIFO = {"downsample": 0}

# design-space axes for the explorer: PYRAMID's analytic depths already
# under-provision the reconvergent diamond (scaled-down variants deadlock,
# which the sweep should see), so the scale axis leans upward
EXPLORE = {
    "t_ladder": ("1", "1/2"),
    "solvers": ("lp", "asap"),
    "scales": (0.75, 1.25, 1.5),
    "jitter": 4,
}


def sim_case(w: int = 64, h: int = 32, levels: int = 2):
    """Small instance + target throughput + hand FIFO annotations for the
    cycle simulator (see convolution.sim_case)."""
    from fractions import Fraction
    return Pyramid(w=w, h=h, levels=levels), Fraction(1), HAND_FIFO
