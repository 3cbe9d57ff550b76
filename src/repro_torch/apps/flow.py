"""FLOW (paper §7): dense Lucas-Kanade optical flow on an image pair.

Gradients + 8x8 window second-moment sums + a small 2x2 linear solve per
pixel, using HardFloat-analog float ops with a data-dependent-latency
divider (which forces the pipeline to a Stream interface, §2.3).
"""
from __future__ import annotations

import numpy as np

from ..core import (AddAsync, AddMSBs, Array2d, Concat, Const, FloatDiv,
                    FloatMul, FloatSub, Int, Map, Mul, Reduce, Stencil,
                    Sub, ToFloat, TupleT, UInt, UserFunction)

W, H = 1920, 1080
WIN = 8

SOBEL_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], dtype=np.int64)
SOBEL_Y = SOBEL_X.T.copy()


class Flow(UserFunction):
    def __init__(self, w: int = W, h: int = H):
        img = Array2d(UInt(8), w, h)
        super().__init__("flow", TupleT((img, img)))
        self.w, self.h = w, h

    def define(self, inp):
        i1, i2 = inp[0], inp[1]
        g = Stencil(-1, 1, -1, 1)(i1)                      # 3x3 patches
        cx = Const(Array2d(Int(8), 3, 3), SOBEL_X)
        cy = Const(Array2d(Int(8), 3, 3), SOBEL_Y)
        ix = Reduce(AddAsync)(Map(Mul)(g, cx))             # i16 gradient
        iy = Reduce(AddAsync)(Map(Mul)(g, cy))
        it = Map(Sub)(i2, i1)                              # i9 temporal

        def winsum(x):
            st = Stencil(-(WIN - 1), 0, -(WIN - 1), 0)(x)
            return Reduce(AddAsync)(Map(AddMSBs(16))(st))

        sxx = winsum(Map(Mul)(ix, ix))
        sxy = winsum(Map(Mul)(ix, iy))
        syy = winsum(Map(Mul)(iy, iy))
        sxt = winsum(Map(Mul)(ix, it))
        syt = winsum(Map(Mul)(iy, it))

        a11, a12, a22 = Map(ToFloat)(sxx), Map(ToFloat)(sxy), Map(ToFloat)(syy)
        b1, b2 = Map(ToFloat)(sxt), Map(ToFloat)(syt)
        det = Map(FloatSub)(Map(FloatMul)(a11, a22), Map(FloatMul)(a12, a12))
        # A [u v]^T = -[b1 b2]^T  =>  u = (A12 b2 - A22 b1)/det, ...
        nu = Map(FloatSub)(Map(FloatMul)(a12, b2), Map(FloatMul)(a22, b1))
        nv = Map(FloatSub)(Map(FloatMul)(a12, b1), Map(FloatMul)(a11, b2))
        u = Map(FloatDiv)(nu, det)                         # Stream: div L is
        v = Map(FloatDiv)(nv, det)                         # data-dependent
        return Concat(u, v)


def bench_case(w: int = 48, h: int = 24):
    """Small instance + random inputs (see convolution.bench_case)."""
    uf = Flow(w=w, h=h)

    def inputs(rng, frames=None):
        shape = (h, w) if frames is None else (frames, h, w)
        i1 = rng.randint(0, 256, shape).astype(np.int64)
        i2 = np.roll(i1, 1, axis=-1)
        return {"flow.in": (i1, i2)}

    return uf, inputs


def golden_flow(i1: np.ndarray, i2: np.ndarray):
    h, w = i1.shape
    f32 = np.float32

    def grad(img, k):
        ext = np.zeros((h + 2, w + 2), dtype=np.int64)
        ext[1:1 + h, 1:1 + w] = img  # 3x3 window centered: offsets -1..1
        win = np.lib.stride_tricks.sliding_window_view(ext, (3, 3))
        g = np.einsum("hwij,ij->hw", win, k)
        # executor wraps Mul products to i16 and sums at i16
        return ((g + 2 ** 15) % 2 ** 16) - 2 ** 15

    ix, iy = grad(i1, SOBEL_X), grad(i1, SOBEL_Y)
    it = i2.astype(np.int64) - i1.astype(np.int64)

    def winsum(x):
        ext = np.zeros((h + WIN - 1, w + WIN - 1), dtype=np.int64)
        ext[WIN - 1:, WIN - 1:] = x
        win = np.lib.stride_tricks.sliding_window_view(ext, (WIN, WIN))
        return win.sum(axis=(-2, -1))

    def wrap32(x):
        return ((x + 2 ** 31) % 2 ** 32) - 2 ** 31

    sxx, sxy, syy = (winsum(wrap32(ix * ix)), winsum(wrap32(ix * iy)),
                     winsum(wrap32(iy * iy)))
    sxt, syt = winsum(wrap32(ix * it)), winsum(wrap32(iy * it))
    a11, a12, a22 = f32(sxx), f32(sxy), f32(syy)
    b1, b2 = f32(sxt), f32(syt)
    det = f32(f32(a11 * a22) - f32(a12 * a12))
    nu = f32(f32(a12 * b2) - f32(a22 * b1))
    nv = f32(f32(a12 * b1) - f32(a11 * b2))
    u = np.where(det != 0, nu / np.where(det == 0, 1, det), 0).astype(f32)
    v = np.where(det != 0, nv / np.where(det == 0, 1, det), 0).astype(f32)
    return u, v


# FLOW's modules are all smooth-rate (stencils + float maps): nothing for
# the hand annotation to zero — the solver's slack is the whole story
HAND_FIFO = {}

# design-space axes for the explorer: FLOW compiles cleanly down the lane
# ladder (the float datapath duplicates per lane, so T=1 vs 1/4 is a real
# area/throughput trade)
EXPLORE = {
    "t_ladder": ("1", "1/2", "1/4"),
    "solvers": ("lp", "asap"),
    "scales": (0.5, 0.75, 1.25),
    "jitter": 4,
}


def sim_case(w: int = 48, h: int = 24):
    """Small instance + target throughput + hand FIFO annotations for the
    cycle simulator (see convolution.sim_case)."""
    from fractions import Fraction
    return Flow(w=w, h=h), Fraction(1), HAND_FIFO
