"""DESCRIPTOR (paper §7): simplified sparse HoG-style feature descriptor.

Exercises the two key HWTool features the paper calls out: (1) sparse,
bursty, data-dependent streams (Filter at Harris corner points, with a
user-annotated worst-case burst, §4.3), and (2) imported float hardware with
data-dependent latency (HardFloat-analog divide / sqrt).
"""
from __future__ import annotations

import numpy as np

from ..core import (AddAsync, AddMSBs, Array2d, Const, Filter, Float,
                    FloatAdd, FloatDiv, FloatMul, FloatSqrt, FloatSub,
                    Gt, Int, Map, Mul, Reduce, SparseTake, Stack, Stencil,
                    ToFloat, UInt, UserFunction)
from .flow import SOBEL_X, SOBEL_Y

W, H = 1920, 1080
WIN = 4
N_FEATURES = 1024
FILTER_BURST = 2048      # paper §7.3: "set at 2048 by the user"
HARRIS_K = np.float32(0.0625)
THRESH = np.float32(1.0e8)


class Descriptor(UserFunction):
    def __init__(self, w: int = W, h: int = H,
                 n_features: int = N_FEATURES,
                 filter_burst: int = FILTER_BURST):
        super().__init__("descriptor", Array2d(UInt(8), w, h))
        self.w, self.h = w, h
        self.n_features = n_features
        self.filter_burst = filter_burst

    def define(self, inp):
        g = Stencil(-1, 1, -1, 1)(inp)
        cx = Const(Array2d(Int(8), 3, 3), SOBEL_X)
        cy = Const(Array2d(Int(8), 3, 3), SOBEL_Y)
        ix = Reduce(AddAsync)(Map(Mul)(g, cx))
        iy = Reduce(AddAsync)(Map(Mul)(g, cy))

        def winsum(x):
            st = Stencil(-(WIN - 1), 0, -(WIN - 1), 0)(x)
            return Reduce(AddAsync)(Map(AddMSBs(16))(st))

        sxx = winsum(Map(Mul)(ix, ix))
        sxy = winsum(Map(Mul)(ix, iy))
        syy = winsum(Map(Mul)(iy, iy))

        fxx, fxy, fyy = Map(ToFloat)(sxx), Map(ToFloat)(sxy), Map(ToFloat)(syy)
        det = Map(FloatSub)(Map(FloatMul)(fxx, fyy), Map(FloatMul)(fxy, fxy))
        tr = Map(FloatAdd)(fxx, fyy)
        k = Const(Float(8, 24), HARRIS_K)
        score = Map(FloatSub)(det, Map(FloatMul)(Map(FloatMul)(tr, tr), k))
        mask = Map(Gt)(score, Const(Float(8, 24), THRESH))

        # descriptor = (Sxx, Syy, Sxy, tr) normalized by sqrt(tr)+1 — the
        # high-dynamic-range float normalize of the paper's HoG variant
        norm = Map(FloatAdd)(Map(FloatSqrt)(tr), Const(Float(8, 24),
                                                       np.float32(1.0)))
        d = Stack(Map(FloatDiv)(fxx, norm), Map(FloatDiv)(fyy, norm),
                  Map(FloatDiv)(fxy, norm), Map(FloatDiv)(tr, norm))
        sparse = Filter(d, mask, expected_burst=self.filter_burst)
        return SparseTake(sparse, self.n_features)


def bench_case(w: int = 64, h: int = 48, n_features: int = 32):
    """Small instance + random inputs (see convolution.bench_case)."""
    uf = Descriptor(w=w, h=h, n_features=n_features)

    def inputs(rng, frames=None):
        shape = (h, w) if frames is None else (frames, h, w)
        return {"descriptor.in": rng.randint(0, 256, shape).astype(np.int64)}

    return uf, inputs


def golden_descriptor(img: np.ndarray, n_features: int = N_FEATURES):
    h, w = img.shape
    f32 = np.float32

    def grad(image, kk):
        ext = np.zeros((h + 2, w + 2), dtype=np.int64)
        ext[1:1 + h, 1:1 + w] = image
        win = np.lib.stride_tricks.sliding_window_view(ext, (3, 3))
        g = np.einsum("hwij,ij->hw", win, kk)
        return ((g + 2 ** 15) % 2 ** 16) - 2 ** 15

    ix, iy = grad(img, SOBEL_X), grad(img, SOBEL_Y)

    def wrap32(x):
        return ((x + 2 ** 31) % 2 ** 32) - 2 ** 31

    def winsum(x):
        ext = np.zeros((h + WIN - 1, w + WIN - 1), dtype=np.int64)
        ext[WIN - 1:, WIN - 1:] = x
        win = np.lib.stride_tricks.sliding_window_view(ext, (WIN, WIN))
        return win.sum(axis=(-2, -1))

    sxx, sxy, syy = (winsum(wrap32(ix * ix)), winsum(wrap32(ix * iy)),
                     winsum(wrap32(iy * iy)))
    fxx, fxy, fyy = f32(sxx), f32(sxy), f32(syy)
    det = f32(f32(fxx * fyy) - f32(fxy * fxy))
    tr = f32(fxx + fyy)
    score = f32(det - f32(f32(tr * tr) * HARRIS_K))
    mask = score > THRESH
    norm = f32(np.sqrt(np.maximum(tr, 0)).astype(f32) + f32(1.0))

    def fdiv(a):
        return np.where(norm != 0, a / np.where(norm == 0, 1, norm),
                        0).astype(f32)

    d = np.stack([fdiv(fxx), fdiv(fyy), fdiv(fxy), fdiv(tr)], axis=-1)
    flat_d = d.reshape(-1, 4)
    flat_m = mask.reshape(-1)
    idx = np.nonzero(flat_m)[0][:n_features]
    out_v = np.zeros((n_features, 4), dtype=f32)
    out_i = np.zeros((n_features,), dtype=np.int64)
    out_v[: len(idx)] = flat_d[idx]
    out_i[: len(idx)] = idx
    return out_v, out_i


# the hand annotation keeps the user-sized Filter FIFO (paper §7.3) but
# zeroes SparseTake's output burst slack — the AXI DMA sink absorbs it
HAND_FIFO = {"sparse_take": 0}

# design-space axes for the explorer: DESCRIPTOR's sparse back half only
# rate-matches at low T, so the ladder stays below the sim_case's T=1/4
EXPLORE = {
    "t_ladder": ("1/4", "1/8"),
    "solvers": ("lp", "asap"),
    "scales": (0.5, 0.75, 1.25),
    "jitter": 4,
}


def sim_case(w: int = 64, h: int = 48, n_features: int = 32,
             filter_burst: int = 256):
    """Small instance + target throughput + hand FIFO annotations for the
    cycle simulator (see convolution.sim_case). ``filter_burst`` scales the
    user's worst-case corner-burst bound down with the frame."""
    from fractions import Fraction
    return (Descriptor(w=w, h=h, n_features=n_features,
                       filter_burst=filter_burst),
            Fraction(1, 4), HAND_FIFO)
