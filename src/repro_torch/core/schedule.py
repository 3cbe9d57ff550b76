"""Schedule traces and the burst model (paper §4.2-4.3).

Every module's token production is modeled by the parameterized trace

    F_L(t) = max(ceil((t - L + 1) * R), 0)

with rate 0 < R <= 1 and latency L >= 0. Shifting by a start offset s gives
F_s(t) = F(t - s). Bursty modules are characterized by the maximum excess
B = max_t (F_actual(t) - F_model(t)); a FIFO of B extra slots absorbs the
burst and makes the module look like its model from outside (fig. 5).

The paper notes the most convenient way to get (L, B) for an irregular module
is to simulate its cycle behavior and fit the model — ``fit_LB`` does exactly
that.
"""
from __future__ import annotations

from fractions import Fraction
from typing import Tuple

import numpy as np


def trace(R: Fraction, L: int, s: int, t: np.ndarray) -> np.ndarray:
    """F_{s+L}(t): cumulative tokens produced by cycle t (vectorized)."""
    num, den = R.numerator, R.denominator
    tt = t.astype(np.int64) - (s + L) + 1
    # ceil(tt * num / den) without float error
    v = -((-tt * num) // den)
    return np.maximum(v, 0)


def consumption_trace(R: Fraction, s: int, t: np.ndarray) -> np.ndarray:
    """F_s(t): cumulative tokens consumed by cycle t."""
    return trace(R, 0, s, t)


def finish_cycle(R: Fraction, L: int, s: int, n_tokens: int) -> int:
    """First cycle t with F_{s+L}(t) >= n_tokens.

    ceil((t-s-L+1)*R) >= n  <=>  t-s-L >= floor((n-1)/R)."""
    tt = (n_tokens - 1) * R.denominator // R.numerator
    return s + L + tt


def fit_LB(actual: np.ndarray, R: Fraction) -> Tuple[int, int]:
    """Fit the paper's (L, B) to a simulated cumulative token trace.

    Picks the largest L such that the model trace never exceeds the actual
    trace (the module is never asked for a token it has not produced), then
    B = max excess of actual over model (fig. 5.2). Returns (L, B).
    """
    t = np.arange(len(actual), dtype=np.int64)
    # find smallest L >= 0 with model <= actual everywhere
    lo, hi = 0, len(actual) + 1
    while lo < hi:
        mid = (lo + hi) // 2
        if np.all(trace(R, mid, 0, t) <= actual):
            hi = mid
        else:
            lo = mid + 1
    L = lo
    model = trace(R, L, 0, t)
    B = int(np.max(actual - model))
    return L, B


# --------------------------------------------------------------------------
# analytic burst traces for the bursty built-ins (used by the mapper and by
# the cycle simulator's consumption->production profiles, hwsim/)


def invert_trace(cum: np.ndarray) -> np.ndarray:
    """Invert a cumulative production trace: ``need[j-1]`` is the smallest
    input count i (1-based) with ``cum[i-1] >= j``, for j = 1..cum[-1] —
    i.e. how many input tokens must have arrived before output j can exist.
    The hwsim simulator uses this to drive Crop/Downsample consumption."""
    total = int(cum[-1])
    return (np.searchsorted(cum, np.arange(1, total + 1, dtype=np.int64),
                            side="left") + 1).astype(np.int64)


def pad_need_trace(w: int, h: int, l: int, r: int, b: int, t: int
                   ) -> np.ndarray:
    """Input pixels required (cumulative, inclusive) before each padded
    output pixel can be emitted, row-major over the padded image. Border
    pixels are generated inline (need only what is already consumed);
    interior pixel j needs its own input token. Matches the executor's
    orientation: the image lands at rows t..t+h, cols l..l+w."""
    pw, ph = w + l + r, h + b + t
    y, x = np.mgrid[0:ph, 0:pw]
    interior = (y >= t) & (y < t + h) & (x >= l) & (x < l + w)
    return np.cumsum(interior.ravel()).astype(np.int64)


def pad_trace(w: int, h: int, l: int, r: int, b: int, t: int) -> np.ndarray:
    """Cumulative output tokens of a Pad per output cycle. After SDF rate
    normalization the pad's output is the pipeline's rate-1 bottleneck and
    it emits one token every cycle (border tokens are generated inline while
    the input stalls), so the trace is smooth: pads are not output-bursty,
    they apply back-pressure bursts *upstream*, which the SDF normalization
    already accounts for."""
    total = (w + l + r) * (h + b + t)
    return np.arange(1, total + 1, dtype=np.int64)


def crop_trace(w: int, h: int, l: int, r: int, b: int, t: int) -> np.ndarray:
    """Cumulative output tokens of a Crop per input cycle (consumes one token
    per cycle, produces only inside the kept region)."""
    out = []
    total = 0
    for y in range(h):
        for x in range(w):
            keep = (l <= x < w - r) and (t <= y < h - b)
            if keep:
                total += 1
            out.append(total)
    return np.asarray(out, dtype=np.int64)


def downsample_trace(w: int, h: int, sx: int, sy: int) -> np.ndarray:
    out = []
    total = 0
    for y in range(h):
        for x in range(w):
            if x % sx == 0 and y % sy == 0:
                total += 1
            out.append(total)
    return np.asarray(out, dtype=np.int64)
