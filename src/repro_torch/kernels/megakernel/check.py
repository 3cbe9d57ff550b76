"""Checks of K3 against its plain version, shared by ``chip_smoke.py`` and
the tests: leaf-wise comparison of a segment's outputs (integers exact,
f32 within ``FLOAT_ULP_BOUND`` ULPs), a synthetic pipeline over every op
the emitter streams, and probes of the point functions' integer edge
cases."""
from __future__ import annotations

import numpy as np
import torch

from ...core.lowering.megakernel import FLOAT_ULP_BOUND


def leaves(v):
    """The tensors of a (possibly nested) tuple of outputs, in order."""
    return [x for e in v for x in leaves(e)] if isinstance(v, (tuple, list)) \
        else [v]


def ulp_distance(a: torch.Tensor, b: torch.Tensor) -> int:
    """Max ULP distance of two float32 tensors (ordered bit patterns)."""
    def lex(x):
        u = x.contiguous().view(torch.int32).long()
        return torch.where(u >= 0, u, -(u & 0x7FFFFFFF))

    return int((lex(a) - lex(b)).abs().max().item()) if a.numel() else 0


def check_leaves(what: str, got, want, exact: bool) -> dict:
    """Kernel leaves against plain leaves: as many of them, integers and
    booleans exact, float32 within FLOAT_ULP_BOUND ULPs (exactly when
    ``exact``).  Raises on a difference; returns the max abs difference
    and the max ULP distance."""
    got, want = leaves(got), leaves(want)
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} output leaves, the plain "
                             f"version has {len(want)}")
    err, ulp = 0.0, 0
    for i, (g, w) in enumerate(zip(got, want)):
        w = w.expand_as(g)
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{what} leaf {i}: {tuple(g.shape)} "
                                 f"{g.dtype} vs {tuple(w.shape)} {w.dtype}")
        if g.dtype == torch.float32:
            if bool(torch.isnan(g).any() != torch.isnan(w).any()):
                raise AssertionError(f"{what} leaf {i}: NaN differs")
            d = ulp_distance(g, w)
            ulp = max(ulp, d)
            err = max(err, float((g - w).abs().max().item()) if g.numel()
                      else 0.0)
            if d > (0 if exact else FLOAT_ULP_BOUND):
                raise AssertionError(f"{what} leaf {i}: {d} ULP")
        elif not torch.equal(g, w):
            raise AssertionError(f"{what} leaf {i}: max abs diff "
                                 f"{(g.long() - w.long()).abs().max().item()}")
    return {"max_abs_err": err, "max_ulp": ulp}


def all_ops_pipeline(c, w: int = 37, h: int = 13):
    """A small pipeline over every op the megakernel emitter streams
    (``STREAM_OPS``), built from either package's core ``c``: a fan out
    and in, a Pad with a value, halving and doubling (whose row demand goes
    negative at the top edge), a Crop, a 3x3 Stencil with a Const bank, a
    Reduce and an ArgMin, a Replicate, a ReducePatch over a Stencil of
    vectors, floats and a compare, and a Stack and Concat of the results.
    The default frame is one no tile divides."""

    class AllOps(c.UserFunction):
        def __init__(self):
            super().__init__("allops", c.Array2d(c.UInt(8), w, h))
            self.w, self.h = w, h

        def define(self, x):
            fan = c.FanOut(2)(x)
            a, b = fan[0], c.FanIn(fan[1])
            p = c.Pad(1, 2, 3, 0, value=7)(a)
            up = c.Upsample(2, 2)(c.Downsample(2, 2)(p))
            diff = c.Map(c.AbsDiff)(b, c.Crop(1, 2, 3, 0)(up))
            st = c.Stencil(-1, 1, -1, 1)(diff)
            bank = c.Const(c.Array2d(c.UInt(4), 3, 3),
                           np.arange(1, 10).reshape(3, 3))
            s = c.Reduce(c.Add)(c.Map(c.Mul)(st, bank))        # wraps u12
            lanes = c.Map(c.Mul)(c.Replicate(4)(s), c.Const(
                c.Array2d(c.UInt(3), 4, 1), np.array([[1, 2, 3, 4]])))
            patch_max = c.ReducePatch(c.Max)(c.Stencil(-1, 0, -1, 0)(lanes))
            ratio = c.Map(c.FloatDiv)(c.Map(c.ToFloat)(s),
                                      c.Map(c.ToFloat)(diff))
            big = c.Map(c.Gt)(s, c.Const(c.UInt(12), 300))
            return c.Concat(c.Stack(s, c.ArgMin(st), diff), patch_max, ratio,
                            big)

    return AllOps()


def point_fn_probes(c):
    """Pipelines at the edges of the point functions' integer semantics,
    built from either package's core ``c``, each with its input frames
    (the first is the exact input that found the fault): FloatSqrt and
    FloatDiv on UInt(32) values above 2**24, where numpy computes in
    float64 from the integers, and Sub and Abs with a Bool operand, which
    numpy promotes to an integer.  ``sqrt`` is a lone node and stays
    generic; ``sqrt_fused`` (an identity Max first) is FloatSqrt of an
    integer inside a fused segment.  Returns name -> (UserFunction,
    (frames, h, w) int64 array)."""

    def probe(name, ty, body):
        class Probe(c.UserFunction):
            def __init__(self):
                super().__init__(name, ty)

            def define(self, x):
                return body(x)

        return Probe()

    u32, u8 = c.Array2d(c.UInt(32), 8, 4), c.Array2d(c.UInt(8), 6, 3)
    big = np.stack([np.random.RandomState(s).randint(2 ** 24, 2 ** 32, (4, 8))
                    | 1 for s in (0, 1)]).astype(np.int64)
    small = np.stack([np.random.RandomState(s).randint(0, 256, (3, 6))
                      for s in (0, 1)]).astype(np.int64)

    def gt(a):
        return c.Map(c.Gt)(a, c.Const(c.UInt(8), 100))

    return {
        "sqrt": (probe("sqrt", u32, lambda x: c.Map(c.FloatSqrt)(x)), big),
        "sqrt_fused": (probe("sqrtf", u32, lambda x: c.Map(c.FloatSqrt)(
            c.Map(c.Max)(x, c.Const(c.UInt(32), 0)))), big),
        "div_by_shift": (probe("divs", u32, lambda x: c.Map(c.FloatDiv)(
            x, c.Map(c.Rshift(3))(x))), big),
        "div_float_by_int": (probe("divf", u32, lambda x: c.Map(c.FloatDiv)(
            c.Map(c.ToFloat)(c.Map(c.RemoveMSBs(24))(x)), x)), big),
        "sub_bool_int": (probe("sbi", u8, lambda a: c.Map(c.Sub)(gt(a), a)),
                         small),
        "sub_int_bool": (probe("sib", u8, lambda a: c.Map(c.Sub)(a, gt(a))),
                         small),
        "abs_bool": (probe("absb", u8, lambda a: c.Map(c.Abs)(gt(a))), small),
    }


def external_pipelines(c, w: int = 12, h: int = 8, log=None):
    """Pipelines with an ``External`` (a numpy model) between streamed
    segments, built from either package's core ``c``; each model appends
    the sum of its first operand to ``log`` (a list) when one is given, so
    a caller sees one call per frame and their order.

    - ``clip``: a 3x3 box sum, the External (a clip), then a chain of point
      ops: on the kernels backend a megakernel on each side of it;
    - ``tuple``: the External takes a tuple (the frame and its box sum) and
      a Const, and returns a tuple of a UInt(8) and an Int(12) image, both
      wrapped to their widths; a scalar Const scheduled before the External
      feeds the segment after it;
    - ``wide``: the External returns a UInt(48) image, wrapped to 48 bits.
    Returns name -> UserFunction."""

    def record(a):
        if log is not None:
            log.append(int(np.asarray(a).sum()))

    def box(x):
        return c.Reduce(c.Add)(c.Map(c.AddMSBs(4))(c.Stencil(-1, 1, -1, 1)(x)))

    def clip(a):
        record(a)
        return np.clip(a, 100, 1500)

    def split(t, k):
        a, b = t
        record(a)
        return (a * k + 7, b - 3 * a)

    def wide(a):
        record(a)
        return (a << 40) + (a << 20) + a

    def pipeline(name, body):
        class Ext(c.UserFunction):
            def __init__(self):
                super().__init__(f"ext_{name}", c.Array2d(c.UInt(8), w, h))

            def define(self, x):
                return body(x)

        return Ext()

    def clip_body(x):
        fan = c.FanOut(2)(x)
        b = box(fan[0])
        e = c.External("clip", b.ty, clip, b)
        s = c.Map(c.Add)(e, c.Map(c.AddMSBs(4))(c.FanIn(fan[1])))
        return c.Map(c.AbsDiff)(c.Map(c.Rshift(2))(s), c.Map(c.Rshift(3))(e))

    def tuple_body(x):
        fan = c.FanOut(2)(x)
        b = box(fan[0])
        ty = c.TupleT((c.Array2d(c.UInt(8), w, h), c.Array2d(c.Int(12), w, h)))
        e = c.External("split", ty, split, c.Concat(fan[1], b),
                       c.Const(c.UInt(8), 3))
        lo = c.Map(c.Max)(c.Map(c.Rshift(1))(e[0]), c.Const(c.UInt(8), 9))
        return c.Concat(lo, c.Map(c.Abs)(e[1]))

    def wide_body(x):
        e = c.External("wide", c.Array2d(c.UInt(48), w, h), wide, x)
        return c.Map(c.Rshift(8))(e)

    return {"clip": pipeline("clip", clip_body),
            "tuple": pipeline("tuple", tuple_body),
            "wide": pipeline("wide", wide_body)}
