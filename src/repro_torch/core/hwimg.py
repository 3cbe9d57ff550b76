"""HWImg: the paper's extensible, loop-free image processing language (§3),
embedded in Python instead of C++.

Programs are DAGs of ``Val`` nodes. Arrays may only be touched by whole-array
operators (Map / Reduce / Stencil / Pad / Crop / ...); there are no loops.
Every node is monomorphic: types and array sizes are constants.

Surface-syntax note: the C++ library composes nested maps like
``Map<Map<AddMSBs<24>>>``; the Python embedding folds that pattern into a
single broadcasting ``Map`` (scalar functions apply elementwise through any
nesting depth, like numpy broadcasting). The operator vocabulary, type system
and — crucially — the hardware mapping semantics are unchanged.

Runtime layout conventions (executor.py):
  ArrayT(e, w, h)                  -> ndarray shape (h, w)
  ArrayT(ArrayT(e, ew, eh), w, h)  -> ndarray shape (h, w, eh, ew)
  TupleT elements                  -> python tuple of arrays
  SparseT(e, w, h)                 -> (values (h, w, ...), valid mask (h, w))
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from fractions import Fraction
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from .dtypes import (ArrayT, Bool, DType, Float, Int, SparseT, TupleT,
                     UInt, is_integer, is_signed, narrow, widen)

_counter = itertools.count()


@dataclass(frozen=True, eq=False)
class Val:
    """A node in the HWImg dataflow DAG."""

    op: str
    params: Tuple[Tuple[str, Any], ...]
    inputs: Tuple["Val", ...]
    ty: DType
    uid: int = field(default_factory=lambda: next(_counter))

    @property
    def p(self) -> Dict[str, Any]:
        return dict(self.params)

    def __getitem__(self, i: int) -> "Val":
        if isinstance(self.ty, TupleT):
            return apply_op("TupleIndex", {"i": i}, self)
        raise TypeError(f"cannot index non-tuple {self.ty!r}")

    def __repr__(self):
        return f"%{self.uid}={self.op}"


# ----------------------------------------------------------------------------
# scalar function objects (the things Map / Reduce operate over)

@dataclass(frozen=True)
class PointFn:
    """A scalar function usable inside Map / Reduce.

    ``lut_cost(*in_types) -> (luts, dsps)`` sizes one hardware instance;
    ``latency`` is pipeline depth in cycles; ``data_dependent=True`` marks
    data-dependent latency (float div), which forces a Stream interface
    (paper §2.3)."""

    name: str
    n_in: int
    out_type: Callable[..., DType]
    np_fn: Callable[..., np.ndarray]
    lut_cost: Callable[..., Tuple[int, int]]
    latency: int = 0
    data_dependent: bool = False
    params: Tuple[Tuple[str, Any], ...] = ()


def _num_type(a: DType, b: DType, grow_mul=False, force_signed=False) -> DType:
    if isinstance(a, Float) or isinstance(b, Float):
        return a if isinstance(a, Float) else b
    assert is_integer(a) and is_integer(b), (a, b)
    signed = force_signed or is_signed(a) or is_signed(b)
    cls = Int if signed else UInt
    if grow_mul:
        return cls(a.bits() + b.bits(), getattr(a, "exp", 0) + getattr(b, "exp", 0))
    return cls(max(a.bits(), b.bits()), getattr(a, "exp", 0))


def _adder_cost(a, b=None):
    b = b or a
    if isinstance(a, Float):
        return (200, 0)
    return (max(a.bits(), b.bits()), 0)


def _mul_cost(a, b=None):
    b = b or a
    if isinstance(a, Float):
        return (120, 3)
    # LUT-based multiplier (paper disables DSPs): ~n*m/2 LUTs
    return (max(4, a.bits() * b.bits() // 2), 0)


Add = PointFn("Add", 2, lambda a, b: _num_type(a, b), lambda a, b: a + b,
              _adder_cost)
# AddAsync: zero-latency combinational adder (paper fig. 1); its zero latency
# is what lets Reduce choose a multi-cycle (vectorized) reduction (fig. 7).
AddAsync = PointFn("AddAsync", 2, lambda a, b: _num_type(a, b),
                   lambda a, b: a + b, _adder_cost, latency=0)
def _sub_type(a: DType, b: DType) -> DType:
    if isinstance(a, Float) or isinstance(b, Float):
        return a if isinstance(a, Float) else b
    # a - b needs one growth bit and is always signed
    return Int(max(a.bits(), b.bits()) + 1, getattr(a, "exp", 0))


Sub = PointFn("Sub", 2, _sub_type, lambda a, b: a - b, _adder_cost)
Mul = PointFn("Mul", 2, lambda a, b: _num_type(a, b, grow_mul=True),
              lambda a, b: a * b, _mul_cost, latency=1)
Abs = PointFn("Abs", 1, lambda a: UInt(a.bits(), getattr(a, "exp", 0)),
              lambda a: np.abs(a), lambda a: (a.bits(), 0))
AbsDiff = PointFn("AbsDiff", 2,
                  lambda a, b: UInt(max(a.bits(), b.bits()), getattr(a, "exp", 0)),
                  lambda a, b: np.abs(a.astype(np.int64) - b.astype(np.int64)),
                  lambda a, b: (2 * max(a.bits(), b.bits()), 0))
Max = PointFn("Max", 2, lambda a, b: _num_type(a, b), np.maximum, _adder_cost)
Min = PointFn("Min", 2, lambda a, b: _num_type(a, b), np.minimum, _adder_cost)
Gt = PointFn("Gt", 2, lambda a, b: Bool, lambda a, b: a > b, _adder_cost)
And = PointFn("And", 2, lambda a, b: Bool, np.logical_and, lambda a, b: (1, 0))


def Rshift(n: int) -> PointFn:
    return PointFn("Rshift", 1, lambda a: a,
                   lambda a: (a / (2 ** n) if a.dtype.kind == "f" else a >> n),
                   lambda a: (0, 0), params=(("n", n),))


def AddMSBs(n: int) -> PointFn:
    return PointFn("AddMSBs", 1, lambda a: widen(a, n), lambda a: a,
                   lambda a: (0, 0), params=(("n", n),))


def RemoveMSBs(n: int) -> PointFn:
    return PointFn("RemoveMSBs", 1, lambda a: narrow(a, n), lambda a: a,
                   lambda a: (0, 0), params=(("n", n),))


ToFloat = PointFn("ToFloat", 1, lambda a: Float(8, 24),
                  lambda a: a.astype(np.float32), lambda a: (100, 0), latency=2)
FloatMul = PointFn("FloatMul", 2, lambda a, b: Float(8, 24),
                   lambda a, b: (np.float32(a) * np.float32(b)).astype(np.float32),
                   _mul_cost, latency=3)
FloatAdd = PointFn("FloatAdd", 2, lambda a, b: Float(8, 24),
                   lambda a, b: (np.float32(a) + np.float32(b)).astype(np.float32),
                   _adder_cost, latency=3)
FloatSub = PointFn("FloatSub", 2, lambda a, b: Float(8, 24),
                   lambda a, b: (np.float32(a) - np.float32(b)).astype(np.float32),
                   _adder_cost, latency=3)
# HardFloat-style divider: data-dependent latency (paper §2.3 / §7 DESCRIPTOR
# / FLOW). Forces a Stream interface.
FloatDiv = PointFn("FloatDiv", 2, lambda a, b: Float(8, 24),
                   lambda a, b: np.where(
                       b != 0, np.float32(a) / np.where(b == 0, 1, b), 0
                   ).astype(np.float32),
                   lambda a, b: (600, 8), latency=16, data_dependent=True)
FloatSqrt = PointFn("FloatSqrt", 1, lambda a: Float(8, 24),
                    lambda a: np.sqrt(np.maximum(a, 0)).astype(np.float32),
                    lambda a: (450, 4), latency=12, data_dependent=True)


# ----------------------------------------------------------------------------
# type utilities

def type_shape(t: DType) -> Tuple[int, ...]:
    """Trailing ndarray shape for a value of type t (scalars -> ())."""
    if isinstance(t, ArrayT):
        return (t.h, t.w) + type_shape(t.elem)
    if isinstance(t, SparseT):
        return (t.h, t.w) + type_shape(t.elem)
    return ()


def scalar_of(t: DType) -> DType:
    while isinstance(t, (ArrayT, SparseT)):
        t = t.elem
    return t


def with_scalar(t: DType, s: DType) -> DType:
    """Replace the scalar leaf of a (possibly nested) array type."""
    if isinstance(t, ArrayT):
        return ArrayT(with_scalar(t.elem, s), t.w, t.h)
    if isinstance(t, SparseT):
        return SparseT(with_scalar(t.elem, s), t.w, t.h)
    return s


def scalar_count(t: DType) -> int:
    n = 1
    for d in type_shape(t):
        n *= d
    return n


def map_reshape_plans(out_ty: DType, in_tys: Sequence[DType]) -> list:
    """Broadcast alignment for Map operands of unequal nesting depth.

    Returns, per operand, either None (numpy's right-aligned trailing-dim
    broadcasting already does the right thing — e.g. an (kh, kw) coefficient
    array against (h, w, kh, kw) stencil patches) or the reshape target that
    right-aligns it by *type structure*: an operand whose array dims match
    the *outer* levels of the output (e.g. a per-pixel (h, w) image combined
    with (h, w, sh, sw) patches) gets trailing singleton axes appended so it
    broadcasts across the inner levels.
    """
    out_shape = type_shape(out_ty)
    plans = []
    for ity in in_tys:
        s = type_shape(ity)
        k = len(s)
        if k == 0 or k >= len(out_shape):
            plans.append(None)          # scalar / full depth
            continue
        suffix = s == out_shape[len(out_shape) - k:]
        prefix = s == out_shape[:k]
        if suffix and prefix:
            # e.g. an (n, n) operand against (n, n, n, n) patches: inner
            # (coefficient) and outer (per-pixel) alignment both fit but
            # mean different things — refuse to guess
            raise TypeError(
                f"ambiguous Map broadcast: operand {ity!r} aligns with "
                f"both the outer and inner levels of {out_ty!r}; lift it "
                f"explicitly (e.g. Replicate) to disambiguate")
        if prefix:
            plans.append(s + (1,) * (len(out_shape) - k))
        else:
            plans.append(None)          # numpy suffix broadcast, or no
    return plans                        # alignment (op raises naturally)


def map_operand_reshapes(v: Val) -> list:
    """``map_reshape_plans`` over a Val node (executor entry point)."""
    return map_reshape_plans(v.ty, [i.ty for i in v.inputs])


def inner_reduce_type(t: DType, out_scalar: DType) -> DType:
    """Type of reducing the innermost array level of t."""
    if isinstance(t, ArrayT) and isinstance(t.elem, ArrayT):
        return ArrayT(inner_reduce_type(t.elem, out_scalar), t.w, t.h)
    if isinstance(t, ArrayT):
        return out_scalar
    raise TypeError(f"Reduce over non-array {t!r}")


# ----------------------------------------------------------------------------
# graph construction

def apply_op(op: str, params: Dict[str, Any], *inputs: Val,
             ty: Optional[DType] = None) -> Val:
    if ty is None:
        ty = OPS[op].infer(params, *[v.ty for v in inputs])
    return Val(op, tuple(sorted(params.items(), key=lambda kv: str(kv[0]))),
               tuple(inputs), ty)


def Input(ty: DType, name: str = "input") -> Val:
    return apply_op("Input", {"name": name}, ty=ty)


def Const(ty: DType, value) -> Val:
    return apply_op("Const", {"value": np.asarray(value)}, ty=ty)


@dataclass(frozen=True)
class OpDef:
    name: str
    infer: Callable[..., DType]
    # SDF rate: output tokens per input token (paper §4.1). One token = one
    # outer array element transaction.
    sdf: Callable[..., Fraction] = None  # type: ignore
    stream_only: bool = False   # forces the pipeline to Stream (§5.1)
    bursty: bool = False        # needs FIFO burst slack B (§4.3)


def _infer_map(params, *ts: DType) -> DType:
    fn: PointFn = params["fn"]
    arrs = [t for t in ts if isinstance(t, ArrayT)]
    # the deepest-nested operand fixes the output structure; shallower
    # operands broadcast through it (ties: first operand wins)
    base = max(arrs, key=lambda t: len(type_shape(t))) if arrs else ts[0]
    out_scalar = fn.out_type(*[scalar_of(t) for t in ts])
    return with_scalar(base, out_scalar)


def _infer_reduce(params, t: DType) -> DType:
    fn: PointFn = params["fn"]
    s = scalar_of(t)
    return inner_reduce_type(t, fn.out_type(s, s))


def _infer_argmin(params, t: DType) -> DType:
    assert isinstance(t, ArrayT)
    inner = t.elem if isinstance(t.elem, ArrayT) else t
    n = inner.size
    idx_t = UInt(max(1, math.ceil(math.log2(max(2, n)))))
    if isinstance(t.elem, ArrayT):
        return ArrayT(idx_t, t.w, t.h)
    return idx_t


def _infer_reduce_patch(params, t: DType) -> DType:
    fn: PointFn = params["fn"]
    assert isinstance(t, ArrayT) and isinstance(t.elem, ArrayT) \
        and isinstance(t.elem.elem, ArrayT), f"ReducePatch needs depth-3 {t!r}"
    inner = t.elem.elem
    s = scalar_of(t)
    return ArrayT(ArrayT(fn.out_type(s, s), inner.w, inner.h), t.w, t.h)


def _st_size(p) -> Tuple[int, int]:
    return (abs(p["r"] - p["l"]) + 1, abs(p["t"] - p["b"]) + 1)


OPS: Dict[str, OpDef] = {}


def _op(name, infer, sdf=None, **kw):
    OPS[name] = OpDef(name, infer, sdf or (lambda p, *t: Fraction(1)), **kw)


_op("Input", lambda p: None)
_op("Const", lambda p: None)
_op("TupleIndex", lambda p, t: t.elems[p["i"]])
_op("Concat", lambda p, *ts: TupleT(tuple(ts)))
_op("FanOut", lambda p, t: TupleT(tuple(t for _ in range(p["n"]))))
_op("FanIn", lambda p, t: t)
_op("Map", _infer_map)
_op("Reduce", _infer_reduce)
_op("ReducePatch", _infer_reduce_patch)
_op("ArgMin", _infer_argmin)
_op("Replicate", lambda p, t: ArrayT(ArrayT(t.elem, p["n"], p["m"]),
                                     t.w, t.h))
_op("Stack", lambda p, *ts: ArrayT(ArrayT(ts[0].elem, len(ts), 1),
                                   ts[0].w, ts[0].h))
_op("Stencil", lambda p, t: ArrayT(ArrayT(t.elem, *_st_size(p)), t.w, t.h))
_op("Pad", lambda p, t: ArrayT(t.elem, t.w + p["l"] + p["r"],
                               t.h + p["b"] + p["t"]),
    sdf=lambda p, t: Fraction((t.w + p["l"] + p["r"]) * (t.h + p["b"] + p["t"]),
                              t.w * t.h),
    bursty=True)
_op("Crop", lambda p, t: ArrayT(t.elem, t.w - p["l"] - p["r"],
                                t.h - p["b"] - p["t"]),
    sdf=lambda p, t: Fraction((t.w - p["l"] - p["r"]) * (t.h - p["b"] - p["t"]),
                              t.w * t.h),
    bursty=True)
_op("Downsample", lambda p, t: ArrayT(t.elem, t.w // p["sx"], t.h // p["sy"]),
    sdf=lambda p, t: Fraction(1, p["sx"] * p["sy"]), bursty=True)
_op("Upsample", lambda p, t: ArrayT(t.elem, t.w * p["sx"], t.h * p["sy"]),
    sdf=lambda p, t: Fraction(p["sx"] * p["sy"]))
_op("Filter", lambda p, t, m: SparseT(t.elem, t.w, t.h),
    stream_only=True, bursty=True)
_op("SparseTake",
    lambda p, t: ArrayT(TupleT((t.elem, UInt(32))), p["n"], 1),
    sdf=lambda p, t: Fraction(p["n"], t.w * t.h),
    stream_only=True, bursty=True)
_op("External", lambda p, *ts: p["out_type"], stream_only=True, bursty=True)


# --- user-facing constructors (template-arg style, paper fig. 1) -------------

def Map(fn: PointFn):
    """Broadcasting map: applies a scalar fn elementwise through any array
    nesting (C++ HWImg's Map<Map<...>> chains)."""
    def ctor(*xs: Val) -> Val:
        return apply_op("Map", {"fn": fn}, *xs)
    return ctor


def Reduce(fn: PointFn):
    """Tree/sequential reduction of the innermost array level (fig. 7)."""
    def ctor(x: Val) -> Val:
        return apply_op("Reduce", {"fn": fn}, x)
    return ctor


def ArgMin(x: Val) -> Val:
    """Index of the minimum over the innermost array level (STEREO)."""
    return apply_op("ArgMin", {}, x)


def ReducePatch(fn: PointFn):
    """Reduce the *middle* (patch) level of a stencil-of-vectors value:
    ArrayT(ArrayT(ArrayT(e,n,1), sw,sh), w,h) -> ArrayT(ArrayT(e',n,1), w,h).
    Hardware: one adder tree per vector lane over the patch taps."""
    def ctor(x: Val) -> Val:
        return apply_op("ReducePatch", {"fn": fn}, x)
    return ctor


def Replicate(n: int, m: int = 1):
    """Broadcast each pixel to an (n, m) inner vector (wires, no logic)."""
    def ctor(x: Val) -> Val:
        return apply_op("Replicate", {"m": m, "n": n}, x)
    return ctor


def Stack(*xs: Val) -> Val:
    """Combine k scalar images into one image of k-vectors (sync + wires)."""
    return apply_op("Stack", {}, *xs)


def Stencil(l: int, r: int, b: int, t: int):
    def ctor(x: Val) -> Val:
        return apply_op("Stencil", {"l": l, "r": r, "b": b, "t": t}, x)
    return ctor


def Pad(l: int, r: int, b: int, t: int, value=0):
    def ctor(x: Val) -> Val:
        return apply_op("Pad", {"l": l, "r": r, "b": b, "t": t,
                                "value": value}, x)
    return ctor


def Crop(l: int, r: int, b: int, t: int):
    def ctor(x: Val) -> Val:
        return apply_op("Crop", {"l": l, "r": r, "b": b, "t": t}, x)
    return ctor


def Downsample(sx: int, sy: int):
    def ctor(x: Val) -> Val:
        return apply_op("Downsample", {"sx": sx, "sy": sy}, x)
    return ctor


def Upsample(sx: int, sy: int):
    def ctor(x: Val) -> Val:
        return apply_op("Upsample", {"sx": sx, "sy": sy}, x)
    return ctor


def FanOut(n: int):
    def ctor(x: Val) -> Val:
        return apply_op("FanOut", {"n": n}, x)
    return ctor


def FanIn(x: Val) -> Val:
    return apply_op("FanIn", {}, x)


def Concat(*xs: Val) -> Val:
    return apply_op("Concat", {}, *xs)


def Filter(x: Val, mask: Val, expected_burst: int = 256) -> Val:
    """Sparse filter (paper §4.3): keep elements where mask is true. The user
    annotates the worst-case burstiness (§4.3, DESCRIPTOR)."""
    return apply_op("Filter", {"expected_burst": expected_burst}, x, mask)


def SparseTake(x: Val, n: int) -> Val:
    """Densify a sparse stream into its first n (value, flat index) records."""
    return apply_op("SparseTake", {"n": n}, x)


def External(name: str, out_type: DType, np_fn, *inputs: Val,
             rate: Fraction = Fraction(1), latency: int = 4, burst: int = 8,
             luts: int = 500, dsps: int = 0) -> Val:
    """Import an external module with explicit R/L/B schedule annotations —
    the analog of importing hand-written Verilog (paper §1, §7)."""
    return apply_op("External",
                    {"ext_name": name, "out_type": out_type, "np_fn": np_fn,
                     "rate": rate, "latency": latency, "burst": burst,
                     "luts": luts, "dsps": dsps}, *inputs)


# ----------------------------------------------------------------------------
# UserFunction: paper-style pipeline definition (fig. 1)

class UserFunction:
    """Subclass and implement ``define(inp) -> Val`` (paper fig. 1)."""

    def __init__(self, name: str, in_type: DType):
        self.name = name
        self.in_type = in_type

    def define(self, inp: Val) -> Val:
        raise NotImplementedError

    def build(self) -> Tuple[Val, Val]:
        inp = Input(self.in_type, name=self.name + ".in")
        out = self.define(inp)
        return inp, out


def toposort(out: Val) -> Sequence[Val]:
    seen: Dict[int, Val] = {}
    order: list = []

    def visit(v: Val):
        if v.uid in seen:
            return
        seen[v.uid] = v
        for i in v.inputs:
            visit(i)
        order.append(v)

    visit(out)
    return order
