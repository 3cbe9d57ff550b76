"""HWImg data types (paper fig. 2).

T := Uint(bits,exp) | Int(bits,exp) | Bits(n) | Float(exp,sig) | Bool
   | T[w] | T[w,h] | (T,T,...)        (arrays and tuples)
   | T[<=w, h]                        (sparse arrays with max size)

All types are monomorphic with exact bit widths; ``exp`` is a fixed-point
binary exponent (value = raw * 2**-exp).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple as PyTuple

import numpy as np


class DType:
    """Base class for HWImg types."""

    def bits(self) -> int:
        raise NotImplementedError

    # numpy carrier type used by the executor for this scalar family
    def np_dtype(self):
        return np.int64


# The executor carries every integer scalar in int64.  Above 62 bits the
# carrier itself misbehaves *silently*: a 63-bit add can overflow int64
# mid-expression, and Int(63)'s sign extension in mask_to_width computes
# ``x - (1 << 63)`` which is not an int64 value at all.  62 bits leaves one
# growth bit plus the sign bit, and is the same cap the lowering rules'
# exactness guards (patterns._fits) already assume — wider types fail here,
# at construction, with a clear error instead of wrong numerics downstream.
MAX_CARRIER_BITS = 62


def _check_carrier_width(kind: str, nbits) -> None:
    if not isinstance(nbits, int) or nbits < 1:
        raise ValueError(f"{kind} width must be a positive int, "
                         f"got {nbits!r}")
    if nbits > MAX_CARRIER_BITS:
        raise ValueError(
            f"{kind}({nbits}) exceeds the int64 executor carrier's safe "
            f"width ({MAX_CARRIER_BITS} bits): arithmetic and sign "
            f"extension would wrap in the carrier, not in the modeled "
            f"hardware")


@dataclass(frozen=True)
class UInt(DType):
    nbits: int
    exp: int = 0

    def __post_init__(self):
        _check_carrier_width("Uint", self.nbits)

    def bits(self) -> int:
        return self.nbits

    def np_dtype(self):
        return np.int64

    def __repr__(self):
        return f"Uint({self.nbits},{self.exp})" if self.exp else f"Uint({self.nbits})"


@dataclass(frozen=True)
class Int(DType):
    nbits: int
    exp: int = 0

    def __post_init__(self):
        _check_carrier_width("Int", self.nbits)

    def bits(self) -> int:
        return self.nbits

    def np_dtype(self):
        return np.int64

    def __repr__(self):
        return f"Int({self.nbits},{self.exp})" if self.exp else f"Int({self.nbits})"


@dataclass(frozen=True)
class Bits(DType):
    nbits: int

    def __post_init__(self):
        _check_carrier_width("Bits", self.nbits)

    def bits(self) -> int:
        return self.nbits

    def __repr__(self):
        return f"Bits({self.nbits})"


@dataclass(frozen=True)
class Float(DType):
    exp: int = 8
    sig: int = 24  # ieee float32 by default

    def bits(self) -> int:
        return self.exp + self.sig

    def np_dtype(self):
        return np.float32

    def __repr__(self):
        return f"Float({self.exp},{self.sig})"


@dataclass(frozen=True)
class BoolT(DType):
    def bits(self) -> int:
        return 1

    def np_dtype(self):
        return np.bool_

    def __repr__(self):
        return "Bool"


Bool = BoolT()


@dataclass(frozen=True)
class ArrayT(DType):
    """T[w, h]. ``h == 1`` models the 1-D case T[w]."""

    elem: DType
    w: int
    h: int = 1

    def bits(self) -> int:
        return self.elem.bits() * self.w * self.h

    @property
    def size(self) -> int:
        return self.w * self.h

    def __repr__(self):
        return f"{self.elem!r}[{self.w},{self.h}]"


def Array2d(elem: DType, w: int, h: int = 1) -> ArrayT:
    """Paper-style constructor name (fig. 1)."""
    return ArrayT(elem, w, h)


@dataclass(frozen=True)
class TupleT(DType):
    elems: PyTuple[DType, ...]

    def bits(self) -> int:
        return sum(e.bits() for e in self.elems)

    def __repr__(self):
        return "(" + ",".join(repr(e) for e in self.elems) + ")"


@dataclass(frozen=True)
class SparseT(DType):
    """T[<=w, h]: sparse array holding at most w*h valid elements."""

    elem: DType
    w: int
    h: int = 1

    def bits(self) -> int:
        # payload + per-element valid bit
        return (self.elem.bits() + 1) * self.w * self.h

    @property
    def size(self) -> int:
        return self.w * self.h

    def __repr__(self):
        return f"{self.elem!r}[<={self.w},{self.h}]"


# ----------------------------------------------------------------------------
# helpers

def is_integer(t: DType) -> bool:
    return isinstance(t, (UInt, Int))


def is_signed(t: DType) -> bool:
    return isinstance(t, Int)


def mask_to_width(x: np.ndarray, t: DType) -> np.ndarray:
    """Wrap an int64 carrier value to the declared bit width (hardware wrap
    semantics). Floats / bools pass through."""
    if isinstance(t, UInt):
        return np.bitwise_and(x.astype(np.int64), (1 << t.nbits) - 1)
    if isinstance(t, Int):
        n = t.nbits
        x = np.bitwise_and(x.astype(np.int64), (1 << n) - 1)
        sign = 1 << (n - 1)
        return np.where(x >= sign, x - (1 << n), x)
    if isinstance(t, Bits):
        return np.bitwise_and(x.astype(np.int64), (1 << t.nbits) - 1)
    return x


def widen(t: DType, extra_bits: int) -> DType:
    """AddMSBs: widen an integer type (paper fig. 1)."""
    if isinstance(t, UInt):
        return UInt(t.nbits + extra_bits, t.exp)
    if isinstance(t, Int):
        return Int(t.nbits + extra_bits, t.exp)
    raise TypeError(f"cannot widen {t!r}")


def narrow(t: DType, fewer_bits: int) -> DType:
    if isinstance(t, UInt):
        return UInt(t.nbits - fewer_bits, t.exp)
    if isinstance(t, Int):
        return Int(t.nbits - fewer_bits, t.exp)
    raise TypeError(f"cannot narrow {t!r}")


def elem_of(t: DType) -> DType:
    if isinstance(t, (ArrayT, SparseT)):
        return t.elem
    raise TypeError(f"{t!r} is not an array type")
