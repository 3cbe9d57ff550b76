"""The resident rewrite rules (the declarative fusion pattern library).

The torch counterpart of ``repro/core/lowering/patterns.py``:

  conv2d        Stencil -> Map(Mul)(., Const) -> Reduce(Add) -> Rshift ->
                RemoveMSBs            =>  kernels/conv2d   (kernels only)
  sad           Stencil(1 x nd) -> Map(AbsDiff)(Replicate(L)|L, .) ->
                Stencil(bh x bw) -> ReducePatch(Add) -> ArgMin
                                      =>  kernels/sad      (kernels only)
  separable     Stencil -> Map(Mul)(., Const rank-1 K) -> Reduce(Add)
                                      =>  two 1-D conv passes (torch)
  window_sum    [Map(Mul)(a, b)] -> Stencil -> Reduce(Add)   (the FLOW
                second-moment block)  =>  one exact box sum (torch)
  pyramid       Down/Downsample and Up/Upsample chain collapse, and the
                Down(s)(Up(s)(x)) identity  (algebraic graph rewrites)

Patterns and guards are the reference's, unchanged.  Every rule fires only
when provably bit-exact against the executor: the guards bound the
worst-case accumulator magnitude so the executor's per-step width masking
is the identity, and so the kernels' int32 sums cannot overflow (signed
overflow is undefined in CUDA C++).  The fused torch implementations work
on the int64 carrier with the engine's leading frame axis.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..dtypes import ArrayT, Bits, Float, Int, TupleT, UInt, mask_to_width
from ...kernels.util import shift2d
from .ir import Dispatch, IRNode
from .rewrite import (Chain, Either, Leaf, Many, Match, Opt, OpPat, Replace,
                      Rewire, RewriteRule)

# --------------------------------------------------------------------------
# shared guard helpers


def _plain_image(ty) -> bool:
    return isinstance(ty, ArrayT) and not isinstance(ty.elem, (ArrayT, TupleT))


def _maxabs(s) -> int:
    """Largest |value| a scalar of type s can carry."""
    if isinstance(s, (UInt, Bits)):
        return 2 ** s.bits() - 1
    if isinstance(s, Int):
        return 2 ** (s.bits() - 1)
    raise TypeError(f"not an integer scalar: {s!r}")


def _fits(max_abs: int, s, cap_bits: int = 62) -> bool:
    """True iff every intermediate of magnitude <= max_abs survives the
    executor's masking to s unchanged (and fits the int64 carrier)."""
    lim = 2 ** (s.bits() - 1) if isinstance(s, Int) else 2 ** s.bits()
    return max_abs < min(lim, 2 ** cap_bits)


def _is_int(s) -> bool:
    return isinstance(s, (UInt, Int, Bits))


def _sign_safe(can_be_negative: bool, *scalars) -> bool:
    """Negative intermediates masked to an unsigned width would wrap in the
    executor; require signed carriers whenever a term can go negative."""
    return not can_be_negative or all(isinstance(s, Int) for s in scalars)


def _stencil_size(p) -> Tuple[int, int]:
    return abs(p["t"] - p["b"]) + 1, abs(p["r"] - p["l"]) + 1   # (sh, sw)


def _const_kernel(k: IRNode, kh: int, kw: int) -> np.ndarray:
    return mask_to_width(np.asarray(k.params["value"]),
                         k.scalar).reshape(kh, kw)


# --------------------------------------------------------------------------
# conv2d: the CONVOLUTION chain => kernels/conv2d (kernels backend)

_CONV_PAT = OpPat("Map", fn="RemoveMSBs", ins=(
    Chain(
        Opt(OpPat("Map", fn="Rshift", bind="shift")),
        OpPat("Reduce", fn=("Add", "AddAsync"), bind="acc", ins=(
            Chain(
                Many(OpPat("Map", fn="AddMSBs")),
                OpPat("Map", fn="Mul", commutative=True, ins=(
                    OpPat("Stencil", bind="st", ins=(Leaf("x"),)),
                    OpPat("Const", bind="k")))),)),
    ),))


def _conv_guard(m: Match) -> bool:
    s_out = m.anchor.scalar
    if not (isinstance(s_out, UInt) and s_out.bits() == 8):
        return False
    shift = m.get("shift")
    if shift is not None and isinstance(shift.scalar, Float):
        return False
    x, k, st = m["x"], m["k"], m["st"]
    if not (isinstance(x.scalar, UInt) and isinstance(k.scalar, UInt)):
        return False
    if not _plain_image(x.ty):
        return False
    kh, kw = _stencil_size(st.params)
    if k.shape != (kh, kw):
        return False
    # exactness guard: the full dot product must not wrap — neither in the
    # executor's declared accumulator width nor in the kernel's int32
    acc_bits = m["acc"].scalar.bits()
    max_sum = _maxabs(x.scalar) * _maxabs(k.scalar) * kh * kw
    return max_sum < 2 ** min(acc_bits, 31)


def _conv_build(m: Match) -> Dispatch:
    st, k = m["st"], m["k"]
    kh, kw = _stencil_size(st.params)
    kval = _const_kernel(k, kh, kw)
    l, b = st.params["l"], st.params["b"]
    shift_node = m.get("shift")
    shift = dict(shift_node.params["fn"].params)["n"] if shift_node else 0

    from ...kernels.registry import get_kernel
    site = get_kernel("conv2d").site_fn
    # the coefficient bank moves to each device once per compiled pipeline
    banks: Dict[torch.device, torch.Tensor] = {}

    def apply(xv):
        bank = banks.get(xv.device)
        if bank is None:
            bank = banks[xv.device] = torch.as_tensor(
                kval, dtype=torch.int32).to(xv.device)
        return site(xv, bank, l=l, b=b, shift=shift)

    note = (f"fused %{st.uid}:Stencil({kh}x{kw})->Map(Mul)->Reduce"
            f"->Rshift({shift})->RemoveMSBs => kernels/conv2d (csrc/conv2d.cu)")
    return Dispatch("conv2d", (m["x"].uid,), apply, note)


# --------------------------------------------------------------------------
# sad: the STEREO chain => kernels/sad (kernels backend)

def _cand_window(n: IRNode) -> bool:       # 1 x nd trailing candidate window
    p = n.params
    return p["r"] == 0 and p["b"] == 0 and p["t"] == 0 and p["l"] < 0


def _trailing_window(n: IRNode) -> bool:   # kernel implements trailing windows
    p = n.params
    return p["r"] == 0 and p["t"] == 0 and p["l"] <= 0 and p["b"] <= 0


_SAD_PAT = OpPat("ArgMin", ins=(
    OpPat("ReducePatch", fn=("Add", "AddAsync"), bind="acc", ins=(
        OpPat("Stencil", bind="patch", where=_trailing_window, ins=(
            Chain(
                Many(OpPat("Map", fn="AddMSBs")),
                OpPat("Map", fn="AbsDiff", commutative=True, ins=(
                    Either(
                        OpPat("Replicate", bind="rep", ins=(Leaf("left"),)),
                        Leaf("left")),
                    OpPat("Stencil", bind="cand", where=_cand_window,
                          ins=(Leaf("right"),))))),)),)),))


def _sad_guard(m: Match) -> bool:
    left, right, cand = m["left"], m["right"], m["cand"]
    nd = abs(cand.params["r"] - cand.params["l"]) + 1
    rep = m.get("rep")
    if rep is not None:
        if not (rep.params["n"] == nd and rep.params["m"] == 1):
            return False
    if not (isinstance(left.scalar, UInt) and isinstance(right.scalar, UInt)):
        return False
    if not (_plain_image(left.ty) and _plain_image(right.ty)):
        return False
    if left.shape != right.shape:
        return False
    # exactness guard: the SAD sum must not wrap (executor width or int32)
    bh, bw = _stencil_size(m["patch"].params)
    acc_bits = m["acc"].scalar.bits()
    max_sum = (2 ** max(left.scalar.bits(), right.scalar.bits()) - 1) * bh * bw
    return max_sum < 2 ** min(acc_bits, 31)


def _sad_build(m: Match) -> Dispatch:
    cand = m["cand"]
    nd = abs(cand.params["r"] - cand.params["l"]) + 1
    bh, bw = _stencil_size(m["patch"].params)

    from ...kernels.registry import get_kernel
    site = get_kernel("sad").site_fn

    def apply(lv, rv):
        return site(lv, rv, nd=nd, bh=bh, bw=bw)

    note = (f"fused %{cand.uid}:Stencil(1x{nd})->Map(AbsDiff)"
            f"->Stencil({bh}x{bw})->ReducePatch->ArgMin"
            f" => kernels/sad (csrc/sad.cu)")
    return Dispatch("sad", (m["left"].uid, m["right"].uid), apply, note)


# --------------------------------------------------------------------------
# separable: rank-1 conv kernel => two 1-D conv passes (torch, all backends)

_SEP_PAT = OpPat("Reduce", fn=("Add", "AddAsync"), bind="acc", ins=(
    Chain(
        Many(OpPat("Map", fn="AddMSBs")),
        OpPat("Map", fn="Mul", bind="mul", commutative=True, ins=(
            OpPat("Stencil", bind="st", ins=(Leaf("x"),)),
            OpPat("Const", bind="k")))),))


def _int_rank1_factor(K: np.ndarray) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Integer u, v with outer(u, v) == K, or None if K is not integer
    rank-1 factorizable (the separability guard)."""
    nz = np.argwhere(K != 0)
    if len(nz) == 0:
        return None
    i0, j0 = nz[0]
    col, row, piv = K[:, j0], K[i0, :], int(K[i0, j0])
    if np.any(K * piv != np.outer(col, row)):
        return None                      # 2x2 minors nonzero: rank > 1
    g = int(np.gcd.reduce(np.abs(col)))
    u = col // g
    num = row * g
    if np.any(num % piv != 0):
        return None                      # rank-1 but not over the integers
    v = num // piv
    if not np.array_equal(np.outer(u, v), K):
        return None
    return u, v


def _sep_guard(m: Match) -> bool:
    x, k, st = m["x"], m["k"], m["st"]
    if not (_plain_image(x.ty) and _is_int(x.scalar) and _is_int(k.scalar)):
        return False
    kh, kw = _stencil_size(st.params)
    if kh < 2 or kw < 2 or k.shape != (kh, kw):
        return False
    K = _const_kernel(k, kh, kw)
    if _int_rank1_factor(K) is None:
        return False
    # exactness: products fit the Mul's declared width, every partial sum
    # fits the accumulator (sum-of-|K| bound covers all prefixes; the
    # separable pass shares the bound since sum|K| == sum|u| * sum|v|)
    max_x = _maxabs(x.scalar)
    negative = isinstance(x.scalar, Int) or bool(np.any(K < 0))
    if not _sign_safe(negative, m["mul"].scalar, m["acc"].scalar):
        return False
    if not _fits(max_x * int(np.abs(K).max()), m["mul"].scalar):
        return False
    return _fits(max_x * int(np.abs(K).sum()), m["acc"].scalar)


def _sep_build(m: Match) -> Dispatch:
    st, k = m["st"], m["k"]
    kh, kw = _stencil_size(st.params)
    u, v = _int_rank1_factor(_const_kernel(k, kh, kw))
    l, b = st.params["l"], st.params["b"]

    def apply(xv):
        xi = xv.to(torch.int64)
        h, w = xi.shape[1:3]
        rows = sum(shift2d(xi, b + dy, 0, h, w) * int(u[dy])
                   for dy in range(kh))
        return sum(shift2d(rows, 0, l + dx, h, w) * int(v[dx])
                   for dx in range(kw))

    note = (f"fused %{st.uid}:Stencil({kh}x{kw})->Map(Mul)(Const rank-1)"
            f"->Reduce => separable 1-D conv pair (torch)")
    return Dispatch("separable_conv", (m["x"].uid,), apply, note)


# --------------------------------------------------------------------------
# window_sum: the FLOW second-moment block => one exact box sum
# (Ix·Iy products -> trailing/centered box-sum), all backends

def _win_window(n: IRNode) -> bool:
    p = n.params
    # the window spans the anchor pixel (the reference's nonneg padding)
    return p["l"] <= 0 <= p["r"] and p["b"] <= 0 <= p["t"]


_WINSUM_PAT = OpPat("Reduce", fn=("Add", "AddAsync"), bind="acc", ins=(
    Chain(
        Many(OpPat("Map", fn="AddMSBs")),
        OpPat("Stencil", bind="st", where=_win_window, ins=(
            Chain(
                Many(OpPat("Map", fn="AddMSBs")),
                Either(
                    OpPat("Map", fn="Mul", bind="mul",
                          ins=(Leaf("a"), Leaf("b"))),
                    Leaf("a"))),)),
    ),))


def _winsum_guard(m: Match) -> bool:
    a, b = m["a"], m.get("b")
    if not (_plain_image(a.ty) and _is_int(a.scalar)):
        return False
    term = _maxabs(a.scalar)
    negative = isinstance(a.scalar, Int)
    if b is not None:
        if not (_plain_image(b.ty) and _is_int(b.scalar)
                and a.shape == b.shape):
            return False
        term *= _maxabs(b.scalar)
        negative = negative or isinstance(b.scalar, Int)
        if not (_sign_safe(negative, m["mul"].scalar)
                and _fits(term, m["mul"].scalar)):
            return False                 # product must not wrap either
    sh, sw = _stencil_size(m["st"].params)
    if not _sign_safe(negative, m["acc"].scalar):
        return False
    return _fits(term * sh * sw, m["acc"].scalar)


def box_sum(x: torch.Tensor, l: int, b: int, sh: int, sw: int
            ) -> torch.Tensor:
    """out[:, y, x] = sum over i < sh, j < sw of x[:, y + b + i, x + l + j],
    zero outside x: an integral image on the int64 carrier, exact (no
    float), with the leading frame axis."""
    n, h, w = x.shape
    p = shift2d(x, b, l, h + sh - 1, w + sw - 1)
    s = p.new_zeros((n, h + sh, w + sw))
    s[:, 1:, 1:] = p.cumsum(1).cumsum(2)
    return s[:, sh:, sw:] - s[:, :h, sw:] - s[:, sh:, :w] + s[:, :h, :w]


def _winsum_build(m: Match) -> Dispatch:
    st = m["st"]
    p = st.params
    sh, sw = _stencil_size(p)
    l, b = p["l"], p["b"]

    if m.get("b") is not None:
        def apply(av, bv):
            return box_sum(av.to(torch.int64) * bv.to(torch.int64),
                           l, b, sh, sw)
        leaves = (m["a"].uid, m["b"].uid)
        what = f"Map(Mul)->Stencil({sh}x{sw})->Reduce"
    else:
        def apply(av):
            return box_sum(av.to(torch.int64), l, b, sh, sw)
        leaves = (m["a"].uid,)
        what = f"Stencil({sh}x{sw})->Reduce"

    note = (f"fused %{st.uid}:{what} => torch box sum "
            f"(second-moment/box-sum)")
    return Dispatch("window_sum", leaves, apply, note)


# --------------------------------------------------------------------------
# pyramid: Down/Upsample chain collapse (algebraic graph rewrites)

_DOWN_DOWN = OpPat("Downsample", ins=(
    OpPat("Downsample", bind="inner", ins=(Leaf("x"),)),))
_UP_UP = OpPat("Upsample", ins=(
    OpPat("Upsample", bind="inner", ins=(Leaf("x"),)),))
_DOWN_UP = OpPat("Downsample", ins=(
    OpPat("Upsample", bind="inner", ins=(Leaf("x"),)),))


def _down_down_build(m: Match) -> Replace:
    po, pi = m.anchor.params, m["inner"].params
    sx, sy = po["sx"] * pi["sx"], po["sy"] * pi["sy"]
    return Replace("Downsample", {"sx": sx, "sy": sy}, (m["x"].uid,),
                   f"collapsed %{m['inner'].uid}:Downsample chain => "
                   f"Downsample({sx}x{sy})")


def _up_up_build(m: Match) -> Replace:
    po, pi = m.anchor.params, m["inner"].params
    sx, sy = po["sx"] * pi["sx"], po["sy"] * pi["sy"]
    return Replace("Upsample", {"sx": sx, "sy": sy}, (m["x"].uid,),
                   f"collapsed %{m['inner'].uid}:Upsample chain => "
                   f"Upsample({sx}x{sy})")


def _down_up_guard(m: Match) -> bool:
    # Down(sd)(Up(su)(x)) == Down(sd/su)(x) when su divides sd (Up repeats
    # each pixel su times; Down keeps every sd-th starting at 0)
    po, pi = m.anchor.params, m["inner"].params
    return po["sx"] % pi["sx"] == 0 and po["sy"] % pi["sy"] == 0


def _down_up_build(m: Match):
    po, pi = m.anchor.params, m["inner"].params
    sx, sy = po["sx"] // pi["sx"], po["sy"] // pi["sy"]
    if sx == 1 and sy == 1:
        return Rewire(m["x"].uid,
                      f"collapsed %{m['inner'].uid}:Up/Downsample identity")
    return Replace("Downsample", {"sx": sx, "sy": sy}, (m["x"].uid,),
                   f"collapsed %{m['inner'].uid}:Up/Downsample pair => "
                   f"Downsample({sx}x{sy})")


# --------------------------------------------------------------------------
# the resident rule library, in priority order

RULES: List[RewriteRule] = [
    RewriteRule("conv2d", _CONV_PAT, _conv_build, guard=_conv_guard,
                backends=("kernels",)),
    RewriteRule("sad", _SAD_PAT, _sad_build, guard=_sad_guard,
                backends=("kernels",)),
    RewriteRule("separable_conv", _SEP_PAT, _sep_build, guard=_sep_guard),
    RewriteRule("window_sum", _WINSUM_PAT, _winsum_build,
                guard=_winsum_guard),
    RewriteRule("pyramid_down_up", _DOWN_UP, _down_up_build,
                guard=_down_up_guard),
    RewriteRule("pyramid_down_down", _DOWN_DOWN, _down_down_build),
    RewriteRule("pyramid_up_up", _UP_UP, _up_up_build),
]

# Rules whose only job is to pre-fuse Stencil->Map->Reduce chains into an
# opaque Dispatch.  The megakernel emitter streams those chains natively —
# and a Dispatch node is opaque to it, blocking fusion of the surrounding
# segment — so the engine skips these when megakernel emission is on.  The
# conv2d/sad dispatches stay, as do the pyramid algebraic collapses (they
# shrink the graph, which helps every path).
MK_SUBSUMED_RULES = frozenset({"separable_conv", "window_sum"})


def register_rule(rule: RewriteRule, priority: Optional[int] = None) -> None:
    """Add a fusion pattern to the resident library (see README: the rule's
    pattern is declarative data; higher priority = earlier index).  A rule
    runs on the backends it names (both by default), and also where
    megakernel emission is on: ``MK_SUBSUMED_RULES`` lists only the
    resident rules that the emitter streams."""
    RULES.insert(len(RULES) if priority is None else priority, rule)
