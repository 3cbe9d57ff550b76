"""The resident rewrite rules (the declarative fusion pattern library).

The torch counterpart of ``repro/core/lowering/patterns.py``, holding the
two kernel-dispatch rules of this port:

  conv2d        Stencil -> Map(Mul)(., Const) -> Reduce(Add) -> Rshift ->
                RemoveMSBs            =>  kernels/conv2d   (kernels only)
  sad           Stencil(1 x nd) -> Map(AbsDiff)(Replicate(L)|L, .) ->
                Stencil(bh x bw) -> ReducePatch(Add) -> ArgMin
                                      =>  kernels/sad      (kernels only)

Patterns and guards are the reference's, unchanged.  Every rule fires only
when provably bit-exact against the executor: the guards bound the
worst-case accumulator magnitude so the executor's per-step width masking
is the identity, and so the kernels' int32 sums cannot overflow (signed
overflow is undefined in CUDA C++).  The reference's separable_conv,
window_sum and pyramid rules come with the megakernel slice.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..dtypes import ArrayT, Bits, Float, Int, TupleT, UInt, mask_to_width
from .ir import Dispatch, IRNode
from .rewrite import Chain, Either, Leaf, Many, Match, Opt, OpPat, RewriteRule

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
# the resident rule library, in priority order

RULES: List[RewriteRule] = [
    RewriteRule("conv2d", _CONV_PAT, _conv_build, guard=_conv_guard,
                backends=("kernels",)),
    RewriteRule("sad", _SAD_PAT, _sad_build, guard=_sad_guard,
                backends=("kernels",)),
]

