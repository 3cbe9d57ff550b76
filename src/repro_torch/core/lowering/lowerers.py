"""Generic per-operator torch lowerings (the LOWERERS table).

The torch counterpart of ``repro/core/lowering/lowerers.py``.  Each entry
maps one HWImg operator to an eager torch implementation, bit-exact against
the numpy executor by construction: integer values ride an int64 carrier
and every node's result is wrapped to its declared width by ``torch_mask``.

Layout: every value carries an explicit leading frame axis.  An image of
type ``ArrayT(e, w, h)`` is a tensor of shape ``(frames, h, w, ...)``;
values derived only from ``Const`` carry a size-1 frame axis that
broadcasts.  So every lowering below indexes the spatial axes as 1 and 2.

``Const`` has no entry: the engine moves each Const to the device once per
compiled pipeline.  ``External`` (the import of a foreign module that
carries a numpy model) is a host call: its operands are copied to the host,
``np_fn`` runs once per frame, and the results are copied back.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np
import torch

from ..dtypes import ArrayT, Bits, Int, SparseT, TupleT, UInt
from ..executor import _mask_result
from ..hwimg import PointFn, map_reshape_plans, scalar_of, type_shape
from .ir import IRNode

# --------------------------------------------------------------------------
# scalar function lowering: PointFn -> torch callable
#
# hwimg's np_fns call numpy ufuncs, ``.astype`` and ``a.dtype.kind``, none of
# which work on tensors, so every PointFn in hwimg.py has an explicit entry.


def _f32(a):
    return a.to(torch.float32)


def _float_div(a, b):
    # FloatDiv's b == 0 -> 0 rule (hwimg.FloatDiv).  numpy divides
    # float32(a) by an integer divisor in float64 and the executor rounds
    # the quotient once to float32; an integer divisor above 2**24 would
    # lose bits in float32.  A float or bool divisor stays in float32.
    safe = torch.where(b == 0, torch.ones_like(b), b)
    zero = torch.zeros((), dtype=torch.float32, device=a.device)
    if b.is_floating_point() or b.dtype == torch.bool:
        return torch.where(b != 0, _f32(a) / _f32(safe), zero)
    q = _f32(a).to(torch.float64) / safe.to(torch.float64)
    return torch.where(b != 0, q.to(torch.float32), zero)


def _float_sqrt(a):
    # FloatSqrt's clamp at 0 (hwimg.FloatSqrt: np.maximum(a, 0), which maps
    # -0.0 to +0.0 and keeps NaN).  torch's CPU float32 sqrt is not
    # correctly rounded (its vector path misses the IEEE result in about
    # 0.7 % of inputs); the float64 root rounded once to float32 is, since
    # double rounding is innocuous for sqrt when 53 >= 2 * 24 + 2.  An
    # integer operand goes to float64 straight from int64, as numpy takes
    # its root, never through float32.
    if not a.is_floating_point():
        x = torch.clamp(a.to(torch.int64), min=0).to(torch.float64)
        return torch.sqrt(x).to(torch.float32)
    x = _f32(a)
    x = torch.where(x <= 0, torch.zeros((), dtype=x.dtype, device=x.device),
                    x)
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _int_operand(a):
    # numpy promotes a bool operand of - and abs to an integer; torch
    # refuses both on bool
    return a.to(torch.int64) if a.dtype == torch.bool else a


def _rshift(n: int) -> Callable:
    def fn(a):
        return a / (2 ** n) if a.is_floating_point() else a >> n
    return fn


_TORCH_FNS: Dict[str, Callable[[Dict[str, Any]], Callable]] = {
    "Add": lambda p: (lambda a, b: a + b),
    "AddAsync": lambda p: (lambda a, b: a + b),
    "Sub": lambda p: (lambda a, b: _int_operand(a) - _int_operand(b)),
    "Mul": lambda p: (lambda a, b: a * b),
    "Abs": lambda p: (lambda a: torch.abs(_int_operand(a))),
    "AbsDiff": lambda p: (
        lambda a, b: torch.abs(a.to(torch.int64) - b.to(torch.int64))),
    "Max": lambda p: torch.maximum,
    "Min": lambda p: torch.minimum,
    "Gt": lambda p: (lambda a, b: a > b),
    "And": lambda p: torch.logical_and,
    "Rshift": lambda p: _rshift(p["n"]),
    "AddMSBs": lambda p: (lambda a: a),
    "RemoveMSBs": lambda p: (lambda a: a),
    "ToFloat": lambda p: _f32,
    "FloatMul": lambda p: (lambda a, b: _f32(a) * _f32(b)),
    "FloatAdd": lambda p: (lambda a, b: _f32(a) + _f32(b)),
    "FloatSub": lambda p: (lambda a, b: _f32(a) - _f32(b)),
    "FloatDiv": lambda p: _float_div,
    "FloatSqrt": lambda p: _float_sqrt,
}


def torch_point_fn(fn: PointFn) -> Callable:
    """The torch equivalent of ``fn.np_fn``.  A user PointFn outside the
    table is called as-is: one written as an operator expression
    (``a + b``, ``a >> n``) works on tensors unchanged."""
    if fn.name in _TORCH_FNS:
        return _TORCH_FNS[fn.name](dict(fn.params))
    return fn.np_fn


# --------------------------------------------------------------------------
# hardware wrap masking (the torch mirror of executor._mask_result)

def torch_mask(r, ty):
    if isinstance(r, tuple):
        if isinstance(ty, TupleT):
            return tuple(torch_mask(x, t) for x, t in zip(r, ty.elems))
        if isinstance(ty, ArrayT) and isinstance(ty.elem, TupleT):
            return tuple(torch_mask(x, t) for x, t in zip(r, ty.elem.elems))
        return r
    s = scalar_of(ty)
    if isinstance(s, (UInt, Bits)):
        return r.to(torch.int64) & ((1 << s.bits()) - 1)
    if isinstance(s, Int):
        n = s.bits()
        x = r.to(torch.int64) & ((1 << n) - 1)
        return torch.where(x >= (1 << (n - 1)), x - (1 << n), x)
    return r


# --------------------------------------------------------------------------
# generic per-operator lowerings (spatial axes are 1 and 2)

def torch_stencil(p, x):
    l, r, b, t = p["l"], p["r"], p["b"], p["t"]
    sw, sh = abs(r - l) + 1, abs(t - b) + 1
    n, h, w = x.shape[:3]
    pl, pt_ = max(0, -min(l, 0)), max(0, -min(b, 0))
    pr, pb_ = max(0, max(r + sw, sw)), max(0, max(t + sh, sh))
    xp = x.new_zeros((n, h + pt_ + pb_, w + pl + pr) + tuple(x.shape[3:]))
    xp[:, pt_:pt_ + h, pl:pl + w] = x
    rows = []
    for dy in range(sh):
        oy = pt_ + b + dy
        cols = [xp[:, oy:oy + h, pl + l + dx:pl + l + dx + w]
                for dx in range(sw)]
        rows.append(torch.stack(cols, dim=3))
    return torch.stack(rows, dim=3)


def _map_operand(a, plan, ity, out_ndim: int):
    """Align a Map operand to the output's (frames,) + type_shape layout:
    an outer-level operand gets trailing singleton axes (``plan``); any
    shallower one gets singleton axes between its frame axis and its own
    type axes, which is numpy's right-aligned broadcast with the frame axis
    kept in front."""
    if plan is not None:
        return a.reshape((a.shape[0],) + tuple(plan))
    s = type_shape(ity)
    if len(s) >= out_ndim:
        return a
    return a.reshape((a.shape[0],) + (1,) * (out_ndim - len(s)) + tuple(s))


def _lower_map(v: IRNode, p, ins):
    fn = torch_point_fn(p["fn"])
    plans = map_reshape_plans(v.ty, v.input_tys)
    k = len(type_shape(v.ty))
    return fn(*[_map_operand(a, plan, ity, k)
                for a, plan, ity in zip(ins, plans, v.input_tys)])


def _lower_reduce(v, p, ins):
    fn = torch_point_fn(p["fn"])
    x = ins[0]
    flat = x.reshape(tuple(x.shape[:-2]) + (-1,))
    acc = flat[..., 0]
    for i in range(1, flat.shape[-1]):
        acc = fn(acc, flat[..., i])
    return acc


def _lower_reduce_patch(v, p, ins):
    fn = torch_point_fn(p["fn"])
    x = ins[0]
    n_, h_, w_, sh_, sw_ = x.shape[:5]
    flat = x.reshape((n_, h_, w_, sh_ * sw_) + tuple(x.shape[5:]))
    acc = flat[:, :, :, 0]
    for i in range(1, sh_ * sw_):
        acc = fn(acc, flat[:, :, :, i])
    return acc


def _lower_argmin(v, p, ins):
    x = ins[0]
    flat = x.reshape(tuple(x.shape[:-2]) + (-1,))
    # torch.argmin returns the first minimum, as np.argmin does
    return torch.argmin(flat, dim=-1).to(torch.int64)


def _lower_pad(v, p, ins):
    x = ins[0]
    l, rr, b, t = p["l"], p["r"], p["b"], p["t"]
    out = torch.full((x.shape[0], x.shape[1] + b + t, x.shape[2] + l + rr)
                     + tuple(x.shape[3:]), p.get("value", 0), dtype=x.dtype,
                     device=x.device)
    out[:, t:t + x.shape[1], l:l + x.shape[2]] = x
    return out


def _lower_crop(v, p, ins):
    x = ins[0]
    l, rr, b, t = p["l"], p["r"], p["b"], p["t"]
    return x[:, t:x.shape[1] - b, l:x.shape[2] - rr]


def _lower_stack(v, p, ins):
    return torch.stack(torch.broadcast_tensors(*ins), dim=-1)[..., None, :]


def _lower_sparse_take(v, p, ins):
    vals, mask = ins[0]
    n = p["n"]
    frames = max(vals.shape[0], mask.shape[0])
    flat_v = vals.reshape((vals.shape[0], -1) + tuple(vals.shape[3:]))
    flat_v = flat_v.expand((frames,) + tuple(flat_v.shape[1:]))
    flat_m = mask.reshape(mask.shape[0], -1).expand(frames, -1)
    # stable sort of ~mask lists each frame's valid indices first, in order
    order = torch.sort((~flat_m).to(torch.int8), dim=1, stable=True).indices
    size = order.shape[1]
    if size < n:
        order = torch.cat([order, order.new_zeros((frames, n - size))], dim=1)
    idx = order[:, :n]
    count = torch.clamp(flat_m.sum(dim=1, keepdim=True), max=n)
    valid = torch.arange(n, device=idx.device)[None, :] < count
    gather_idx = idx.reshape((frames, n) + (1,) * (flat_v.dim() - 2))
    taken = torch.gather(flat_v, 1, gather_idx.expand(
        (frames, n) + tuple(flat_v.shape[2:])))
    vshape = (frames, n) + (1,) * (flat_v.dim() - 2)
    out_v = torch.where(valid.reshape(vshape), taken,
                        torch.zeros((), dtype=taken.dtype, device=idx.device))
    out_i = torch.where(valid, idx.to(torch.int64),
                        torch.zeros((), dtype=torch.int64, device=idx.device))
    return (out_v, out_i)


# --------------------------------------------------------------------------
# External: a synchronous host call of the module's numpy model
#
# The operands cross to the host in the executor's value layout (one numpy
# array per leaf, ints on the int64 carrier), ``np_fn`` runs once per frame
# in frame order, its result is wrapped to the declared widths by the
# executor's own ``_mask_result``, and the frames go back to the device as
# one tensor per leaf (the engine then applies ``torch_mask``).  An operand
# derived only from Consts has a size-1 frame axis and is passed to every
# frame.

def _flat_values(ty, val) -> List[Any]:
    """The leaves of a value of type ``ty``, in the executor's layout
    order."""
    if isinstance(ty, TupleT):
        return [x for t, v_ in zip(ty.elems, val) for x in _flat_values(t, v_)]
    if isinstance(ty, (SparseT, ArrayT)) and isinstance(val, tuple):
        return list(val)
    return [val]


def _unflat_values(ty, it):
    if isinstance(ty, TupleT):
        return tuple(_unflat_values(t, it) for t in ty.elems)
    if isinstance(ty, ArrayT) and isinstance(ty.elem, TupleT):
        return tuple(next(it) for _ in ty.elem.elems)
    if isinstance(ty, SparseT):
        return (next(it), next(it))
    return next(it)


def _lower_external(v: IRNode, p, ins):
    np_fn = p["np_fn"]
    leaves_in = [_flat_values(ty, val) for ty, val in zip(v.input_tys, ins)]
    if not any(leaves_in):
        raise ValueError(f"External {p['ext_name']!r} has no operand to "
                         "take its device and frames from")
    device = next(x.device for leaves in leaves_in for x in leaves)
    flat_in = [[x.cpu().numpy() for x in leaves] for leaves in leaves_in]
    frames = max(x.shape[0] for leaves in flat_in for x in leaves)
    per_frame = []
    for f in range(frames):
        args = [_unflat_values(ty, iter([x[f if x.shape[0] > 1 else 0]
                                         for x in leaves]))
                for ty, leaves in zip(v.input_tys, flat_in)]
        r = _mask_result(np_fn(*args), v.ty)
        per_frame.append([np.asarray(x) for x in _flat_values(v.ty, r)])
    out = []
    for leaf in zip(*per_frame):
        a = np.stack(leaf)
        if a.dtype.kind in "iu":
            a = a.astype(np.int64, copy=False)      # the integer carrier
        out.append(torch.from_numpy(a).to(device))
    return _unflat_values(v.ty, iter(out))


LOWERERS: Dict[str, Callable[[IRNode, Dict[str, Any], List[Any]], Any]] = {
    "TupleIndex": lambda v, p, ins: ins[0][p["i"]],
    "Concat": lambda v, p, ins: tuple(ins),
    "FanOut": lambda v, p, ins: tuple(ins[0] for _ in range(p["n"])),
    "FanIn": lambda v, p, ins: ins[0],
    "Map": _lower_map,
    "Reduce": _lower_reduce,
    "ReducePatch": _lower_reduce_patch,
    "ArgMin": _lower_argmin,
    "Replicate": lambda v, p, ins: ins[0][..., None, None].expand(
        tuple(ins[0].shape) + (p["m"], p["n"])),
    "Stack": _lower_stack,
    "Stencil": lambda v, p, ins: torch_stencil(p, ins[0]),
    "Pad": _lower_pad,
    "Crop": _lower_crop,
    "Downsample": lambda v, p, ins: ins[0][:, ::p["sy"], ::p["sx"]],
    "Upsample": lambda v, p, ins: ins[0].repeat_interleave(
        p["sy"], dim=1).repeat_interleave(p["sx"], dim=2),
    "Filter": lambda v, p, ins: (ins[0], ins[1].to(torch.bool)),
    "SparseTake": _lower_sparse_take,
    "External": _lower_external,
}
