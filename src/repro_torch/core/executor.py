"""Bit-accurate reference executor for HWImg DAGs.

The "Verilator analog" (paper §6): evaluates the logical array semantics of
every operator with hardware wrap/width behavior, so mapped hardware (and the
torch lowerings and CUDA kernels) can be verified to produce exactly the same
output as the reference.  A copy of the reference package's executor, float64
result of a Float operand mixed with an integer one in Add or Max included.

Vector widths / rates are *schedule*, not semantics, so they never appear
here.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

from .dtypes import ArrayT, TupleT, mask_to_width
from .hwimg import Val, map_operand_reshapes, scalar_of, toposort


def _np_stencil(p, x: np.ndarray) -> np.ndarray:
    l, r, b, t = p["l"], p["r"], p["b"], p["t"]
    sw, sh = abs(r - l) + 1, abs(t - b) + 1
    h, w = x.shape[:2]
    pl, pt_ = max(0, -min(l, 0)), max(0, -min(b, 0))
    pr, pb_ = max(0, max(r + sw, sw)), max(0, max(t + sh, sh))
    xp = np.zeros((h + pt_ + pb_, w + pl + pr) + x.shape[2:], dtype=x.dtype)
    xp[pt_:pt_ + h, pl:pl + w] = x
    out = np.empty((h, w, sh, sw) + x.shape[2:], dtype=x.dtype)
    for dy in range(sh):
        for dx in range(sw):
            oy, ox = b + dy, l + dx
            out[:, :, dy, dx] = xp[pt_ + oy:pt_ + oy + h,
                                   pl + ox:pl + ox + w]
    return out


def _map_args(v: Val, ins):
    """Broadcast-align map operands: scalars/smaller arrays broadcast against
    the deepest-nested operand. Operands matching the *outer* levels of the
    output type (a per-pixel image combined with per-pixel patches) get
    trailing singleton axes; inner-level operands (coefficient arrays) are
    already handled by numpy's right-aligned broadcasting."""
    return [i if plan is None else np.asarray(i).reshape(plan)
            for i, plan in zip(ins, map_operand_reshapes(v))]


def _apply_scalar_fn(fn, args):
    args = [np.asarray(a) for a in args]
    # right-align trailing dims (numpy broadcasting is already right-aligned)
    return fn.np_fn(*args)


def evaluate(out: Val, inputs: Dict[str, np.ndarray]) -> Any:
    """Evaluate the DAG rooted at ``out``; ``inputs`` maps Input names to
    ndarrays of shape (h, w, ...)."""
    env: Dict[int, Any] = {}

    for v in toposort(out):
        p = v.p
        ins = [env[i.uid] for i in v.inputs]
        name = v.op

        if name == "Input":
            raw = inputs[p["name"]]
            if isinstance(v.ty, TupleT):
                r = tuple(np.asarray(e) for e in raw)
            else:
                r = np.asarray(raw)
        elif name == "Const":
            r = np.asarray(p["value"])
        elif name == "TupleIndex":
            r = ins[0][p["i"]]
        elif name == "Concat":
            r = tuple(ins)
        elif name == "FanOut":
            r = tuple(ins[0] for _ in range(p["n"]))
        elif name == "FanIn":
            r = ins[0]
        elif name == "Map":
            r = _apply_scalar_fn(p["fn"], _map_args(v, ins))
        elif name == "Reduce":
            fn = p["fn"]
            x = ins[0]
            # reduce the innermost array level: last two type axes
            flat = x.reshape(x.shape[:-2] + (-1,))
            acc = flat[..., 0]
            for i in range(1, flat.shape[-1]):
                acc = fn.np_fn(acc, flat[..., i])
            r = acc
        elif name == "ReducePatch":
            fn = p["fn"]
            x = ins[0]
            # shape (h, w, sh, sw, ih, iw): fold the (sh, sw) patch axes
            h_, w_, sh_, sw_ = x.shape[:4]
            flat = x.reshape((h_, w_, sh_ * sw_) + x.shape[4:])
            acc = flat[:, :, 0]
            for i in range(1, sh_ * sw_):
                acc = fn.np_fn(acc, flat[:, :, i])
            r = acc
        elif name == "ArgMin":
            x = ins[0]
            flat = x.reshape(x.shape[:-2] + (-1,))
            r = np.argmin(flat, axis=-1).astype(np.int64)
        elif name == "Replicate":
            x = ins[0]
            r = np.broadcast_to(x[..., None, None],
                                x.shape + (p["m"], p["n"])).copy()
        elif name == "Stack":
            r = np.stack(ins, axis=-1)[..., None, :]
        elif name == "Stencil":
            r = _np_stencil(p, ins[0])
        elif name == "Pad":
            x = ins[0]
            l, rr, b, t = p["l"], p["r"], p["b"], p["t"]
            r = np.full((x.shape[0] + b + t, x.shape[1] + l + rr) + x.shape[2:],
                        p.get("value", 0), dtype=x.dtype)
            r[t:t + x.shape[0], l:l + x.shape[1]] = x
        elif name == "Crop":
            x = ins[0]
            l, rr, b, t = p["l"], p["r"], p["b"], p["t"]
            r = x[t:x.shape[0] - b, l:x.shape[1] - rr]
        elif name == "Downsample":
            r = ins[0][::p["sy"], ::p["sx"]]
        elif name == "Upsample":
            r = np.repeat(np.repeat(ins[0], p["sy"], axis=0), p["sx"], axis=1)
        elif name == "Filter":
            r = (ins[0], np.asarray(ins[1]).astype(bool))
        elif name == "SparseTake":
            vals, mask = ins[0]
            flat_v = vals.reshape((-1,) + vals.shape[2:])
            flat_m = mask.reshape(-1)
            idx = np.nonzero(flat_m)[0][: p["n"]]
            n = p["n"]
            out_v = np.zeros((n,) + flat_v.shape[1:], dtype=flat_v.dtype)
            out_i = np.zeros((n,), dtype=np.int64)
            out_v[: len(idx)] = flat_v[idx]
            out_i[: len(idx)] = idx
            r = (out_v, out_i)
        elif name == "External":
            r = p["np_fn"](*ins)
        else:
            raise NotImplementedError(name)

        env[v.uid] = _mask_result(r, v.ty)

    return env[out.uid]


def _mask_result(r, ty):
    if isinstance(r, tuple):
        if isinstance(ty, TupleT):
            return tuple(_mask_result(x, t) for x, t in zip(r, ty.elems))
        if isinstance(ty, ArrayT) and isinstance(ty.elem, TupleT):
            return tuple(_mask_result(x, with_elem)
                         for x, with_elem in zip(r, ty.elem.elems))
        return r
    s = scalar_of(ty)
    return mask_to_width(np.asarray(r), s)
