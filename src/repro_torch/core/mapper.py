"""Mapping HWImg -> Rigel2 (paper §5).

Each HWImg operator is mapped *locally* by a mapping function to a hardware
generator instance that meets-or-exceeds the throughput and interface
requirements at its site (fig. 6/7); mismatched interfaces are then patched
with automatic conversions — Serialize / Deserialize / FanOut / Static->Stream
(fig. 8). No global optimization, by design.

A site is characterized by:
  - the solved SDF pixel rate (tokens/cycle at the outer array level, §4.1),
  - the schedule type (scalars per pixel payload, image extents),
  - the pipeline-level interface solve result (Static vs Stream, §5.1).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from fractions import Fraction
from typing import Dict, Optional, Tuple

from . import schedule as sched
from .dtypes import ArrayT, SparseT, DType
from .hwimg import OPS, PointFn, Val, scalar_count, scalar_of, toposort
from .rigel import (Interface, Resources, RModule, STATIC, STREAM,
                    ScheduleType, optimize_lanes)

WIRING_OPS = {"TupleIndex", "FanOut", "FanIn"}


# --------------------------------------------------------------------------
# site descriptions


@dataclass
class Site:
    val: Val
    px_rate: Fraction            # output pixels (outer elements) per cycle
    in_px_rate: Fraction         # input pixels per cycle (per input)
    kind: str                    # STATIC or STREAM (pipeline-level solve)


def _image_dims(t: DType) -> Tuple[int, int, int]:
    """(w, h, scalars-per-pixel) of a value type."""
    if isinstance(t, (ArrayT, SparseT)):
        return t.w, t.h, scalar_count(t) // (t.w * t.h)
    return 1, 1, scalar_count(t)


# --------------------------------------------------------------------------
# pipeline-level interface solve (paper §5.1)


def solve_interface(out: Val) -> str:
    """Pre-mapping pass: push a Static input through; if any mapping would
    return a Stream module, the whole pipeline is Stream."""
    for v in toposort(out):
        od = OPS[v.op]
        if od.stream_only or od.bursty:
            return STREAM
        fn = v.p.get("fn")
        if isinstance(fn, PointFn) and fn.data_dependent:
            return STREAM
    return STATIC


# --------------------------------------------------------------------------
# SDF rate propagation (paper §4.1)


def solve_rates(out: Val, T: Fraction) -> Dict[int, Fraction]:
    """Pixel-token rate of every node, from input throughput T (pixels/cycle
    of the pipeline input). Rates compose by multiplication of SDF ratios."""
    rates: Dict[int, Fraction] = {}
    order = toposort(out)
    for v in order:
        if v.op in ("Input",):
            rates[v.uid] = T
        elif v.op == "Const":
            rates[v.uid] = Fraction(0)  # register bank: always valid
        else:
            in_rates = [rates[i.uid] for i in v.inputs if rates[i.uid] != 0]
            base = in_rates[0] if in_rates else T
            for r in in_rates[1:]:
                # joins must agree (guaranteed by SDF solve on our op set)
                assert r == base, (v, in_rates)
            ratio = OPS[v.op].sdf(v.p, *[i.ty for i in v.inputs])
            rates[v.uid] = base * ratio
    return rates


# --------------------------------------------------------------------------
# mapping functions (paper §5.2, fig. 7) — one per operator family


def _mk_ifaces(v: Val, site: Site) -> Tuple[Optional[Interface], Interface, int]:
    """Choose input/output interfaces via type:optimize (fig. 6 red point).
    Returns (iface_in, iface_out, instances)."""
    w, h, pxs = _image_dims(v.ty)
    req_out = site.px_rate * pxs
    v_out, r_out = optimize_lanes(pxs, w, h, req_out) if req_out > 0 else (pxs, Fraction(1))
    inst = max(1, math.ceil(req_out / v_out)) if req_out > v_out else 1
    out_sched = ScheduleType(scalar_of(v.ty), w, h, pxs, v_out)
    iface_out = Interface(site.kind, out_sched)
    iface_in = None
    if v.inputs:
        it = v.inputs[0].ty
        iw, ih, ipxs = _image_dims(it)
        req_in = site.in_px_rate * ipxs
        v_in, _ = optimize_lanes(ipxs, iw, ih, req_in) if req_in > 0 else (ipxs, Fraction(1))
        iface_in = Interface(site.kind,
                             ScheduleType(scalar_of(it), iw, ih, ipxs, v_in))
    return iface_in, iface_out, inst


def _rate_of(site: Site, v_out: int, pxs: int) -> Fraction:
    r = site.px_rate * pxs / v_out
    return min(r, Fraction(1))


def map_map(v: Val, site: Site) -> RModule:
    fn: PointFn = v.p["fn"]
    iface_in, iface_out, inst = _mk_ifaces(v, site)
    lanes = iface_out.sched.v
    in_scalars = [scalar_of(i.ty) for i in v.inputs]
    luts, dsps = fn.lut_cost(*in_scalars)
    res = Resources(luts=luts * lanes, dsps=dsps * lanes,
                    regs=iface_out.sched.token_bits * max(1, fn.latency))
    kind = STREAM if fn.data_dependent else site.kind
    return RModule(f"map_{fn.name}", "Map", iface_in,
                   Interface(kind, iface_out.sched),
                   _rate_of(site, lanes, iface_out.sched.px_scalars),
                   fn.latency, burst=0, resources=res.scaled(inst),
                   src_uid=v.uid, info={"lanes": lanes, "instances": inst})


def map_reduce(v: Val, site: Site) -> RModule:
    """Paper fig. 7: multi-cycle (vectorized) reduction only if the reduction
    fn has zero latency; otherwise fully parallel tree."""
    fn: PointFn = v.p["fn"]
    in_ty = v.inputs[0].ty
    # innermost array being reduced
    inner = in_ty
    while isinstance(inner.elem, ArrayT):
        inner = inner.elem
    n = inner.size
    w, h, out_pxs = _image_dims(v.ty)
    req_in_scalars = site.px_rate * out_pxs * n  # consumes n per output elem
    s_in = scalar_of(in_ty)
    luts1, dsps1 = fn.lut_cost(s_in, s_in)

    if fn.latency > 0:
        lanes = n * max(1, math.ceil(req_in_scalars / n))  # fully parallel
        seq_cycles = 1
    else:
        lanes, _ = optimize_lanes(n, w * out_pxs, h, req_in_scalars)
        seq_cycles = math.ceil(n / min(lanes, n))
    tree_v = min(lanes, n)
    n_binops = (tree_v - 1) + (1 if seq_cycles > 1 else 0)
    inst = max(1, lanes // n)
    latency = seq_cycles - 1 + max(1, math.ceil(math.log2(max(2, tree_v)))) \
        * max(1, fn.latency)
    res = Resources(luts=luts1 * n_binops + 16,
                    dsps=dsps1 * n_binops,
                    regs=s_in.bits() * tree_v).scaled(inst)
    gen = "Reduce" if seq_cycles == 1 else "ReduVec"
    out_sched = ScheduleType(scalar_of(v.ty), w, h, out_pxs,
                             min(max(1, math.ceil(site.px_rate * out_pxs)), out_pxs * w))
    _, iface_out, _ = _mk_ifaces(v, site)
    iface_in = Interface(site.kind,
                         ScheduleType(s_in, *_image_dims(in_ty)[:2],
                                      _image_dims(in_ty)[2], lanes))
    return RModule(f"reduce_{fn.name}", gen, iface_in, iface_out,
                   _rate_of(site, iface_out.sched.v, out_pxs),
                   latency, burst=0, resources=res, src_uid=v.uid,
                   info={"lanes": lanes, "seq_cycles": seq_cycles,
                         "instances": inst})


def map_reduce_patch(v: Val, site: Site) -> RModule:
    """One adder tree per vector lane over the patch taps (STEREO SAD)."""
    fn: PointFn = v.p["fn"]
    in_ty = v.inputs[0].ty
    patch = in_ty.elem           # ArrayT(inner, sw, sh)
    inner = patch.elem           # ArrayT(e, iw, ih)
    n, k = patch.w * patch.h, inner.w * inner.h
    w, h, out_pxs = _image_dims(v.ty)
    s_in = scalar_of(in_ty)
    req = site.px_rate * n * k
    lanes, _ = optimize_lanes(n * k, w, h, req)
    luts1, dsps1 = fn.lut_cost(s_in, s_in)
    trees = max(1, lanes // n)               # parallel lanes (one tree each)
    per_tree = min(lanes, n)
    seq = math.ceil(n / per_tree)
    n_binops = (per_tree - 1 + (1 if seq > 1 else 0)) * trees
    latency = seq - 1 + max(1, math.ceil(math.log2(max(2, per_tree)))) \
        * max(1, fn.latency)
    res = Resources(luts=luts1 * n_binops + 16, dsps=dsps1 * n_binops,
                    regs=s_in.bits() * per_tree * trees)
    _, iface_out, _ = _mk_ifaces(v, site)
    iface_in = Interface(site.kind, ScheduleType(s_in, w, h, n * k, lanes))
    return RModule(f"redpatch_{fn.name}", "ReducePatch", iface_in, iface_out,
                   _rate_of(site, iface_out.sched.v, out_pxs), latency,
                   resources=res, src_uid=v.uid,
                   info={"lanes": lanes, "trees": trees, "seq_cycles": seq})


def map_replicate(v: Val, site: Site) -> RModule:
    """Broadcast wires: no logic, no latency."""
    _, iface_out, _ = _mk_ifaces(v, site)
    in_ty = v.inputs[0].ty
    iw, ih, ipxs = _image_dims(in_ty)
    iface_in = Interface(site.kind,
                         ScheduleType(scalar_of(in_ty), iw, ih, ipxs,
                                      max(1, math.ceil(site.in_px_rate * ipxs))))
    return RModule("replicate", "Replicate", iface_in, iface_out,
                   _rate_of(site, iface_out.sched.v, iface_out.sched.px_scalars),
                   0, resources=Resources(), src_uid=v.uid)


def map_concat(v: Val, site: Site) -> RModule:
    """Tuple synchronizer (fig. 8 Fan-In hardware)."""
    first = v.inputs[0].ty
    w, h, pxs = _image_dims(first)
    total_bits = sum(scalar_of(i.ty).bits() *
                     max(1, math.ceil(site.px_rate * _image_dims(i.ty)[2]))
                     for i in v.inputs)
    vv, _ = optimize_lanes(pxs, w, h, site.px_rate * pxs)
    out_sched = ScheduleType(scalar_of(first), w, h, pxs, vv)
    return RModule("concat", "Concat",
                   Interface(site.kind, out_sched),
                   Interface(site.kind, out_sched),
                   _rate_of(site, vv, pxs), 0,
                   resources=Resources(luts=8 * len(v.inputs)),
                   src_uid=v.uid)


def map_argmin(v: Val, site: Site) -> RModule:
    in_ty = v.inputs[0].ty
    inner = in_ty
    while isinstance(inner.elem, ArrayT):
        inner = inner.elem
    n = inner.size
    w, h, out_pxs = _image_dims(v.ty)
    req = site.px_rate * out_pxs * n
    lanes, _ = optimize_lanes(n, w, h, req)
    s_in = scalar_of(in_ty)
    cmp_luts = 2 * s_in.bits() + 8  # compare + select of (val, idx)
    seq = math.ceil(n / min(lanes, n))
    latency = seq - 1 + math.ceil(math.log2(max(2, min(lanes, n))))
    res = Resources(luts=cmp_luts * max(1, min(lanes, n) - 1) + 32,
                    regs=(s_in.bits() + 16) * min(lanes, n))
    _, iface_out, _ = _mk_ifaces(v, site)
    iface_in = Interface(site.kind, ScheduleType(s_in, w, h, n, lanes))
    return RModule("argmin", "ArgMin", iface_in, iface_out,
                   _rate_of(site, iface_out.sched.v, out_pxs), latency,
                   resources=res, src_uid=v.uid, info={"lanes": lanes})


def map_stencil(v: Val, site: Site) -> RModule:
    p = v.p
    in_ty = v.inputs[0].ty
    sw = abs(p["r"] - p["l"]) + 1
    sh = abs(p["t"] - p["b"]) + 1
    w, h, _ = _image_dims(in_ty)
    s = scalar_of(in_ty)
    px_per_cycle = max(Fraction(1), site.px_rate)
    # line buffers: (sh-1) full rows in BRAM; window regs extend with output
    # parallelism (paper §2.1 figure: compute at various throughputs)
    out_px = max(1, math.ceil(site.px_rate))
    res = Resources(luts=64,
                    regs=(sw + out_px - 1) * sh * s.bits(),
                    bram_bits=(sh - 1) * w * s.bits())
    # first patch available after (sh-1) rows + sw pixels arrive
    in_px_rate = max(site.in_px_rate, Fraction(1, 10 ** 9))
    latency = math.ceil(Fraction((sh - 1) * w + sw, in_px_rate))
    _, iface_out, _ = _mk_ifaces(v, site)
    iface_in = Interface(site.kind, ScheduleType(s, w, h, 1,
                                                 max(1, math.ceil(site.in_px_rate))))
    return RModule("stencil", "Stencil", iface_in, iface_out,
                   _rate_of(site, iface_out.sched.v, iface_out.sched.px_scalars),
                   latency, resources=res, src_uid=v.uid,
                   info={"window": (sw, sh), "linebuf_rows": sh - 1})


def _map_border(v: Val, site: Site, tracefn) -> RModule:
    """Pad / Crop / Downsample: control-only modules with bursty traces.
    (L, B) are fitted from a cycle simulation of the module's behavior, as
    the paper recommends (§4.3)."""
    p = v.p
    in_ty = v.inputs[0].ty
    w, h, _ = _image_dims(in_ty)
    ratio = OPS[v.op].sdf(p, in_ty)
    actual = tracefn()
    # the fit is done at the module's own clock: amplifiers (Pad) emit one
    # token per cycle post-SDF-normalization, so their model rate is 1
    L, B = sched.fit_LB(actual, min(Fraction(ratio), Fraction(1)))
    # the fit is in pixel units; the FIFO holds V-wide tokens
    _, _iface_out_probe, _ = _mk_ifaces(v, site)
    B = math.ceil(B / max(1, _iface_out_probe.sched.v))
    # scale latency with the site's actual input rate
    in_rate = site.in_px_rate if site.in_px_rate > 0 else Fraction(1)
    L = math.ceil(Fraction(L, 1) / in_rate) if in_rate < 1 else L
    _, iface_out, _ = _mk_ifaces(v, site)
    iface_in = Interface(site.kind,
                         ScheduleType(scalar_of(in_ty), w, h, 1,
                                      max(1, math.ceil(site.in_px_rate))))
    res = Resources(luts=48 + iface_out.sched.token_bits // 4, regs=48)
    # the cycle simulator (hwsim/) rebuilds this module's exact
    # consumption->production profile from the border geometry
    geom = {"in_w": w, "in_h": h}
    geom.update({k: p[k] for k in ("l", "r", "b", "t", "sx", "sy")
                 if k in p})
    return RModule(v.op.lower(), v.op, iface_in, iface_out,
                   _rate_of(site, iface_out.sched.v, 1), max(1, L), burst=B,
                   resources=res, src_uid=v.uid, info={"geom": geom})


def map_pad(v: Val, site: Site) -> RModule:
    p, t = v.p, v.inputs[0].ty
    return _map_border(
        v, site, lambda: sched.pad_trace(t.w, t.h, p["l"], p["r"], p["b"], p["t"]))


def map_crop(v: Val, site: Site) -> RModule:
    p, t = v.p, v.inputs[0].ty
    return _map_border(
        v, site, lambda: sched.crop_trace(t.w, t.h, p["l"], p["r"], p["b"], p["t"]))


def map_downsample(v: Val, site: Site) -> RModule:
    p, t = v.p, v.inputs[0].ty
    return _map_border(
        v, site, lambda: sched.downsample_trace(t.w, t.h, p["sx"], p["sy"]))


def map_upsample(v: Val, site: Site) -> RModule:
    _, iface_out, _ = _mk_ifaces(v, site)
    in_ty = v.inputs[0].ty
    iface_in = Interface(site.kind,
                         ScheduleType(scalar_of(in_ty), in_ty.w, in_ty.h, 1,
                                      max(1, math.ceil(site.in_px_rate))))
    return RModule("upsample", "Upsample", iface_in, iface_out,
                   _rate_of(site, iface_out.sched.v, 1), 1,
                   resources=Resources(luts=32, regs=iface_out.sched.token_bits),
                   src_uid=v.uid)


def map_filter(v: Val, site: Site) -> RModule:
    """Sparse filter (§4.3): data-dependent burstiness, user-annotated."""
    B = v.p["expected_burst"]
    _, iface_out, _ = _mk_ifaces(v, site)
    iface_out = Interface(STREAM, iface_out.sched)
    in_ty = v.inputs[0].ty
    iface_in = Interface(STREAM,
                         ScheduleType(scalar_of(in_ty), in_ty.w, in_ty.h, 1,
                                      max(1, math.ceil(site.in_px_rate))))
    return RModule("filter", "Filter", iface_in, iface_out,
                   _rate_of(site, iface_out.sched.v, 1), 2, burst=B,
                   resources=Resources(luts=64, regs=64), src_uid=v.uid)


def map_sparse_take(v: Val, site: Site) -> RModule:
    n = v.p["n"]
    _, iface_out, _ = _mk_ifaces(v, site)
    iface_out = Interface(STREAM, iface_out.sched)
    return RModule("sparse_take", "SparseTake", iface_out, iface_out,
                   _rate_of(site, iface_out.sched.v, iface_out.sched.px_scalars),
                   2, burst=min(n, 64),
                   resources=Resources(luts=64 + 32, regs=64), src_uid=v.uid)


def map_external(v: Val, site: Site) -> RModule:
    p = v.p
    _, iface_out, _ = _mk_ifaces(v, site)
    iface_out = Interface(STREAM, iface_out.sched)
    return RModule(f"ext_{p['ext_name']}", "External", iface_out, iface_out,
                   min(Fraction(p["rate"]), Fraction(1)), p["latency"],
                   burst=p["burst"],
                   resources=Resources(luts=p["luts"], dsps=p["dsps"]),
                   src_uid=v.uid)


def map_input(v: Val, site: Site) -> RModule:
    w, h, pxs = _image_dims(v.ty)
    vv, _ = optimize_lanes(pxs, w, h, site.px_rate * pxs)
    s = ScheduleType(scalar_of(v.ty), w, h, pxs, vv)
    return RModule("input", "Input", None, Interface(site.kind, s),
                   _rate_of(site, vv, pxs), 0,
                   resources=Resources(), src_uid=v.uid)


def map_const(v: Val, site: Site) -> RModule:
    w, h, pxs = _image_dims(v.ty)
    s = ScheduleType(scalar_of(v.ty), w, h, pxs, pxs * w * h)
    bits = scalar_of(v.ty).bits() * pxs * w * h
    return RModule("coeffs", "Const", None, Interface(STATIC, s),
                   Fraction(1), 0, resources=Resources(regs=bits),
                   src_uid=v.uid)


MAPPERS = {
    "Input": map_input, "Const": map_const, "Map": map_map,
    "Reduce": map_reduce, "ReducePatch": map_reduce_patch,
    "Replicate": map_replicate, "Concat": map_concat, "Stack": map_concat,
    "ArgMin": map_argmin, "Stencil": map_stencil,
    "Pad": map_pad, "Crop": map_crop, "Downsample": map_downsample,
    "Upsample": map_upsample, "Filter": map_filter,
    "SparseTake": map_sparse_take, "External": map_external,
}


# --------------------------------------------------------------------------
# conversion insertion (paper §5.3, fig. 8)


def make_converter(prod: RModule, cons_lanes: int, kind: str) -> Optional[RModule]:
    """Serialize (V down) / Deserialize (V up) between mismatched vector
    widths; Static->Stream promotion is free (kind change only)."""
    pv = prod.iface_out.sched.v
    if pv == cons_lanes:
        return None
    s = prod.iface_out.sched
    new_sched = ScheduleType(s.scalar, s.w, s.h, s.px_scalars, cons_lanes)
    if cons_lanes < pv:
        name, gen = "serialize", "Serialize"
        latency = 1
        rate = prod.rate * pv / cons_lanes
    else:
        name, gen = "deserialize", "Deserialize"
        latency = math.ceil(cons_lanes / pv)
        rate = prod.rate * pv / cons_lanes
    buf_bits = max(pv, cons_lanes) * s.scalar.bits()
    return RModule(name, gen, prod.iface_out, Interface(kind, new_sched),
                   min(rate, Fraction(1)), latency,
                   resources=Resources(luts=24 + buf_bits // 8, regs=buf_bits))


def make_fanout(prod: RModule, n: int, kind: str) -> RModule:
    res = Resources(luts=4 * n if kind == STREAM else 0, regs=8)
    return RModule("fanout", "FanOut", prod.iface_out, prod.iface_out,
                   prod.rate, 0, resources=res)
