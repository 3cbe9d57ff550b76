"""Pass 1 of the static verifier: value-range analysis over the HWImg DAG.

Interval abstract interpretation with the executor's exact wrap semantics
(core/executor.py masks each node's result ONCE, at node end, via
``dtypes.mask_to_width``; Reduce/ReducePatch intermediates accumulate
unmasked in the int64 carrier).  For every node we track two intervals:

  - the *math* interval — the result of the node's arithmetic before the
    end-of-node mask.  If it fits the declared type the node is ``proven``
    wrap-free; otherwise the interval is the wrap *witness*.
  - the *value* interval — the post-mask interval that flows downstream.
    For a proven node it equals the math interval; for a wrapping node it
    is the declared type's full range (a wrapped value can be anything).

Intervals are numpy ``object``-dtype arrays of Python ints, so the analysis
itself is immune to the 64-bit carrier overflow it reasons about.  Interval
arrays are *suffix-aligned* with ``type_shape``: an interval of shape ``s``
describes the trailing ``len(s)`` axes uniformly across the leading ones —
the same right-aligned convention numpy broadcasting (and therefore the
executor) uses.  ``Const`` coefficient banks keep element-wise intervals,
which is what lets the conv pipeline's Stencil -> Map(Mul, Const) ->
Reduce(AddAsync) chain prove the exact per-kernel-sum bound rather than
count-times-max.

The proven post-mask interval also yields ``proven_bits`` — the narrowest
carrier that holds every value the node can take — which
``narrowed_token_bits`` maps onto the RModule netlist so FIFOs can be
priced at proven widths (hwsim/area.py).

Host code, a copy of the reference's: it touches no device and loads no
torch.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.dtypes import ArrayT, Bits, BoolT, DType, Int, TupleT, UInt
from ..core.hwimg import (PointFn, Val, map_reshape_plans, scalar_of,
                          toposort, type_shape)

# interval arrays larger than this collapse to their scalar hull (analysis
# cost guard; full-size Const banks stay exact, images never materialize)
SIZE_CAP = 1 << 16


# --------------------------------------------------------------------------
# exact object-int interval arrays


def _obj(x) -> np.ndarray:
    """Copy into an object-dtype array of Python ints (exact arithmetic)."""
    arr = np.asarray(x)
    out = np.empty(arr.shape, dtype=object)
    if arr.shape:
        out[...] = np.array(arr.tolist(), dtype=object).reshape(arr.shape)
    else:
        out[...] = int(arr)
    return out


@dataclass(frozen=True)
class Iv:
    """An interval array: ``lo[i] <= value[i] <= hi[i]`` elementwise."""

    lo: np.ndarray                      # object dtype, Python ints
    hi: np.ndarray

    def __post_init__(self):
        # numpy ufuncs on 0-d object arrays return bare Python scalars;
        # re-wrap so .size/.ndim/broadcasting always work
        if not isinstance(self.lo, np.ndarray):
            object.__setattr__(self, "lo", _obj(self.lo))
        if not isinstance(self.hi, np.ndarray):
            object.__setattr__(self, "hi", _obj(self.hi))

    @staticmethod
    def point(v: int) -> "Iv":
        return Iv(_obj(int(v)), _obj(int(v)))

    @staticmethod
    def of(lo, hi) -> "Iv":
        return Iv(_obj(lo), _obj(hi))

    @property
    def min(self) -> int:
        return int(np.min(self.lo))

    @property
    def max(self) -> int:
        return int(np.max(self.hi))

    @property
    def ndim(self) -> int:
        return self.lo.ndim

    def collapse(self) -> "Iv":
        """Scalar hull of the interval array."""
        return Iv.of(self.min, self.max)

    def hull(self, v: int) -> "Iv":
        """Widen elementwise to also contain the constant ``v``."""
        return Iv(np.minimum(self.lo, _obj(v)), np.maximum(self.hi, _obj(v)))

    def capped(self) -> "Iv":
        return self.collapse() if self.lo.size > SIZE_CAP else self


def _type_range(t: DType) -> Optional[Tuple[int, int]]:
    """Representable range of a scalar type (None for floats)."""
    if isinstance(t, (UInt, Bits)):
        return (0, (1 << t.nbits) - 1)
    if isinstance(t, Int):
        return (-(1 << (t.nbits - 1)), (1 << (t.nbits - 1)) - 1)
    if isinstance(t, BoolT):
        return (0, 1)
    return None


def _type_iv(t: DType) -> Optional[Iv]:
    r = _type_range(t)
    return None if r is None else Iv.of(*r)


def _clip_to_type(iv: Iv, trange: Tuple[int, int]) -> Iv:
    """Post-mask interval: elements proven in range keep their interval,
    elements that can wrap get the full type range (the hull of all the
    residues a wrapped value can land on)."""
    tmin, tmax = trange
    wraps = (iv.lo < tmin) | (iv.hi > tmax)
    if not np.any(wraps):
        return iv
    return Iv(np.where(wraps, _obj(tmin), iv.lo),
              np.where(wraps, _obj(tmax), iv.hi))


def _min_bits(lo: int, hi: int, signed: bool) -> int:
    """Narrowest two's-complement / unsigned width holding [lo, hi]."""
    if signed:
        need_hi = int(hi).bit_length() + 1 if hi > 0 else 1
        need_lo = (int(-lo) - 1).bit_length() + 1 if lo < 0 else 1
        return max(need_hi, need_lo)
    return max(1, int(hi).bit_length())


# --------------------------------------------------------------------------
# scalar transfer functions (pre-mask math intervals)


def _fn_interval(fn: PointFn, args: List[Optional[Iv]]) -> Optional[Iv]:
    """Math interval of one PointFn application (None = unknown/float)."""
    name = fn.name
    if name in ("Gt", "And"):
        return Iv.of(0, 1)              # defined even over float operands
    if any(a is None for a in args):
        return None
    if name in ("Add", "AddAsync"):
        a, b = args
        return Iv(a.lo + b.lo, a.hi + b.hi)
    if name == "Sub":
        a, b = args
        return Iv(a.lo - b.hi, a.hi - b.lo)
    if name == "Mul":
        a, b = args
        ll, lh, hl, hh = a.lo * b.lo, a.lo * b.hi, a.hi * b.lo, a.hi * b.hi
        return Iv(np.minimum(np.minimum(ll, lh), np.minimum(hl, hh)),
                  np.maximum(np.maximum(ll, lh), np.maximum(hl, hh)))
    if name == "Abs":
        (a,) = args
        alo, ahi = np.abs(a.lo), np.abs(a.hi)
        lo = np.where((a.lo <= 0) & (a.hi >= 0), _obj(0),
                      np.minimum(alo, ahi))
        return Iv(lo, np.maximum(alo, ahi))
    if name == "AbsDiff":
        d = _fn_interval(
            PointFn("Sub", 2, None, None, None), args)  # type: ignore[arg-type]
        return _fn_interval(
            PointFn("Abs", 1, None, None, None), [d])   # type: ignore[arg-type]
    if name == "Max":
        a, b = args
        return Iv(np.maximum(a.lo, b.lo), np.maximum(a.hi, b.hi))
    if name == "Min":
        a, b = args
        return Iv(np.minimum(a.lo, b.lo), np.minimum(a.hi, b.hi))
    if name == "Rshift":
        (a,) = args
        n = dict(fn.params)["n"]
        shift = np.frompyfunc(lambda v: v >> n, 1, 1)
        return Iv(shift(a.lo), shift(a.hi))
    if name in ("AddMSBs", "RemoveMSBs"):
        return args[0]                  # value-identity width adjustments
    return None                         # float ops / unknown imports


# --------------------------------------------------------------------------
# per-node records and the report


@dataclass
class NodeRange:
    uid: int
    op: str
    detail: str                         # PointFn name etc., for the report
    status: str                         # proven | wraps | assumed | float
    declared: DType                     # scalar leaf type
    math_lo: Optional[int] = None       # pre-mask hull (wrap witness)
    math_hi: Optional[int] = None
    lo: Optional[int] = None            # post-mask hull
    hi: Optional[int] = None
    proven_bits: Optional[int] = None   # narrowest sufficient carrier
    # tuple-typed nodes (SparseTake): per-component proven widths, None
    # where a component is float / unproven and keeps its declared width
    component_bits: Optional[Tuple[Optional[int], ...]] = None

    def line(self) -> str:
        tag = f"%{self.uid}={self.op}" + (f"({self.detail})"
                                          if self.detail else "")
        s = f"  {tag:32s} {self.status:8s} {self.declared!r}"
        if self.math_lo is not None:
            s += f"  math=[{self.math_lo}, {self.math_hi}]"
        if self.proven_bits is not None:
            s += f"  proven_bits={self.proven_bits}"
        if self.component_bits is not None:
            s += f"  component_bits={self.component_bits}"
        return s


@dataclass
class RangeReport:
    """analyze()'s result: per-node range records, schedule order, and the
    wrap-freedom verdict the CLI gate consumes."""

    nodes: Dict[int, NodeRange] = field(default_factory=dict)
    order: List[int] = field(default_factory=list)

    @property
    def witnesses(self) -> List[NodeRange]:
        return [self.nodes[u] for u in self.order
                if self.nodes[u].status == "wraps"]

    @property
    def assumed(self) -> List[NodeRange]:
        return [self.nodes[u] for u in self.order
                if self.nodes[u].status == "assumed"]

    @property
    def wrap_free(self) -> bool:
        """Every integer node proven (no witnesses, nothing assumed)."""
        return not self.witnesses and not self.assumed

    @property
    def decided(self) -> bool:
        """Every integer node either proven or carrying a wrap witness —
        the verify gate's 'wrap-free or witnessed' (imports excepted)."""
        return all(n.status in ("proven", "wraps", "float")
                   for n in self.nodes.values())

    def proven_scalar_bits(self, uid: int) -> Optional[int]:
        n = self.nodes.get(uid)
        return n.proven_bits if n is not None else None

    def report_lines(self, verbose: bool = False) -> List[str]:
        counts: Dict[str, int] = {}
        for n in self.nodes.values():
            counts[n.status] = counts.get(n.status, 0) + 1
        summary = " ".join(f"{k}={counts[k]}" for k in
                           ("proven", "wraps", "assumed", "float")
                           if k in counts)
        lines = [f"ranges: {len(self.nodes)} nodes  {summary}  "
                 f"wrap_free={self.wrap_free}"]
        for n in (self.nodes[u] for u in self.order):
            if verbose or n.status in ("wraps", "assumed"):
                lines.append(n.line())
        return lines


# --------------------------------------------------------------------------
# the abstract interpreter


def _aligned_args(v: Val, env: Dict[int, object]) -> List[Optional[Iv]]:
    """Map operands aligned for suffix broadcasting: operands the executor
    reshapes to *outer* alignment collapse to their scalar hull (their
    per-element structure lands on axes our suffix convention cannot
    address); everything else broadcasts right-aligned as-is."""
    plans = map_reshape_plans(v.ty, [i.ty for i in v.inputs])
    out_nd = len(type_shape(v.ty))
    args: List[Optional[Iv]] = []
    for i, plan in zip(v.inputs, plans):
        iv = env.get(i.uid)
        if isinstance(iv, tuple):       # tuple operand: not interval-tracked
            iv = None
        if iv is not None and (plan is not None or iv.ndim > out_nd):
            iv = iv.collapse()
        args.append(iv)
    return args


def _reduce_interval(fn: PointFn, iv: Iv, n_reduced: int,
                     reduced_shape: Tuple[int, int]) -> Optional[Iv]:
    """Interval of folding ``n_reduced`` elements whose trailing
    ``reduced_shape`` axes the interval may or may not resolve.  The
    executor folds sequentially in the unmasked carrier, so sums are exact
    interval sums."""
    if fn.name not in ("Add", "AddAsync", "Max", "Min"):
        return None
    k = iv.ndim
    if k >= 2 and iv.lo.shape[-2:] == reduced_shape:
        covered = reduced_shape[0] * reduced_shape[1]
        lo, hi = iv.lo, iv.hi
        if fn.name in ("Add", "AddAsync"):
            lo, hi = lo.sum(axis=(-2, -1)), hi.sum(axis=(-2, -1))
        else:
            red = np.min if fn.name == "Min" else np.max
            lo, hi = red(lo, axis=(-2, -1)), red(hi, axis=(-2, -1))
        out = Iv(_obj(lo), _obj(hi))
    elif k == 1 and iv.lo.shape[-1] == reduced_shape[1]:
        covered = reduced_shape[1]
        if fn.name in ("Add", "AddAsync"):
            out = Iv(_obj(iv.lo.sum(-1)), _obj(iv.hi.sum(-1)))
        else:
            red = np.min if fn.name == "Min" else np.max
            out = Iv.of(int(red(iv.lo)), int(red(iv.hi)))
    else:                               # uniform (scalar-hull) interval
        covered = 1
        out = iv.collapse()
    rem = n_reduced // covered
    if rem * covered != n_reduced:      # misaligned: fall back to the hull
        out, rem = out.collapse(), n_reduced
    if fn.name in ("Add", "AddAsync") and rem != 1:
        out = Iv(out.lo * rem, out.hi * rem)
    return out


def analyze(out: Val,
            input_ranges: Optional[Dict[str, Tuple[int, int]]] = None
            ) -> RangeReport:
    """Run the range analysis over the DAG rooted at ``out``.

    ``input_ranges`` optionally tightens named Input nodes beyond their
    declared type range ({input_name: (lo, hi)}).
    """
    input_ranges = input_ranges or {}
    report = RangeReport()
    env: Dict[int, object] = {}         # uid -> Iv | tuple | None

    def record(v: Val, status: str, math: Optional[Iv],
               value: Optional[Iv], detail: str = "") -> None:
        scalar = scalar_of(v.ty)
        nr = NodeRange(v.uid, v.op, detail, status, scalar)
        if math is not None:
            nr.math_lo, nr.math_hi = math.min, math.max
        if value is not None:
            nr.lo, nr.hi = value.min, value.max
            if isinstance(scalar, (UInt, Int, Bits, BoolT)):
                nr.proven_bits = min(
                    scalar.bits(),
                    _min_bits(nr.lo, nr.hi, isinstance(scalar, Int)))
        report.nodes[v.uid] = nr
        report.order.append(v.uid)

    def finish(v: Val, math: Optional[Iv], detail: str = "",
               moved: bool = False) -> None:
        """Common tail: wrap-check the math interval against the declared
        scalar type, clip, store.  ``moved`` marks pure data movement
        (upstream values, already masked: containment holds by
        construction, so a violation would be an analysis bug)."""
        scalar = scalar_of(v.ty)
        trange = _type_range(scalar)
        if trange is None:              # float-typed node
            env[v.uid] = None
            record(v, "float", None, None, detail)
            return
        if math is None:                # imported/unknown arithmetic
            env[v.uid] = _type_iv(scalar)
            record(v, "assumed", None, _type_iv(scalar), detail)
            return
        math = math.capped()
        fits = math.min >= trange[0] and math.max <= trange[1]
        value = _clip_to_type(math, trange)
        env[v.uid] = value
        status = "proven" if (fits or moved) else "wraps"
        record(v, status, math, value, detail)

    for v in toposort(out):
        op, p = v.op, v.p
        if op == "Input":
            ty = v.ty
            if isinstance(ty, TupleT):
                env[v.uid] = tuple(_type_iv(scalar_of(e)) for e in ty.elems)
                record(v, "proven", None, None, p.get("name", ""))
            else:
                r = input_ranges.get(p.get("name", ""),
                                     _type_range(scalar_of(ty)))
                finish(v, None if r is None else Iv.of(*r),
                       p.get("name", ""), moved=True)
            continue
        if op == "Const":
            arr = np.asarray(p["value"])
            if arr.dtype.kind not in "iub":
                env[v.uid] = None
                record(v, "float", None, None)
            else:
                c = _obj(arr)
                finish(v, Iv(c, c).capped())
            continue
        if op in ("TupleIndex",):
            src = env.get(v.inputs[0].uid)
            iv = src[p["i"]] if isinstance(src, tuple) else src
            finish(v, iv, moved=True)
            continue
        if op in ("Concat", "FanOut"):
            n = len(v.inputs) if op == "Concat" else p["n"]
            srcs = [env.get(i.uid) for i in v.inputs]
            env[v.uid] = (tuple(srcs) if op == "Concat"
                          else tuple(srcs * n))
            record(v, "proven", None, None)
            continue
        if op == "FanIn":
            finish(v, env.get(v.inputs[0].uid), moved=True)
            continue
        if op == "Map":
            fn: PointFn = p["fn"]
            math = _fn_interval(fn, _aligned_args(v, env))
            finish(v, math, fn.name)
            continue
        if op == "Reduce":
            fn = p["fn"]
            iv = env.get(v.inputs[0].uid)
            shp = type_shape(v.inputs[0].ty)
            inner = shp[len(type_shape(v.ty)):]      # the reduced level
            math = None
            if iv is not None and not isinstance(iv, tuple) and len(inner) == 2:
                math = _reduce_interval(fn, iv, inner[0] * inner[1], inner)
            finish(v, math, fn.name)
            continue
        if op == "ReducePatch":
            fn = p["fn"]
            iv = env.get(v.inputs[0].uid)
            shp = type_shape(v.inputs[0].ty)         # (h,w,sh,sw)+inner
            sh, sw = shp[2], shp[3]
            inner_nd = len(shp) - 4
            math = None
            if iv is not None and not isinstance(iv, tuple):
                hull = iv if iv.ndim <= inner_nd else iv.collapse()
                math = _reduce_interval(fn, hull, sh * sw, (sh, sw))
            finish(v, math, fn.name)
            continue
        if op == "ArgMin":
            inner = v.inputs[0].ty.elem
            n = inner.size if isinstance(inner, ArrayT) else \
                v.inputs[0].ty.size
            finish(v, Iv.of(0, max(0, n - 1)))
            continue
        if op in ("Replicate", "Crop", "Upsample", "Downsample"):
            iv = env.get(v.inputs[0].uid)
            if isinstance(iv, tuple):
                iv = None
            finish(v, iv, moved=True)
            continue
        if op == "Stencil":
            iv = env.get(v.inputs[0].uid)
            if isinstance(iv, tuple):
                iv = None
            # borders are zero-filled by the executor's sliding window
            finish(v, None if iv is None else iv.hull(0), moved=True)
            continue
        if op == "Pad":
            iv = env.get(v.inputs[0].uid)
            if isinstance(iv, tuple):
                iv = None
            fill = int(p["value"])
            finish(v, None if iv is None else iv.hull(fill),
                   detail=f"value={fill}", moved=fill == 0)
            continue
        if op == "Stack":
            ivs = [env.get(i.uid) for i in v.inputs]
            if any(iv is None or isinstance(iv, tuple) for iv in ivs):
                finish(v, None, moved=True)
            else:
                finish(v, Iv(
                    np.stack([iv.collapse().lo for iv in ivs], -1)[None, :],
                    np.stack([iv.collapse().hi for iv in ivs], -1)[None, :]),
                    moved=True)
            continue
        if op == "Filter":
            iv = env.get(v.inputs[0].uid)
            if isinstance(iv, tuple):
                iv = None
            # SparseT passes through the end-of-node mask unmodified
            env[v.uid] = iv
            record(v, "float" if iv is None and
                   _type_range(scalar_of(v.ty)) is None else "proven",
                   None, iv if isinstance(iv, Iv) else None)
            continue
        if op == "SparseTake":
            src = v.inputs[0].ty                     # SparseT(elem, w, h)
            iv = env.get(v.inputs[0].uid)
            if isinstance(iv, tuple):
                iv = None
            val_iv = None if iv is None else iv.collapse().hull(0)
            idx_iv = Iv.of(0, max(0, src.w * src.h - 1))
            env[v.uid] = (val_iv, idx_iv)
            record(v, "proven", None, None, f"n={p['n']}")
            # per-component proven widths of the (values, index) tuple:
            # the index provably fits log2(w*h) bits whatever the data
            decl = report.nodes[v.uid].declared
            if isinstance(decl, TupleT) and len(decl.elems) == 2:
                report.nodes[v.uid].component_bits = (
                    _scaled_component_bits(decl.elems[0], val_iv),
                    _scaled_component_bits(decl.elems[1], idx_iv))
            continue
        if op == "External":
            finish(v, None, p.get("ext_name", ""))
            continue
        # unknown op: sound default
        finish(v, None, "unhandled-op")
    return report


# --------------------------------------------------------------------------
# proven-width narrowing over the mapped netlist


def _scaled_component_bits(comp_ty: DType, iv: Optional[Iv]
                           ) -> Optional[int]:
    """Proven total width of one tuple component (scalar proven width times
    the component's scalar count); None = keep the declared width."""
    sc = scalar_of(comp_ty)
    if iv is None or not isinstance(sc, (UInt, Int, Bits, BoolT)):
        return None
    per = min(sc.bits(), _min_bits(iv.min, iv.max, isinstance(sc, Int)))
    return per * (comp_ty.bits() // sc.bits())


def _proven_total_bits(nr: "NodeRange") -> Optional[int]:
    """A node's proven total scalar width: ``proven_bits`` for plain
    integers, the component sum for tuples; None when nothing narrows."""
    if nr.proven_bits is not None:
        return nr.proven_bits
    if nr.component_bits is not None and isinstance(nr.declared, TupleT):
        total = sum(cb if cb is not None else e.bits()
                    for cb, e in zip(nr.component_bits, nr.declared.elems))
        if total < nr.declared.bits():
            return total
    return None


def module_proven_bits(design, report: Optional[RangeReport] = None
                       ) -> List[Optional[int]]:
    """Per-module proven scalar width (None = no proof / width mismatch).

    Modules the mapper inserted (FanOut / width converters / the AXI sink)
    carry ``src_uid=None``; they move tokens unchanged, so they inherit the
    proof of their single predecessor when the scalar widths agree."""
    if report is None:
        report = analyze(design.out_val)
    per_mod: List[Optional[int]] = []
    for m in design.modules:
        b = None
        if m.src_uid is not None:
            nr = report.nodes.get(m.src_uid)
            if (nr is not None
                    and nr.declared.bits() == m.iface_out.sched.scalar.bits()):
                b = _proven_total_bits(nr)
        per_mod.append(b)
    preds: Dict[int, List[int]] = {}
    for e in design.edges:
        preds.setdefault(e.dst, []).append(e.src)
    changed = True
    while changed:
        changed = False
        for i, m in enumerate(design.modules):
            if per_mod[i] is not None or m.src_uid is not None:
                continue
            ps = preds.get(i, [])
            if (len(ps) == 1 and per_mod[ps[0]] is not None
                    and (design.modules[ps[0]].iface_out.sched.scalar.bits()
                         == m.iface_out.sched.scalar.bits())):
                per_mod[i] = per_mod[ps[0]]
                changed = True
    return per_mod


def narrowed_token_bits(design, report: Optional[RangeReport] = None
                        ) -> Dict[Tuple[int, int], int]:
    """Per-edge token widths at proven widths: ``proven_bits * v`` where the
    producing module's value range is proven, the declared ``token_bits``
    otherwise.  Feeds hwsim/area.py's proven-width FIFO pricing."""
    per_mod = module_proven_bits(design, report)
    out: Dict[Tuple[int, int], int] = {}
    for e in design.edges:
        pb = per_mod[e.src]
        v = design.modules[e.src].iface_out.sched.v
        out[(e.src, e.dst)] = (min(e.token_bits, pb * v)
                               if pb is not None else e.token_bits)
    return out
