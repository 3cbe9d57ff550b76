"""Megakernel emission: one fused CUDA kernel per schedule segment (K3).

The torch counterpart of ``repro/core/lowering/megakernel.py``.  The
engine's generic path runs one torch op per IR node and materializes every
intermediate image in device memory.  For an eligible segment this emitter
writes the CUDA C++ source of a *single* kernel instead, which the engine
builds with ``nvcc`` (``kernels/_build.py``) and launches through the
``megakernel`` registry entry (``kernels/megakernel/``).

Tiles, not row strips.  The reference keeps whole input frames in the
TPU's VMEM and streams 8-row blocks across the full width; its line buffers
for FLOW at 1080p take ~10 MB.  An H100 block has 232,448 B of shared
memory, so the kernel tiles columns as well as rows: one block per output
tile of ``MK_BLOCK_ROWS`` x ``tile_cols`` pixels and frame (frames on grid
z, so a batch is one launch).  The block walks the segment's nodes in
schedule order and computes each node's 2-D *window* into shared memory,
all threads striding over its elements, with a ``__syncthreads()`` between
nodes; then it writes the tile of every output.

Demand propagation.  Each node's window is rows ``[off(r0), off+size)``
and columns ``[off(c0), off+size)`` of its virtual frame, where ``r0`` and
``c0`` are the tile's first output row and column.  The row algebra is the
reference's ``_demand_pass`` unchanged (stencils shift by their window
base and widen by the window height, pad/crop shift, down/upsampling scale
by the stride with floor division, reconvergent demands merge when their
slopes agree); columns follow the same algebra with the column parameters.
Sizes are static; offsets are computed from ``blockIdx`` at run time, and
each ``Demand`` carries its offset both as a Python callable and as a C
expression over its consumers' offsets.  Values outside a node's own frame
read as zero.

What stays on chip.  Storing every node's window does not fit FLOW, so:

* pure index remaps (Stencil, TupleIndex, Concat, FanOut, FanIn,
  Replicate) are read *through*: a consumer reads patch element (dy, dx)
  of a Stencil straight from the Stencil's input window;
* the interiors of integer box-sum chains (Stencil -> Map(AddMSBs)* ->
  Reduce(Add)) are never computed: the chain's Reduce sums the sh x sw
  window of the chain's input directly (the reference's peephole);
* Consts are known at emission time and baked into the source, masked to
  their type.

If the windows do not fit at the starting tile, the emitter halves the
tile's columns; if nothing fits, or a node needs a whole-frame value
(``WHOLE`` demand: no tile form), it raises ``MKUnsupported`` and the
engine keeps the generic path for that segment, with a note.

Verification contract (two tiers, as in the reference): integer nodes are
bit-exact — every node's result is wrapped like ``torch_mask``, with
integer arithmetic in ``unsigned long long`` because signed overflow is
undefined in CUDA C++.  Float nodes are promised within ``FLOAT_ULP_BOUND``
ULPs; the kernel does better by construction: every f32 operation is one
IEEE operation rounded to nearest (``__fmul_rn`` and friends, which nvcc
never contracts into an FMA, and the build adds ``-fmad=false``), f32
constants are written bit-exactly, and each float node equals the torch
operation of the plain version bit for bit.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from fractions import Fraction
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...kernels.stream import (MK_BLOCK_ROWS, MK_SMEM_LIMIT, MK_THREADS,
                               MK_TILE_COLS, nbytes)
from ..dtypes import Bits, Float, Int, TupleT, UInt
from ..hwimg import map_reshape_plans, scalar_of, type_shape
from .ir import IRNode, LoweringIR
from .lowerers import torch_mask

# the float tier of the verification contract: megakernel outputs are
# within this many ULPs of the reference executor
FLOAT_ULP_BOUND = 4


class MKUnsupported(Exception):
    """Segment not eligible for megakernel emission (the engine keeps the
    generic per-op torch path for it)."""


# ops the emitter can stream tile-wise.  Dispatch nodes (opaque fused
# kernels), Filter/SparseTake (data-dependent global gather) and External
# (host callback) stay on the generic path.
STREAM_OPS = frozenset({
    "Map", "Reduce", "ReducePatch", "ArgMin", "Stencil", "Pad", "Crop",
    "Downsample", "Upsample", "Replicate", "Stack", "Concat", "FanOut",
    "FanIn", "TupleIndex", "Const",
})
# arithmetic/geometry: a span of pure tuple plumbing isn't worth a kernel
_COMPUTE_OPS = frozenset({
    "Map", "Reduce", "ReducePatch", "ArgMin", "Stencil", "Pad", "Crop",
    "Downsample", "Upsample",
})
# pure index remaps: read through by their consumers, never stored
_THROUGH_OPS = frozenset({"Stencil", "TupleIndex", "Concat", "FanOut",
                          "FanIn", "Replicate"})

# float-touching point functions with a known exact lowering inside the
# fused kernel (the reference's _JNP_FNS plus int->float converts and
# compares).  An unknown user PointFn touching float stays on the generic
# path.
_KNOWN_FLOAT_FNS = frozenset({
    "Abs", "AbsDiff", "Max", "Min", "And", "FloatMul", "FloatAdd",
    "FloatSub", "FloatDiv", "FloatSqrt", "ToFloat", "Gt"})


def _is_float(s) -> bool:
    return isinstance(s, Float)


def _elems(ty) -> List:
    """Image leaves of a node type (tuple fan points carry several)."""
    return list(ty.elems) if isinstance(ty, TupleT) else [ty]


def _has_rows(ty) -> bool:
    return all(len(type_shape(t)) >= 2 for t in _elems(ty))


def _carrier_dtype(ty) -> torch.dtype:
    s = scalar_of(ty)
    if isinstance(s, (UInt, Bits, Int)):
        return torch.int64              # the engine's integer carrier
    return {np.dtype(np.float32): torch.float32,
            np.dtype(np.float64): torch.float64,
            np.dtype(np.bool_): torch.bool}[np.dtype(s.np_dtype())]


def streamable(n: IRNode) -> bool:
    """Node-level eligibility: the emitter knows the op, every tuple leg
    is a plain image (equal heights at fan points), and any float
    point-function has a known exact lowering."""
    if n.dispatch is not None or n.op not in STREAM_OPS:
        return False
    for ty in (n.ty,) + tuple(n.input_tys):
        if isinstance(ty, TupleT):
            if any(isinstance(t, TupleT) for t in ty.elems):
                return False            # nested tuples
            hs = {type_shape(t)[0] for t in ty.elems
                  if len(type_shape(t)) >= 2}
            if len(hs) > 1:
                return False            # fan of unequal heights
    if n.op in ("Map", "Reduce", "ReducePatch"):
        fn = n.params["fn"]
        if fn.name not in _KNOWN_FLOAT_FNS and any(
                _is_float(scalar_of(t))
                for t in (n.ty,) + tuple(n.input_tys)):
            return False    # unknown float fn: no exact lowering
    if n.op == "Downsample":
        # executor semantics stride-slice (ceil) while the typed shape
        # floors; they agree only when the strides divide the frame — the
        # generic path keeps the odd-size case
        shape = type_shape(n.input_tys[0])
        if shape[0] % n.params["sy"] or shape[1] % n.params["sx"]:
            return False
    return True


def worth_emitting(nodes: List[IRNode]) -> bool:
    """A span earns a kernel when it fuses at least two nodes and does
    some arithmetic/geometry (not just tuple plumbing)."""
    return len(nodes) >= 2 and any(n.op in _COMPUTE_OPS for n in nodes)


# --------------------------------------------------------------------------
# demand propagation (rows as in the reference; columns the same algebra)

@dataclass(frozen=True)
class Demand:
    """Window ``[off(s0), off+size)`` of a node's virtual frame along one
    axis, with ``off`` bounded by ``slope*s0 + [lo, hi]`` (exact
    rationals; ``s0`` is the tile's first output row or column).  ``expr``
    is the same offset as a C expression over the offset variables of the
    node's consumers (``r0``/``c0`` at the outputs)."""

    off: Callable[[Any], Any]
    size: int
    slope: Fraction
    lo: Fraction
    hi: Fraction
    expr: str = "r0"


WHOLE = "whole"                         # whole-frame marker (no tile form)

# per axis: the tile-start variable, the prefix of the offset variables,
# and the Stencil/Pad/Crop/resampling parameters that act along it
_AXES = {
    "rows": ("r0", "or_", ("b", "t"), "t", "sy"),
    "cols": ("c0", "oc_", ("l", "r"), "l", "sx"),
}


def _seed(block: int, var: str = "r0") -> Demand:
    return Demand(lambda s0: s0, block, Fraction(1), Fraction(0),
                  Fraction(0), var)


def _shift(d: Demand, c: int, grow: int = 0) -> Demand:
    if c == 0 and grow == 0:
        return d
    f = d.off
    return Demand(lambda s0: f(s0) + c, d.size + grow, d.slope,
                  d.lo + c, d.hi + c, f"({d.expr} + {c})")


def _scale(d: Demand, sy: int) -> Demand:
    f = d.off
    return Demand(lambda s0: f(s0) * sy, sy * (d.size - 1) + 1,
                  d.slope * sy, d.lo * sy, d.hi * sy, f"({d.expr} * {sy})")


def _floordiv(d: Demand, sy: int) -> Demand:
    f = d.off
    return Demand(lambda s0: f(s0) // sy, (d.size + sy - 2) // sy + 1,
                  d.slope / sy, (d.lo - (sy - 1)) / sy, d.hi / sy,
                  f"mk_floordiv({d.expr}, {sy})")


def _merge(a, b):
    """Union of two demands on one producer.  Needs equal slopes so the
    slope term cancels and the union's length stays statically bounded;
    otherwise the producer needs the whole frame."""
    if a is None:
        return b
    if WHOLE in (a, b) or a.slope != b.slope:
        return WHOLE
    fa, fb = a.off, b.off
    lo = min(a.lo, b.lo)
    size = int(math.ceil(max(a.hi + a.size, b.hi + b.size) - lo))
    return Demand(lambda s0: min(fa(s0), fb(s0)), size, a.slope, lo,
                  min(a.hi, b.hi), f"mk_min({a.expr}, {b.expr})")


def _map_streams_input(n: IRNode, j: int) -> bool:
    """Does Map input j ride the tile stream (leading (h, w) matches the
    output) or broadcast whole (coefficient arrays, scalars)?"""
    s_in = type_shape(n.input_tys[j])
    return len(s_in) >= 2 and s_in[:2] == type_shape(n.ty)[:2]


def _input_demands(n: IRNode, d: Demand, axis: str = "rows") -> List[Any]:
    """Per-input demand along ``axis`` implied by demand ``d`` on ``n``."""
    p = n.params
    _v, _pre, (lo_k, hi_k), pad_k, st_k = _AXES[axis]
    if n.op == "Map":
        return [d if _map_streams_input(n, j) else WHOLE
                for j in range(len(n.inputs))]
    if n.op in ("Reduce", "ReducePatch", "ArgMin", "Replicate", "Stack",
                "Concat", "FanOut", "FanIn", "TupleIndex"):
        return [d] * len(n.inputs)
    if n.op == "Stencil":
        grow = abs(p[hi_k] - p[lo_k])
        return [_shift(d, p[lo_k], grow=grow)]
    if n.op == "Pad":
        return [_shift(d, -p[pad_k])]
    if n.op == "Crop":
        return [_shift(d, p[pad_k])]
    if n.op == "Downsample":
        return [_scale(d, p[st_k])]
    if n.op == "Upsample":
        return [_floordiv(d, p[st_k])]
    raise MKUnsupported(f"no demand rule for {n.op}")


def _demand_pass(nodes: List[IRNode], span, out_uids, block: int,
                 axis: str = "rows") -> Dict[int, Any]:
    """Reverse pass: demands (window offsets + static sizes) along
    ``axis``.  Each final demand's ``expr`` is a C expression over the
    offset variables of the node's consumers; its own variable is
    ``{prefix}{i}`` (``or_``/``oc_``), ``i`` its position in ``nodes``."""
    var, prefix = _AXES[axis][:2]
    local = {n.uid: i for i, n in enumerate(nodes)}
    demand: Dict[int, Any] = {u: _seed(block, var) for u in out_uids}
    for n in reversed(nodes):
        d = demand.get(n.uid)
        if d is None:       # pragma: no cover - every span exit is an out
            raise MKUnsupported(f"%{n.uid} has no consumer demand")
        if n.op == "Const" or not _has_rows(n.ty):
            d = demand[n.uid] = WHOLE   # consts/scalars evaluate whole
        if d is WHOLE:
            for u in n.inputs:
                if u in span:
                    demand[u] = WHOLE
            continue
        bound = replace(d, expr=f"{prefix}{local[n.uid]}")
        for u, di in zip(n.inputs, _input_demands(n, bound, axis)):
            if u in span:
                demand[u] = _merge(demand.get(u), di)
    return demand


# --------------------------------------------------------------------------
# the emitted kernel and its report card

@dataclass
class IOLeaf:
    """One image leaf crossing the kernel boundary."""

    uid: int
    k: Optional[int]                    # tuple leg, None for a plain value
    shape: Tuple[int, ...]              # (h, w, inner...) per frame
    dtype: torch.dtype


@dataclass
class Megakernel:
    """One emitted segment kernel: its CUDA source, its geometry and its
    report card."""

    name: str
    n_nodes: int
    n_leaves: int
    block_rows: int
    grid: int                           # row tiles
    linebuf_bytes: int                  # reference's line-buffer bytes
    whole_bytes: int                    # whole-frame (const) bytes
    float_nodes: int                    # nodes under the ULP tier
    n_winsum: int = 0                   # box-sum chains summed directly
    note: str = ""
    flops: int = 0                      # scalar ops per frame (int ops too)
    io_bytes: int = 0                   # kernel-boundary bytes per frame
    # the CUDA side
    source: str = ""
    kernel_name: str = ""
    tile: Tuple[int, int] = (0, 0)      # (rows, cols) of one output tile
    grid_xy: Tuple[int, int] = (0, 0)   # (column tiles, row tiles)
    smem_bytes: int = 0
    threads: int = MK_THREADS
    # the geometry, for the plain version and the CPU model of the tiling
    nodes: List[IRNode] = field(default_factory=list)
    in_leaves: List[IOLeaf] = field(default_factory=list)
    out_leaves: List[IOLeaf] = field(default_factory=list)
    in_uids: Tuple[int, ...] = ()
    out_uids: Tuple[int, ...] = ()
    rows: Dict[int, Any] = field(default_factory=dict)
    cols: Dict[int, Any] = field(default_factory=dict)
    stored: List[int] = field(default_factory=list)
    skip: frozenset = frozenset()
    winsum: Dict[int, IRNode] = field(default_factory=dict)
    consts: Dict[int, np.ndarray] = field(default_factory=dict)

    def group_outputs(self, leaves: List[Any]) -> Tuple[Any, ...]:
        """Output leaves (in ``out_leaves`` order) regrouped into one value
        per ``out_uids`` entry (tuple-typed outputs reassemble)."""
        result, i = [], 0
        for u in self.out_uids:
            k = sum(1 for lf in self.out_leaves if lf.uid == u)
            result.append(tuple(leaves[i:i + k]) if k > 1 else leaves[i])
            i += k
        return tuple(result)

    @property
    def arithmetic_intensity(self) -> float:
        """Roofline x-axis: scalar ops per byte crossing the kernel
        boundary."""
        return self.flops / self.io_bytes if self.io_bytes else 0.0

    def least_ops(self) -> Tuple[int, int]:
        """The segment's least arithmetic per frame, as (integer ops, f32
        ops), for a roofline bound.  ``flops`` is the reference's count and
        charges every box-sum output its sh x sw taps; here a box-sum chain
        is a sliding sum (an add and a subtract per step across the rows of
        its input window, and again down the output), a reduction of n
        values costs n - 1 ops per output, a Map one op per output scalar.
        An op that reads or writes f32 counts as f32; geometry and
        constants cost nothing."""
        def scalars(ty) -> int:
            return sum(math.prod(type_shape(t)) for t in _elems(ty))

        def touches_float(n: IRNode) -> bool:
            return any(_is_float(scalar_of(t))
                       for ty in (n.ty, *n.input_tys) for t in _elems(ty))

        int_ops = f32_ops = 0
        for n in self.nodes:
            if n.uid in self.skip:
                continue
            if n.uid in self.winsum:
                _l, _b, sh, sw = _winsum_geometry(self.winsum[n.uid])
                h, w = type_shape(n.ty)[:2]
                ops = 2 * (h + sh - 1) * w + 2 * h * w
            elif n.op == "Map":
                ops = scalars(n.ty)
            elif n.op in ("Reduce", "ReducePatch", "ArgMin"):
                ops = scalars(n.input_tys[0]) - scalars(n.ty)
            else:
                continue
            if touches_float(n):
                f32_ops += ops
            else:
                int_ops += ops
        return int_ops, f32_ops

    def report_line(self) -> str:
        tier = (f"float tier (ULP<={FLOAT_ULP_BOUND})" if self.float_nodes
                else "integer tier (bit-exact)")
        extra = f" (+{self.whole_bytes}B whole)" if self.whole_bytes else ""
        ws = (f", {self.n_winsum} box-sum chain(s) via direct window sums"
              if self.n_winsum else "")
        return (f"{self.name}: {self.n_nodes} fused nodes, "
                f"grid={self.grid}x{self.block_rows}rows, "
                f"linebuf={self.linebuf_bytes}B{extra}, {tier}{ws}; "
                f"CUDA tile {self.tile[0]}x{self.tile[1]}, "
                f"smem={self.smem_bytes}B")


# --------------------------------------------------------------------------
# emission

def _winsum_geometry(stn: IRNode):
    p = stn.params
    l, r, b, t = p["l"], p["r"], p["b"], p["t"]
    return l, b, abs(t - b) + 1, abs(r - l) + 1      # (l, b, sh, sw)


def _find_winsums(ir: LoweringIR, nodes: List[IRNode], span, out_set):
    """The box-sum peephole: Stencil -> (Map(AddMSBs))* -> Reduce(Add|
    AddAsync), single-consumer all the way, integer-carried, plain 2-D
    frames.  Integer addition on the int64 carrier is associative
    (AddMSBs only widens), so summing the window of the chain's input is
    bit-exact and the chain's interior is never computed."""
    winsum: Dict[int, IRNode] = {}      # Reduce uid -> its Stencil node
    skip: set = set()                   # chain interiors: never computed
    for n in nodes:
        if (n.op != "Stencil" or _is_float(scalar_of(n.ty))
                or len(type_shape(n.input_tys[0])) != 2):
            continue
        chain, cur, tail = [n], n, None
        while (len(set(cur.consumers)) == 1 and cur.uid not in out_set
               and cur.consumers[0] in span):
            c = ir.nodes[cur.consumers[0]]
            if (c.op == "Map" and len(c.inputs) == 1
                    and c.params["fn"].name == "AddMSBs"):
                chain.append(c)
                cur = c
                continue
            if (c.op == "Reduce" and not _is_float(scalar_of(c.ty))
                    and c.params["fn"].name in ("Add", "AddAsync")):
                tail = c
            break
        if tail is not None:
            winsum[tail.uid] = n
            skip.update(x.uid for x in chain)
    return winsum, skip


def _masked_const(n: IRNode) -> np.ndarray:
    """A Const's value on its carrier, masked to its type (the engine's
    rule), with its type's shape."""
    a = np.asarray(n.params["value"])
    if a.dtype.kind in "iu":
        a = a.astype(np.int64)
    t = torch_mask(torch.as_tensor(a), n.ty)
    return t.to(_carrier_dtype(n.ty)).numpy().reshape(type_shape(n.ty))


def emit_megakernel(ir: LoweringIR, nodes: List[IRNode],
                    in_uids: Tuple[int, ...], out_uids: Tuple[int, ...],
                    name: str = "mk", block_rows: Optional[int] = None,
                    tile_cols: Optional[int] = None) -> Megakernel:
    """Build the fused tile-streaming CUDA kernel for one segment.

    ``nodes`` is the segment in schedule order; ``in_uids`` are values
    produced outside it (whole frames at call time), ``out_uids`` the
    values it must materialize.  Raises MKUnsupported when the segment
    has no tile form (the engine then keeps the generic path).

    ``block_rows`` and ``tile_cols`` fix the output tile; by default it is
    ``MK_BLOCK_ROWS`` x ``MK_TILE_COLS``, the columns halved until the
    windows fit in shared memory."""
    for n in nodes:
        if not streamable(n):
            raise MKUnsupported(f"%{n.uid}:{n.op} is not streamable")
    span = {n.uid for n in nodes}
    out_nodes = [ir.nodes[u] for u in out_uids]

    frames = set()
    for o in out_nodes:
        for ty in _elems(o.ty):
            shape = type_shape(ty)
            if len(shape) < 2:
                raise MKUnsupported(f"output %{o.uid} is not an image")
            frames.add(shape[:2])
    heights = {f[0] for f in frames}
    if len(heights) != 1:
        raise MKUnsupported(f"outputs disagree on height: {heights}")
    if len(frames) != 1:
        raise MKUnsupported(f"outputs disagree on width: "
                            f"{sorted(f[1] for f in frames)}")
    h_out, w_out = frames.pop()
    block = min(block_rows or MK_BLOCK_ROWS, h_out)
    grid = -(-h_out // block)

    rows = _demand_pass(nodes, span, out_uids, block, "rows")
    out_set = set(out_uids)
    winsum, skip = _find_winsums(ir, nodes, span, out_set)

    # ---- byte accounting (the reference's line-buffer report) ----
    # rows windows at the streaming block, across the whole width
    stream_block = min(MK_BLOCK_ROWS, h_out)
    acct = (rows if block == stream_block
            else _demand_pass(nodes, span, out_uids, stream_block))
    linebuf = whole_b = 0
    float_nodes = 0
    for n in nodes:
        if any(_is_float(scalar_of(t)) for t in _elems(n.ty)):
            float_nodes += 1
        if n.uid in skip:
            continue                    # box-sum interiors never materialize
        d = acct[n.uid]
        for ty in _elems(n.ty):
            shape = type_shape(ty)
            if d is WHOLE or len(shape) < 2:
                whole_b += nbytes(shape, _carrier_dtype(ty))
            else:
                linebuf += nbytes((d.size,) + tuple(shape[1:]),
                                  _carrier_dtype(ty))

    # ---- roofline accounting (per frame, the reference's counts) ----
    def _scalars(ty) -> int:
        return sum(math.prod(type_shape(t)) for t in _elems(ty))

    flops = 0
    for n in nodes:
        if n.uid in skip:
            continue
        if n.uid in winsum:
            _l, _b, sh, sw = _winsum_geometry(winsum[n.uid])
            flops += sh * sw * _scalars(n.ty)
        elif n.op == "Map":
            flops += _scalars(n.ty)
        elif n.op in ("Reduce", "ReducePatch"):
            flops += _scalars(n.input_tys[0])

    def _leaves(uids) -> List[IOLeaf]:
        out = []
        for u in uids:
            elems = _elems(ir.nodes[u].ty)
            for k, ty in enumerate(elems):
                out.append(IOLeaf(u, k if len(elems) > 1 else None,
                                type_shape(ty), _carrier_dtype(ty)))
        return out

    in_leaves, out_leaves = _leaves(in_uids), _leaves(out_uids)
    const_nodes = [n for n in nodes if n.op == "Const"]
    node_list = [n for n in nodes if n.op != "Const"]
    io_bytes = (sum(nbytes(lf.shape, lf.dtype) for lf in in_leaves)
                + sum(nbytes(type_shape(n.ty), _carrier_dtype(n.ty))
                      for n in const_nodes)
                + sum(nbytes(lf.shape, lf.dtype) for lf in out_leaves))

    for n in node_list:
        if rows[n.uid] is WHOLE:
            raise MKUnsupported(f"%{n.uid}:{n.op} needs the whole frame "
                                f"(no tile form)")
    consts = {n.uid: _masked_const(n) for n in const_nodes}
    stored = [n.uid for n in node_list
              if n.uid not in skip and n.op not in _THROUGH_OPS]

    # ---- the tile: halve its columns until the windows fit ----
    tw = min(tile_cols or MK_TILE_COLS, w_out)
    while True:
        cols = _demand_pass(nodes, span, out_uids, tw, "cols")
        for n in node_list:
            if cols[n.uid] is WHOLE:
                raise MKUnsupported(f"%{n.uid}:{n.op} needs whole frame "
                                    f"columns (no tile form)")
        smem = _smem_layout(ir, stored, rows, cols)[1]
        if smem <= MK_SMEM_LIMIT or tile_cols is not None:
            break
        if tw == 1:
            raise MKUnsupported(f"windows need {smem}B of shared memory "
                                f"even at 1-column tiles")
        tw = max(1, tw // 2)
    if smem > MK_SMEM_LIMIT:
        raise MKUnsupported(f"windows need {smem}B of shared memory at "
                            f"{block}x{tw} tiles")

    mk = Megakernel(
        name, len(node_list), len(in_leaves), block, grid, linebuf,
        whole_b, float_nodes, len(winsum), flops=flops, io_bytes=io_bytes,
        tile=(block, tw), grid_xy=(-(-w_out // tw), grid), smem_bytes=smem,
        nodes=list(nodes), in_leaves=in_leaves, out_leaves=out_leaves,
        in_uids=tuple(in_uids), out_uids=tuple(out_uids), rows=rows,
        cols=cols, stored=stored, skip=frozenset(skip), winsum=winsum,
        consts=consts)
    mk.source, mk.kernel_name = _CudaWriter(ir, mk).write()
    ops = [n.op for n in node_list]
    mk.note = (f"{name}: fused {len(node_list)} nodes "
               f"({ops[0]}..{ops[-1]}) into one CUDA kernel "
               f"({mk.grid_xy[0]}x{grid} tiles of {block}x{tw})")
    return mk


def _smem_layout(ir: LoweringIR, stored: List[int], rows, cols
                 ) -> Tuple[Dict[int, int], int]:
    """Byte offsets of the stored windows in shared memory (16-aligned)
    and the total."""
    offsets, total = {}, 0
    for u in stored:
        ty = ir.nodes[u].ty
        inner = type_shape(ty)[2:]
        offsets[u] = total
        size = nbytes((rows[u].size, cols[u].size) + tuple(inner),
                      _carrier_dtype(ty))
        total += -(-size // 16) * 16
    return offsets, total


# --------------------------------------------------------------------------
# CUDA C++ generation

_CTYPE = {torch.int64: "long long", torch.float32: "float",
          torch.bool: "bool"}
_ZERO = {"long long": "0LL", "float": "0.0f", "bool": "false"}


def _ctype(dtype: torch.dtype) -> str:
    if dtype not in _CTYPE:
        raise MKUnsupported(f"no CUDA carrier for {dtype}")
    return _CTYPE[dtype]


def _c_literal(v, ctype: str) -> str:
    if ctype == "long long":
        return f"{int(v)}LL"
    if ctype == "float":
        bits = int(np.asarray(v, np.float32).view(np.uint32))
        return f"__int_as_float(0x{bits:08x})"
    return "true" if bool(v) else "false"


def _c_mask(expr: str, ty) -> str:
    s = scalar_of(ty)
    if isinstance(s, (UInt, Bits)):
        return f"mk_mask_u({expr}, {s.bits()})"
    if isinstance(s, Int):
        return f"mk_mask_s({expr}, {s.bits()})"
    return expr


def _c_point_fn(fn, args: List[Tuple[str, str]]) -> Tuple[str, str]:
    """The C expression and C type of point function ``fn`` on ``args``
    ((expression, C type) each), with the port's torch semantics."""
    name, p = fn.name, dict(fn.params)
    if name in ("Sub", "Abs"):
        # a bool operand counts as 0 / 1 (numpy promotes it; the lowerers
        # cast it to int64)
        args = [(f"static_cast<long long>({e})", "long long")
                if t == "bool" else (e, t) for e, t in args]
    xs = [e for e, _ in args]
    ts = [t for _, t in args]
    ints = all(t == "long long" for t in ts)
    nums = all(t in ("long long", "float") for t in ts)
    if name in ("Add", "AddAsync", "Sub", "Mul") and ints:
        op = {"Add": "add", "AddAsync": "add", "Sub": "sub", "Mul": "mul"}
        return f"mk_{op[name]}({xs[0]}, {xs[1]})", "long long"
    if name == "Abs" and ints:
        return f"mk_abs({xs[0]})", "long long"
    if name == "Abs" and ts == ["float"]:
        return f"fabsf({xs[0]})", "float"
    if name == "AbsDiff" and ints:
        return f"mk_abs(mk_sub({xs[0]}, {xs[1]}))", "long long"
    if name in ("Max", "Min") and ints:
        return f"mk_{name.lower()}({xs[0]}, {xs[1]})", "long long"
    if name in ("Max", "Min") and ts == ["float", "float"]:
        return f"mk_f{name.lower()}({xs[0]}, {xs[1]})", "float"
    if name == "Gt" and ints:
        return f"({xs[0]} > {xs[1]})", "bool"
    if name == "Gt" and nums:           # torch compares int64 with f32 in f32
        return f"(mk_f32({xs[0]}) > mk_f32({xs[1]}))", "bool"
    if name == "And":
        return (f"(({xs[0]}) != {_ZERO[ts[0]]} && "
                f"({xs[1]}) != {_ZERO[ts[1]]})"), "bool"
    if name == "Rshift" and ints:
        return f"({xs[0]} >> {int(p['n'])})", "long long"
    if name in ("AddMSBs", "RemoveMSBs") and ints:
        return xs[0], "long long"
    if name == "ToFloat":
        return f"mk_f32({xs[0]})", "float"
    if name in ("FloatMul", "FloatAdd", "FloatSub"):
        op = {"FloatMul": "__fmul_rn", "FloatAdd": "__fadd_rn",
              "FloatSub": "__fsub_rn"}[name]
        return f"{op}(mk_f32({xs[0]}), mk_f32({xs[1]}))", "float"
    if name == "FloatDiv":
        return f"mk_fdiv({xs[0]}, {xs[1]})", "float"
    if name == "FloatSqrt":
        return f"mk_fsqrt({xs[0]})", "float"
    raise MKUnsupported(f"no CUDA lowering for {name} on {ts}")


def _aligned_shape(out_shape, ity, plan) -> Tuple[int, ...]:
    """A Map operand's shape aligned to the output's rank (the engine's
    ``_map_operand`` rule without the frame axis)."""
    if plan is not None:
        return tuple(plan)
    s = type_shape(ity)
    if len(s) >= len(out_shape):
        return tuple(s)
    return (1,) * (len(out_shape) - len(s)) + tuple(s)


class _CudaWriter:
    """Writes the kernel of one Megakernel.  ``_read`` emits the
    statements that load element ``e`` of leaf ``k`` of node ``u`` at
    virtual coordinates ``(y, x)`` and returns the C variable holding it:
    stored nodes read their shared-memory window, segment inputs read
    device memory with zero fill outside the frame, Consts read their
    baked values, and read-through nodes remap to their inputs."""

    def __init__(self, ir: LoweringIR, mk: Megakernel):
        self.ir, self.mk = ir, mk
        self.lines: List[str] = []
        self.ind = 1
        self.n_tmp = 0
        self.in_index = {(lf.uid, lf.k or 0): j
                         for j, lf in enumerate(mk.in_leaves)}
        self.stored = set(mk.stored)
        # C names follow positions in the segment, not global uids, so
        # equal segments write equal text (and share one cached build)
        self.local = {n.uid: i for i, n in enumerate(mk.nodes)}

    # ---- small helpers ----
    def emit(self, line: str) -> None:
        self.lines.append("  " * self.ind + line)

    def tmp(self, prefix: str = "t") -> str:
        self.n_tmp += 1
        return f"{prefix}{self.n_tmp}"

    def node(self, u: int) -> IRNode:
        return self.ir.nodes[u]

    def leaf_ty(self, u: int, k: int):
        return _elems(self.node(u).ty)[k]

    def ctype_of(self, u: int, k: int = 0) -> str:
        return _ctype(_carrier_dtype(self.leaf_ty(u, k)))

    def inside(self, y: str, x: str, h: int, w: int) -> str:
        return f"({y} >= 0 && {y} < {h} && {x} >= 0 && {x} < {w})"

    def const_at(self, u: int, idx: str) -> str:
        """Element ``idx`` of baked Const ``u`` (f32 values are stored as
        their bit patterns: a __device__ initializer must be constant)."""
        if self.ctype_of(u) == "float":
            return f"__int_as_float(static_cast<int>(k{self.local[u]}[{idx}]))"
        return f"k{self.local[u]}[{idx}]"

    def let(self, ctype: str, expr: str, prefix: str = "t") -> str:
        v = self.tmp(prefix)
        self.emit(f"const {ctype} {v} = {expr};")
        return v

    # ---- reads ----
    def _read(self, u: int, k: int, y: str, x: str, e: str) -> str:
        n = self.node(u)
        ty = self.leaf_ty(u, k)
        shape = type_shape(ty)
        inner = math.prod(shape[2:])
        ct = self.ctype_of(u, k)
        if len(shape) < 2:
            raise MKUnsupported(f"%{u}:{n.op} has no frame to tile")
        if (u, k) in self.in_index:
            j = self.in_index[(u, k)]
            h, w = shape[:2]
            return self.let(ct, f"{self.inside(y, x, h, w)} ? in{j}[f * fs{j}"
                                f" + (({y}) * {w} + ({x})) * {inner} + ({e})]"
                                f" : {_ZERO[ct]}")
        if u in self.stored:
            sc = self.mk.cols[u].size
            i = self.local[u]
            return self.let(ct, f"w{i}[(int)(((({y}) - or_{i}) * {sc} + "
                                f"(({x}) - oc_{i})) * {inner} + ({e}))]")
        if n.op == "Const":
            h, w = shape[:2]
            k = self.const_at(u, f"(({y}) * {w} + ({x})) * {inner} + ({e})")
            return self.let(ct, f"{self.inside(y, x, h, w)} ? {k} : "
                                f"{_ZERO[ct]}")
        p = n.params
        if n.op == "Stencil":
            l, b, sh, sw = _winsum_geometry(n)
            e_in = math.prod(type_shape(n.input_tys[0])[2:])
            q = self.let("int", f"({e}) / {e_in}", "q")
            ei = self.let("int", f"({e}) % {e_in}", "ei")
            yy = self.let("long long", f"({y}) + {b} + {q} / {sw}", "y")
            xx = self.let("long long", f"({x}) + {l} + {q} % {sw}", "x")
            v = self._read(n.inputs[0], 0, yy, xx, ei)
            h, w = shape[:2]
            return self.let(ct, f"{self.inside(y, x, h, w)} ? {v} : "
                                f"{_ZERO[ct]}")
        if n.op == "TupleIndex":
            return self._read(n.inputs[0], p["i"], y, x, e)
        if n.op == "Concat":
            return self._read(n.inputs[k], 0, y, x, e)
        if n.op == "FanOut":
            return self._read(n.inputs[0], 0, y, x, e)
        if n.op == "FanIn":
            return self._read(n.inputs[0], k, y, x, e)
        if n.op == "Replicate":
            if len(type_shape(n.input_tys[0])) != 2:
                raise MKUnsupported(f"%{u}: Replicate of a non-plain image")
            return self._read(n.inputs[0], 0, y, x,
                              f"({e}) / {p['m'] * p['n']}")
        raise MKUnsupported(f"%{u}:{n.op} is neither stored nor read "
                            f"through")

    def _read_whole(self, u: int, idx: str) -> str:
        """Element ``idx`` (flat, over the type's whole shape) of a value
        that does not ride the tile: a baked Const or a segment input."""
        n = self.node(u)
        ct = self.ctype_of(u)
        if n.op == "Const":
            return self.let(ct, self.const_at(u, idx))
        if (u, 0) in self.in_index and not isinstance(n.ty, TupleT):
            j = self.in_index[(u, 0)]
            return self.let(ct, f"in{j}[f * fs{j} + {idx}]")
        raise MKUnsupported(f"%{u}:{n.op} broadcasts whole into a Map")

    # ---- index arithmetic ----
    def _bcast_index(self, out_shape, a_shape, dims: List[str]) -> str:
        """Flat index into an operand of aligned shape ``a_shape`` for the
        output multi-index ``dims`` (numpy broadcasting)."""
        terms, stride = [], 1
        for d in reversed(range(len(out_shape))):
            if a_shape[d] != 1:
                terms.append(f"({dims[d]}) * {stride}" if stride != 1
                             else f"({dims[d]})")
            stride *= a_shape[d]
        return " + ".join(reversed(terms)) if terms else "0"

    def _inner_dims(self, inner: Tuple[int, ...], e: str) -> List[str]:
        """The multi-index over ``inner`` of flat inner index ``e``."""
        dims, stride = [], math.prod(inner)
        for s in inner:
            stride //= s
            dims.append(f"(({e}) / {stride}) % {s}" if stride != 1
                        else f"({e}) % {s}")
        return dims

    # ---- node bodies: statements computing the value ``v`` of node n at
    # (y, x, e), inside n's frame ----
    def _map(self, n: IRNode) -> Tuple[str, str]:
        out_shape = type_shape(n.ty)
        plans = map_reshape_plans(n.ty, n.input_tys)
        inner = out_shape[2:]
        dims = ["y", "x"] + self._inner_dims(inner, "e")
        args = []
        for j, (u, plan) in enumerate(zip(n.inputs, plans)):
            a = _aligned_shape(out_shape, n.input_tys[j], plan)
            if _map_streams_input(n, j):
                if tuple(a[:2]) != tuple(out_shape[:2]):
                    raise MKUnsupported(f"%{n.uid}: operand %{u} does not "
                                        f"align with the frame")
                if tuple(a[2:]) == tuple(inner):
                    e_j = "e"
                else:
                    e_j = self._bcast_index(inner, a[2:], dims[2:])
                args.append((self._read(u, 0, "y", "x", e_j),
                             self.ctype_of(u)))
            else:
                idx = self._bcast_index(out_shape, a, dims)
                args.append((self._read_whole(u, idx), self.ctype_of(u)))
        return _c_point_fn(n.params["fn"], args)

    def _fold(self, n: IRNode, count: int, e_in: Callable[[str], str]
              ) -> Tuple[str, str]:
        """fn folded over ``count`` input elements, in order."""
        u = n.inputs[0]
        ct = self.ctype_of(u)
        acc = self.tmp("acc")
        first = self._read(u, 0, "y", "x", e_in("0"))
        fn_ct = _c_point_fn(n.params["fn"], [(acc, ct), (first, ct)])[1]
        if fn_ct != ct:
            raise MKUnsupported(f"%{n.uid}: {n.params['fn'].name} changes "
                                f"the carrier inside a fold")
        self.emit(f"{ct} {acc} = {first};")
        self.emit(f"for (int j = 1; j < {count}; ++j) {{")
        self.ind += 1
        t = self._read(u, 0, "y", "x", e_in("j"))
        expr, _ = _c_point_fn(n.params["fn"], [(acc, ct), (t, ct)])
        self.emit(f"{acc} = {expr};")
        self.ind -= 1
        self.emit("}")
        return acc, ct

    def _reduce(self, n: IRNode) -> Tuple[str, str]:
        s_in = type_shape(n.input_tys[0])[2:]
        r = s_in[-2] * s_in[-1]
        return self._fold(n, r, lambda j: f"(e) * {r} + {j}")

    def _reduce_patch(self, n: IRNode) -> Tuple[str, str]:
        s_in = type_shape(n.input_tys[0])[2:]
        e_size = math.prod(s_in[2:])
        return self._fold(n, s_in[0] * s_in[1],
                          lambda j: f"({j}) * {e_size} + (e)")

    def _argmin(self, n: IRNode) -> Tuple[str, str]:
        u = n.inputs[0]
        s_in = type_shape(n.input_tys[0])[2:]
        r = s_in[-2] * s_in[-1]
        ct = self.ctype_of(u)
        best, arg = self.tmp("best"), self.tmp("arg")
        first = self._read(u, 0, "y", "x", f"(e) * {r}")
        self.emit(f"{ct} {best} = {first};")
        self.emit(f"long long {arg} = 0;")
        self.emit(f"for (int j = 1; j < {r}; ++j) {{")
        self.ind += 1
        t = self._read(u, 0, "y", "x", f"(e) * {r} + j")
        self.emit(f"if ({t} < {best}) {{ {best} = {t}; {arg} = j; }}")
        self.ind -= 1
        self.emit("}")
        return arg, "long long"

    def _stack(self, n: IRNode) -> Tuple[str, str]:
        kk = len(n.inputs)
        ct = self.ctype_of(n.uid)
        for u in n.inputs:
            if self.ctype_of(u) != ct or type_shape(self.node(u).ty) != \
                    type_shape(n.input_tys[0]):
                raise MKUnsupported(f"%{n.uid}: Stack of unlike operands")
        v = self.tmp("v")
        self.emit(f"{ct} {v} = {_ZERO[ct]};")
        self.emit(f"switch ((e) % {kk}) {{")
        for j, u in enumerate(n.inputs):
            self.emit(f"case {j}: {{")
            self.ind += 1
            t = self._read(u, 0, "y", "x", f"(e) / {kk}")
            self.emit(f"{v} = {t};")
            self.emit("break;")
            self.ind -= 1
            self.emit("}")
        self.emit("}")
        return v, ct

    def _pad(self, n: IRNode) -> Tuple[str, str]:
        p = n.params
        h_in, w_in = type_shape(n.input_tys[0])[:2]
        ct = self.ctype_of(n.uid)
        yi = self.let("long long", f"y - {p['t']}", "y")
        xi = self.let("long long", f"x - {p['l']}", "x")
        t = self._read(n.inputs[0], 0, yi, xi, "e")
        fill = torch.full((), p.get("value", 0),
                          dtype=_carrier_dtype(n.input_tys[0]))
        fill = torch_mask(fill, n.ty).to(_carrier_dtype(n.ty)).item()
        return (f"{self.inside(yi, xi, h_in, w_in)} ? {t} : "
                f"{_c_literal(fill, ct)}"), ct

    def _geometry(self, n: IRNode) -> Tuple[str, str]:
        p, u = n.params, n.inputs[0]
        if n.op == "Crop":
            t = self._read(u, 0, f"y + {p['t']}", f"x + {p['l']}", "e")
        elif n.op == "Downsample":
            t = self._read(u, 0, f"y * {p['sy']}", f"x * {p['sx']}", "e")
        else:                           # Upsample
            t = self._read(u, 0, f"mk_floordiv(y, {p['sy']})",
                           f"mk_floordiv(x, {p['sx']})", "e")
        return t, self.ctype_of(u)

    def _winsum(self, n: IRNode) -> Tuple[str, str]:
        stn = self.mk.winsum[n.uid]
        u = stn.inputs[0]
        if self.ctype_of(u) != "long long":
            raise MKUnsupported(f"%{n.uid}: box sum over a non-integer "
                                f"carrier")
        l, b, sh, sw = _winsum_geometry(stn)
        acc = self.tmp("acc")
        self.emit(f"mk_u64 {acc} = 0ULL;")
        self.emit(f"for (int dy = 0; dy < {sh}; ++dy) {{")
        self.ind += 1
        self.emit(f"for (int dx = 0; dx < {sw}; ++dx) {{")
        self.ind += 1
        t = self._read(u, 0, f"y + {b} + dy", f"x + {l} + dx", "0")
        self.emit(f"{acc} += static_cast<mk_u64>({t});")
        self.ind -= 1
        self.emit("}")
        self.ind -= 1
        self.emit("}")
        return f"static_cast<long long>({acc})", "long long"

    def _body(self, n: IRNode) -> Tuple[str, str]:
        if n.uid in self.mk.winsum:
            return self._winsum(n)
        return {"Map": self._map, "Reduce": self._reduce,
                "ReducePatch": self._reduce_patch, "ArgMin": self._argmin,
                "Stack": self._stack, "Pad": self._pad,
                "Crop": self._geometry, "Downsample": self._geometry,
                "Upsample": self._geometry}[n.op](n)

    # ---- the kernel ----
    def _phase(self, count: int, inner: int, cols: int, y0: str, x0: str,
               body: Callable[[], None]) -> None:
        """A loop of all threads over ``count`` window elements."""
        self.emit(f"for (int i = threadIdx.x; i < {count}; "
                  f"i += blockDim.x) {{")
        self.ind += 1
        self.emit(f"const int e = i % {inner};" if inner > 1
                  else "const int e = 0;")
        self.emit(f"const int p = i / {inner};" if inner > 1
                  else "const int p = i;")
        self.emit(f"const long long y = {y0} + p / {cols};")
        self.emit(f"const long long x = {x0} + p % {cols};")
        body()
        self.ind -= 1
        self.emit("}")

    def write(self) -> Tuple[str, str]:
        mk, ir = self.mk, self.ir
        kname = f"{mk.name}_kernel"
        th, tw = mk.tile
        offsets, smem = _smem_layout(ir, mk.stored, mk.rows, mk.cols)
        head = [
            f"// K3 megakernel {mk.name}: {mk.n_nodes} fused nodes, "
            f"generated by src/repro_torch/core/lowering/megakernel.py",
            f"// tile {th}x{tw}, {mk.threads} threads, {smem} B of shared "
            f"memory; replaces src/repro/core/lowering/megakernel.py"
            f"::emit_megakernel",
            '#include "mk_common.cuh"', "", "namespace {", ""]
        for u, val in mk.consts.items():
            ct = _ctype(_carrier_dtype(ir.nodes[u].ty))
            flat = val.reshape(-1)
            if ct == "float":
                ct = "unsigned int"
                body = ", ".join(f"0x{int(b):08x}u"
                                 for b in flat.view(np.uint32))
            else:
                body = ", ".join(_c_literal(v, ct) for v in flat)
            head.append(f"__device__ const {ct} k{self.local[u]}[{max(1, flat.size)}]"
                        f" = {{{body}}};")
        params = []
        for j, lf in enumerate(mk.in_leaves):
            params.append(f"const {_ctype(lf.dtype)}* __restrict__ in{j}")
            params.append(f"long long fs{j}")
        for j, lf in enumerate(mk.out_leaves):
            params.append(f"{_ctype(lf.dtype)}* __restrict__ out{j}")
        head += ["", f"__global__ void __launch_bounds__({mk.threads})",
                 f"{kname}(" + ",\n    ".join(params) + ") {",
                 "  extern __shared__ __align__(16) unsigned char mk_smem[];",
                 "  const long long f = blockIdx.z;",
                 f"  const long long r0 = (long long)blockIdx.y * {th};",
                 f"  const long long c0 = (long long)blockIdx.x * {tw};"]
        for u in mk.stored:
            ct = self.ctype_of(u)
            head.append(f"  {ct}* w{self.local[u]} = reinterpret_cast<{ct}*>(mk_smem + "
                        f"{offsets[u]});")
        # offsets in reverse schedule order: consumers before producers
        for n in reversed(mk.nodes):
            if mk.rows.get(n.uid, WHOLE) is WHOLE:
                continue
            head.append(f"  const long long or_{self.local[n.uid]} = "
                        f"{mk.rows[n.uid].expr};")
            head.append(f"  const long long oc_{self.local[n.uid]} = "
                        f"{mk.cols[n.uid].expr};")
        for n in mk.nodes:
            if n.uid not in self.stored:
                continue
            shape = type_shape(n.ty)
            inner = math.prod(shape[2:])
            sr, sc = mk.rows[n.uid].size, mk.cols[n.uid].size
            ct = self.ctype_of(n.uid)
            self.emit(f"// node {self.local[n.uid]} = {n.op}"
                      + (f"({n.params['fn'].name})" if "fn" in n.params
                         else "") + f": window {sr}x{sc}x{inner}")

            def body(n=n, shape=shape, ct=ct):
                v = self.tmp("v")
                self.emit(f"{ct} {v} = {_ZERO[ct]};")
                self.emit(f"if {self.inside('y', 'x', *shape[:2])} {{")
                self.ind += 1
                expr, got = self._body(n)
                if got != ct:
                    raise MKUnsupported(f"%{n.uid}:{n.op} computes {got}, "
                                        f"its type carries {ct}")
                self.emit(f"{v} = {_c_mask(expr, n.ty)};")
                self.ind -= 1
                self.emit("}")
                self.emit(f"w{self.local[n.uid]}[i] = {v};")

            i = self.local[n.uid]
            self._phase(sr * sc * inner, inner, sc, f"or_{i}", f"oc_{i}",
                        body)
            self.emit("__syncthreads();")
        for j, lf in enumerate(mk.out_leaves):
            h, w = lf.shape[:2]
            inner = math.prod(lf.shape[2:])
            self.emit(f"// output {j}: node {self.local.get(lf.uid)}"
                      + (f"[{lf.k}]" if lf.k is not None else ""))

            def body(lf=lf, j=j, h=h, w=w, inner=inner):
                self.emit(f"if (y < {h} && x < {w}) {{")
                self.ind += 1
                t = self._read(lf.uid, lf.k or 0, "y", "x", "e")
                self.emit(f"out{j}[f * {h * w * inner} + (y * {w} + x) * "
                          f"{inner} + e] = {t};")
                self.ind -= 1
                self.emit("}")

            self._phase(th * tw * inner, inner, tw, "r0", "c0", body)
        gx, gy = mk.grid_xy
        ins = ", ".join(f"static_cast<const {_ctype(lf.dtype)}*>(ins[{j}]), "
                        f"fstride[{j}]" for j, lf in enumerate(mk.in_leaves))
        outs = ", ".join(f"static_cast<{_ctype(lf.dtype)}*>(outs[{j}])"
                         for j, lf in enumerate(mk.out_leaves))
        launcher = [
            "// launcher",
            'extern "C" int mk_launch(void* const* ins, '
            "const long long* fstride, void* const* outs, int frames, "
            "void* stream) {",
            f"  if ({smem} > 48 * 1024) {{",
            f"    const cudaError_t err = cudaFuncSetAttribute({kname}, "
            f"cudaFuncAttributeMaxDynamicSharedMemorySize, {smem});",
            "    if (err != cudaSuccess) return static_cast<int>(err);",
            "  }",
            f"  const dim3 grid({gx}, {gy}, frames);",
            f"  {kname}<<<grid, {mk.threads}, {smem}, "
            "static_cast<cudaStream_t>(stream)>>>(",
            "      " + ", ".join(x for x in (ins, outs) if x) + ");",
            "  return static_cast<int>(cudaGetLastError());",
            "}", ""]
        text = "\n".join(head + self.lines + ["}", "", "}  // namespace", ""]
                         + launcher)
        return text, kname
