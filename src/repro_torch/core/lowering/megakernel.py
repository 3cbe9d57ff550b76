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
z, so a batch is one launch).

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

The kernel's layout (``_plan``).  Values live in registers unless a
reader needs them elsewhere:

* a node read only at its readers' own pixel, by readers over its own
  window, is *inline*: a register ``let`` computed once per element where
  its readers are computed; a Map over a Stencil patch with one consumer
  folds into its Reduce so, and the float tails of FLOW and DESCRIPTOR
  never leave registers;
* a node read at a shifted pixel (through a Stencil, a Pad or Crop, a
  resampling or a box sum) or over another window is *stored*: its window
  goes to shared memory, in 32 bits when its type fits (widened to the
  int64 carrier on every read);
* pure index remaps (Stencil, TupleIndex, Concat, FanOut, FanIn,
  Replicate) are read *through*: a consumer reads patch element (dy, dx)
  of a Stencil straight from the Stencil's input;
* integer box-sum chains (Stencil -> Map(AddMSBs)* -> Reduce(Add)) are
  never computed link by link (the reference's peephole): a column pass
  keeps sh-row sums of the chain's input window in shared memory, sliding
  down each column, and the Reduce adds sw of them;
* segment inputs are read from device memory where used, zero outside
  the frame;
* Consts are known at emission time and baked into the source, masked to
  their type.

Each job (a column pass, the stored nodes and outputs of one window)
runs at one more than the level of the jobs it reads; a level is one loop
of all threads over its jobs' elements, and a ``__syncthreads()``
separates levels.  Segment outputs are written from registers.  Tile
coordinates and shared-memory indices are ``int``; the frame offset
``f * fs`` is 64-bit, and so is the index within a frame of more than
2**31 - 1 elements.

If the windows do not fit at the starting tile, the emitter halves the
tile's columns; if nothing fits, or a node needs a whole-frame value
(``WHOLE`` demand: no tile form), it raises ``MKUnsupported`` and the
engine keeps the generic path for that segment, with a note.
``__launch_bounds__`` names the blocks per SM the shared memory allows.

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

from ...kernels.stream import (MK_BLOCK_ROWS, MK_SM_SMEM, MK_SM_THREADS,
                               MK_SMEM_LIMIT, MK_SMEM_RESERVED, MK_THREADS,
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
    n_winsum: int = 0                   # box-sum chains, summed separably
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
    min_blocks: int = 1                 # blocks per SM the windows allow
    # the geometry, for the plain version and the CPU model of the tiling
    nodes: List[IRNode] = field(default_factory=list)
    in_leaves: List[IOLeaf] = field(default_factory=list)
    out_leaves: List[IOLeaf] = field(default_factory=list)
    in_uids: Tuple[int, ...] = ()
    out_uids: Tuple[int, ...] = ()
    rows: Dict[int, Any] = field(default_factory=dict)
    cols: Dict[int, Any] = field(default_factory=dict)
    stored: List[int] = field(default_factory=list)   # windows in smem
    inline: frozenset = frozenset()     # computed in registers where read
    levels: List[List[tuple]] = field(default_factory=list)
    skip: frozenset = frozenset()
    winsum: Dict[int, IRNode] = field(default_factory=dict)
    consts: Dict[int, np.ndarray] = field(default_factory=dict)

    @property
    def barriers(self) -> int:
        """Block-wide barriers: one between consecutive phases."""
        return max(0, len(self.levels) - 1)

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
        ws = (f", {self.n_winsum} box-sum chain(s) as separable sums"
              if self.n_winsum else "")
        return (f"{self.name}: {self.n_nodes} fused nodes, "
                f"grid={self.grid}x{self.block_rows}rows, "
                f"linebuf={self.linebuf_bytes}B{extra}, {tier}{ws}; "
                f"CUDA tile {self.tile[0]}x{self.tile[1]}, "
                f"smem={self.smem_bytes}B, {len(self.levels)} phase(s), "
                f"{len(self.stored)} stored window(s)")


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


def _smem_ctype(ty) -> str:
    """The shared-memory type of a stored window: 32 bits for an integer
    type of at most 32 bits (widened to the int64 carrier on every read),
    the carrier otherwise."""
    s = scalar_of(ty)
    if isinstance(s, Int) and s.bits() <= 32:
        return "int"
    if isinstance(s, (UInt, Bits)) and s.bits() <= 32:
        return "unsigned"
    return _ctype(_carrier_dtype(ty))


_SMEM_BYTES = {"int": 4, "unsigned": 4, "float": 4, "bool": 1,
               "long long": 8, "mk_u64": 8}


@dataclass
class _Plan:
    """Which values live where, and the kernel's phases.

    A computed node is *inline* when every read of it is at the reader's
    own pixel, every reader computes over the node's own window, and it is
    not a patch with several consumers: it is then a register ``let`` in
    the phase of its readers, computed once per element (a patch Map
    folds into its Reduce so).  Any other computed node is *stored*: its
    window is written to shared memory in a phase of its own window.
    Input leaves are read from device memory where used.  Each box-sum
    chain keeps the column sums of its input window in shared memory.  A
    job's level is one more than the highest level of the jobs it reads,
    and a barrier separates consecutive levels."""

    stored: List[int]
    inline: set
    levels: List[List[tuple]]
    layout: Dict[tuple, Tuple[int, str]]    # array -> (byte offset, ctype)
    smem: int


def _plan(ir: LoweringIR, nodes: List[IRNode], rows, cols,
          in_leaves: List[IOLeaf], out_leaves: List[IOLeaf], winsum, skip,
          tile: Tuple[int, int], frame: Tuple[int, int]) -> _Plan:
    th, tw = tile
    by_uid = {n.uid: n for n in nodes}
    in_index = {(lf.uid, lf.k or 0): j for j, lf in enumerate(in_leaves)}
    row_starts = range(0, frame[0], th)
    col_starts = range(0, frame[1], tw)

    def key(u) -> tuple:
        """A window, as its size and offset at every tile start."""
        rd, cd = rows[u], cols[u]
        return (rd.size, tuple(rd.off(s) for s in row_starts),
                cd.size, tuple(cd.off(s) for s in col_starts))

    seed = (th, tuple(row_starts), tw, tuple(col_starts))
    computed = [n for n in nodes if n.op != "Const" and n.uid not in skip
                and n.op not in _THROUGH_OPS]
    keys = {n.uid: key(n.uid) for n in computed}

    own: Dict[Tuple[int, int], set] = {}    # value -> readers' windows
    shifted: set = set()                    # values read at another pixel

    def visit(u: int, k: int, kind: str, reader) -> None:
        n = by_uid.get(u)
        if n is not None and n.op in _THROUGH_OPS:
            for v, kk, kd in _through_reads(n, k, kind):
                visit(v, kk, kd, reader)
        elif kind == "own":
            own.setdefault((u, k), set()).add(reader)
        else:
            shifted.add((u, k))

    for n in computed:
        for u, k, kind in _reads(n, winsum):
            if kind != "whole":
                visit(u, k, kind, keys[n.uid])
    for lf in out_leaves:
        visit(lf.uid, lf.k or 0, "own", seed)

    # a patch (a value with elements per pixel) of several consumers is
    # stored too: each consumer would hold or recompute all its elements
    stored = [n.uid for n in computed if (n.uid, 0) in shifted
              or own.get((n.uid, 0), set()) - {keys[n.uid]}
              or (len(type_shape(n.ty)) > 2 and len(set(n.consumers)) > 1)]
    stored_set = set(stored)
    inline = {n.uid for n in computed} - stored_set

    # ---- jobs and their levels ----
    def deps(u: int, k: int) -> set:
        """The jobs a read of value (u, k) waits for."""
        if (u, k) in in_index:
            return set()
        n = by_uid[u]
        if n.op == "Const":
            return set()
        if n.op in _THROUGH_OPS:
            return set().union(*(deps(v, kk) for v, kk, _ in
                                 _through_reads(n, k, "own")))
        if u in stored_set:
            return {("node", u)}
        return body_deps(n)

    def body_deps(n: IRNode) -> set:
        if n.uid in winsum:
            return {("colsum", n.uid)}
        return set().union(*(deps(u, k) for u, k, _ in _reads(n, winsum)))

    job_deps = {}
    for w_uid, stn in winsum.items():
        job_deps[("colsum", w_uid)] = deps(stn.inputs[0], 0)
    for u in stored:
        job_deps[("node", u)] = body_deps(by_uid[u])
    for j, lf in enumerate(out_leaves):
        job_deps[("out", j)] = deps(lf.uid, lf.k or 0)
    level: Dict[tuple, int] = {}

    def level_of(job) -> int:
        if job not in level:
            level[job] = 1 + max((level_of(d) for d in job_deps[job]),
                                 default=-1)
        return level[job]

    by_level: Dict[int, List[tuple]] = {}
    groups: Dict[Tuple[int, tuple], list] = {}
    for job in job_deps:                # colsum, node, out: in order
        lv = level_of(job)
        if job[0] == "colsum":
            by_level.setdefault(lv, []).append(job)
            continue
        u = job[1] if job[0] == "node" else None
        gk = (lv, keys[u] if u is not None else seed)
        if gk not in groups:
            groups[gk] = ["pixels", u, [], []]
            by_level.setdefault(lv, []).append(groups[gk])
        (groups[gk][2] if u is not None else groups[gk][3]).append(job[1])
    levels = [[tuple(j) for j in by_level[lv]] for lv in sorted(by_level)]

    # ---- shared memory: stored windows, column sums ----
    arrays = []
    for u in stored:
        ty = by_uid[u].ty
        arrays.append((("node", u), rows[u].size * cols[u].size
                       * math.prod(type_shape(ty)[2:]), _smem_ctype(ty)))
    for w_uid, stn in winsum.items():
        sw = _winsum_geometry(stn)[3]
        arrays.append((("colsum", w_uid),
                       rows[w_uid].size * (cols[w_uid].size + sw - 1),
                       "mk_u64"))
    layout, total = {}, 0
    for name, count, ct in arrays:
        layout[name] = (total, ct)
        total += -(-count * _SMEM_BYTES[ct] // 16) * 16
    return _Plan(stored, inline, levels, layout, total)


def _reads(n: IRNode, winsum) -> List[Tuple[int, int, str]]:
    """(value, leg, kind) of each read of computed node ``n``: ``own`` at
    its own pixel, ``shift`` at another (or over a window), ``whole`` a
    broadcast operand."""
    if n.uid in winsum:
        return [(winsum[n.uid].inputs[0], 0, "shift")]
    if n.op == "Map":
        return [(u, 0, "own" if _map_streams_input(n, j) else "whole")
                for j, u in enumerate(n.inputs)]
    if n.op in ("Reduce", "ReducePatch", "ArgMin", "Stack"):
        return [(u, 0, "own") for u in n.inputs]
    return [(n.inputs[0], 0, "shift")]  # Pad, Crop, Downsample, Upsample


def _through_reads(n: IRNode, k: int, kind: str
                   ) -> List[Tuple[int, int, str]]:
    """What leg ``k`` of read-through node ``n`` reads, and how."""
    if n.op == "Stencil":
        return [(n.inputs[0], 0, "shift")]
    if n.op == "TupleIndex":
        return [(n.inputs[0], n.params["i"], kind)]
    if n.op == "Concat":
        return [(n.inputs[k], 0, kind)]
    if n.op == "FanIn":
        return [(n.inputs[0], k, kind)]
    return [(n.inputs[0], 0, kind)]     # FanOut, Replicate


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

    # ---- the tile: halve its columns until the windows fit ----
    tw = min(tile_cols or MK_TILE_COLS, w_out)
    while True:
        cols = _demand_pass(nodes, span, out_uids, tw, "cols")
        for n in node_list:
            if cols[n.uid] is WHOLE:
                raise MKUnsupported(f"%{n.uid}:{n.op} needs whole frame "
                                    f"columns (no tile form)")
        plan = _plan(ir, nodes, rows, cols, in_leaves, out_leaves, winsum,
                     skip, (block, tw), (h_out, w_out))
        if plan.smem <= MK_SMEM_LIMIT or tile_cols is not None:
            break
        if tw == 1:
            raise MKUnsupported(f"windows need {plan.smem}B of shared "
                                f"memory even at 1-column tiles")
        tw = max(1, tw // 2)
    if plan.smem > MK_SMEM_LIMIT:
        raise MKUnsupported(f"windows need {plan.smem}B of shared memory "
                            f"at {block}x{tw} tiles")

    mk = Megakernel(
        name, len(node_list), len(in_leaves), block, grid, linebuf,
        whole_b, float_nodes, len(winsum), flops=flops, io_bytes=io_bytes,
        tile=(block, tw), grid_xy=(-(-w_out // tw), grid),
        smem_bytes=plan.smem, min_blocks=blocks_per_sm(plan.smem),
        nodes=list(nodes), in_leaves=in_leaves, out_leaves=out_leaves,
        in_uids=tuple(in_uids), out_uids=tuple(out_uids), rows=rows,
        cols=cols, stored=plan.stored, inline=frozenset(plan.inline),
        levels=plan.levels, skip=frozenset(skip),
        winsum=winsum, consts=consts)
    mk.source, mk.kernel_name = _CudaWriter(ir, mk, plan.layout).write()
    ops = [n.op for n in node_list]
    mk.note = (f"{name}: fused {len(node_list)} nodes "
               f"({ops[0]}..{ops[-1]}) into one CUDA kernel "
               f"({mk.grid_xy[0]}x{grid} tiles of {block}x{tw})")
    return mk


def blocks_per_sm(smem: int, threads: int = MK_THREADS) -> int:
    """Blocks of ``threads`` threads and ``smem`` bytes of shared memory
    one SM holds at once (the runtime reserves 1 KB a block)."""
    return max(1, min(MK_SM_THREADS // threads,
                      MK_SM_SMEM // (smem + MK_SMEM_RESERVED)))


# --------------------------------------------------------------------------
# CUDA C++ generation

_CTYPE = {torch.int64: "long long", torch.float32: "float",
          torch.bool: "bool"}
_ZERO = {"long long": "0LL", "float": "0.0f", "bool": "false", "int": "0",
         "unsigned": "0u"}
# a fold, a box row or an element loop of at most this many steps is
# unrolled in the source, so its element indices and constants fold
_UNROLL = 64


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


# element indices: Python ints where they are known when the source is
# written (unrolled steps), C expressions otherwise; all are nonnegative,
# so C's truncating / and % agree with Python's

def _ix_add(a, b):
    if isinstance(a, int) and isinstance(b, int):
        return a + b
    if a == 0:
        return b
    return a if b == 0 else f"{a} + {b}"


def _ix_mul(a, c: int):
    if isinstance(a, int):
        return a * c
    return a if c == 1 else f"({a}) * {c}"


def _ix_div(a, c: int):
    if isinstance(a, int):
        return a // c
    return a if c == 1 else f"({a}) / {c}"


def _ix_mod(a, c: int):
    if isinstance(a, int):
        return a % c
    return 0 if c == 1 else f"({a}) % {c}"


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
    statements that load element ``e`` of leaf ``k`` of value ``u`` at
    virtual coordinates ``(y, x)`` and returns the C variable holding it:
    stored nodes read their shared-memory window, input leaves device
    memory with zero fill outside the frame,
    Consts their baked values, read-through nodes remap to their inputs,
    and an inline node is computed there, once per element and scope."""

    def __init__(self, ir: LoweringIR, mk: Megakernel, layout):
        self.ir, self.mk, self.layout = ir, mk, layout
        self.lines: List[str] = []
        self.ind = 1
        self.n_tmp = 0
        self.in_index = {(lf.uid, lf.k or 0): j
                         for j, lf in enumerate(mk.in_leaves)}
        self.stored = set(mk.stored)
        self.memo: List[Dict[tuple, str]] = [{}]
        # C names follow positions in the segment, not global uids, so
        # equal segments write equal text (and share one cached build)
        self.local = {n.uid: i for i, n in enumerate(mk.nodes)}

    # ---- small helpers ----
    def emit(self, line: str) -> None:
        self.lines.append("  " * self.ind + line)

    def open(self, line: str) -> None:
        """Emit ``line`` (ending in ``{``) and enter its C scope."""
        self.emit(line)
        self.ind += 1
        self.memo.append({})

    def close(self, line: str = "}") -> None:
        self.ind -= 1
        self.memo.pop()
        self.emit(line)

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

    def const_at(self, u: int, idx) -> str:
        """Element ``idx`` of baked Const ``u``: its literal when ``idx`` is
        known, else a load (f32 values are stored as their bit patterns: a
        __device__ initializer must be constant)."""
        ct = self.ctype_of(u)
        if isinstance(idx, int):
            return _c_literal(self.mk.consts[u].reshape(-1)[idx], ct)
        if ct == "float":
            return f"__int_as_float(static_cast<int>(k{self.local[u]}[{idx}]))"
        return f"k{self.local[u]}[{idx}]"

    def let(self, ctype: str, expr: str, prefix: str = "t") -> str:
        v = self.tmp(prefix)
        self.emit(f"const {ctype} {v} = {expr};")
        return v

    @staticmethod
    def frame_index(y: str, x: str, h: int, w: int, inner: int, e) -> str:
        """Element ``e`` of pixel (y, x) in a frame of h x w x inner
        elements, in 64 bits where an int cannot index the frame."""
        row = f"({y})" if h * w * inner < 2 ** 31 else \
            f"static_cast<long long>({y})"
        return str(_ix_add(_ix_mul(f"{row} * {w} + ({x})", inner), e))

    # ---- reads ----
    def _read(self, u: int, k: int, y: str, x: str, e) -> str:
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
            idx = self.frame_index(y, x, h, w, inner, e)
            return self.let(ct, f"{self.inside(y, x, h, w)} ? in{j}[f * fs{j}"
                                f" + {idx}] : {_ZERO[ct]}")
        if u in self.stored:
            sc = self.mk.cols[u].size
            i = self.local[u]
            idx = _ix_add(_ix_mul(f"(({y}) - or_{i}) * {sc} + (({x}) - "
                                  f"oc_{i})", inner), e)
            val = f"w{i}[{idx}]"
            if self.layout[("node", u)][1] != ct:
                val = f"static_cast<{ct}>({val})"   # widen to the carrier
            return self.let(ct, val)
        if n.op == "Const":
            h, w = shape[:2]
            idx = f"(({y}) * {w} + ({x})) * {inner} + ({e})"
            return self.let(ct, f"{self.inside(y, x, h, w)} ? "
                                f"{self.const_at(u, idx)} : {_ZERO[ct]}")
        p = n.params
        if n.op == "Stencil":
            l, b, sh, sw = _winsum_geometry(n)
            e_in = math.prod(type_shape(n.input_tys[0])[2:])
            q, ei = _ix_div(e, e_in), _ix_mod(e, e_in)
            if isinstance(q, int):
                yy = f"({y}) + {b + q // sw}"
                xx = f"({x}) + {l + q % sw}"
            else:
                yy = self.let("int", f"({y}) + {b} + ({q}) / {sw}", "y")
                xx = self.let("int", f"({x}) + {l} + ({q}) % {sw}", "x")
            v = self._read(n.inputs[0], 0, yy, xx, ei)
            h, w = shape[:2]
            return self.let(ct, f"{self.inside(y, x, h, w)} ? {v} : "
                                f"{_ZERO[ct]}")
        if n.op in _THROUGH_OPS:
            (v, kk, _), = _through_reads(n, k, "own")
            if n.op == "Replicate":
                if len(type_shape(n.input_tys[0])) != 2:
                    raise MKUnsupported(f"%{u}: Replicate of a non-plain "
                                        f"image")
                e = _ix_div(e, p["m"] * p["n"])
            return self._read(v, kk, y, x, e)
        # an inline node: computed here, once per element and scope
        key = (u, y, x, str(e))
        for scope in reversed(self.memo):
            if key in scope:
                return scope[key]
        val = self._value(n, y, x, e)
        self.memo[-1][key] = val
        return val

    def _value(self, n: IRNode, y: str, x: str, e) -> str:
        """Node ``n`` at (y, x, e), masked to its type, in a new let."""
        ct = self.ctype_of(n.uid)
        expr, got = self._body(n, y, x, e)
        if got != ct:
            raise MKUnsupported(f"%{n.uid}:{n.op} computes {got}, its type "
                                f"carries {ct}")
        return self.let(ct, _c_mask(expr, n.ty))

    def _read_whole(self, u: int, idx) -> str:
        """Element ``idx`` (flat, over the type's whole shape) of a value
        that does not ride the tile: a baked Const of this segment, or a
        segment input (a Const that another segment holds is one)."""
        n = self.node(u)
        ct = self.ctype_of(u)
        if u in self.mk.consts:
            return self.let(ct, self.const_at(u, idx))
        if (u, 0) in self.in_index and not isinstance(n.ty, TupleT):
            j = self.in_index[(u, 0)]
            return self.let(ct, f"in{j}[f * fs{j} + {idx}]")
        raise MKUnsupported(f"%{u}:{n.op} broadcasts whole into a Map")

    # ---- index arithmetic ----
    def _bcast_index(self, out_shape, a_shape, dims: List[Any]):
        """Flat index into an operand of aligned shape ``a_shape`` for the
        output multi-index ``dims`` (numpy broadcasting)."""
        idx, stride = 0, 1
        for d in reversed(range(len(out_shape))):
            if a_shape[d] != 1:
                idx = _ix_add(_ix_mul(dims[d], stride), idx)
            stride *= a_shape[d]
        return idx

    def _inner_dims(self, inner: Tuple[int, ...], e) -> List[Any]:
        """The multi-index over ``inner`` of flat inner index ``e``."""
        dims, stride = [], math.prod(inner)
        for s in inner:
            stride //= s
            dims.append(_ix_mod(_ix_div(e, stride), s))
        return dims

    # ---- node bodies: the value of node n at (y, x, e), as a C expression
    # and its C type, after the statements they need ----
    def _map(self, n: IRNode, y: str, x: str, e) -> Tuple[str, str]:
        out_shape = type_shape(n.ty)
        plans = map_reshape_plans(n.ty, n.input_tys)
        inner = out_shape[2:]
        dims = [y, x] + self._inner_dims(inner, e)
        args = []
        for j, (u, plan) in enumerate(zip(n.inputs, plans)):
            a = _aligned_shape(out_shape, n.input_tys[j], plan)
            if _map_streams_input(n, j):
                if tuple(a[:2]) != tuple(out_shape[:2]):
                    raise MKUnsupported(f"%{n.uid}: operand %{u} does not "
                                        f"align with the frame")
                e_j = (e if tuple(a[2:]) == tuple(inner)
                       else self._bcast_index(inner, a[2:], dims[2:]))
                args.append((self._read(u, 0, y, x, e_j), self.ctype_of(u)))
            else:
                idx = self._bcast_index(out_shape, a, dims)
                args.append((self._read_whole(u, idx), self.ctype_of(u)))
        return _c_point_fn(n.params["fn"], args)

    def _steps(self, count: int, first: int, body: Callable[[Any], None]
               ) -> None:
        """``body(j)`` for j in [first, count): unrolled with Python ints up
        to ``_UNROLL`` steps, else a C loop."""
        if count <= _UNROLL:
            for j in range(first, count):
                body(j)
            return
        j = self.tmp("j")
        self.open(f"for (int {j} = {first}; {j} < {count}; ++{j}) {{")
        body(j)
        self.close()

    def _fold(self, n: IRNode, count: int, e_in: Callable[[Any], Any],
              y: str, x: str) -> Tuple[str, str]:
        """fn folded over ``count`` input elements, in order."""
        u = n.inputs[0]
        ct = self.ctype_of(u)
        acc = self.tmp("acc")
        first = self._read(u, 0, y, x, e_in(0))
        fn_ct = _c_point_fn(n.params["fn"], [(acc, ct), (first, ct)])[1]
        if fn_ct != ct:
            raise MKUnsupported(f"%{n.uid}: {n.params['fn'].name} changes "
                                f"the carrier inside a fold")
        self.emit(f"{ct} {acc} = {first};")

        def step(j):
            t = self._read(u, 0, y, x, e_in(j))
            expr, _ = _c_point_fn(n.params["fn"], [(acc, ct), (t, ct)])
            self.emit(f"{acc} = {expr};")

        self._steps(count, 1, step)
        return acc, ct

    def _reduce(self, n: IRNode, y: str, x: str, e) -> Tuple[str, str]:
        s_in = type_shape(n.input_tys[0])[2:]
        r = s_in[-2] * s_in[-1]
        return self._fold(n, r, lambda j: _ix_add(_ix_mul(e, r), j), y, x)

    def _reduce_patch(self, n: IRNode, y: str, x: str, e
                      ) -> Tuple[str, str]:
        s_in = type_shape(n.input_tys[0])[2:]
        e_size = math.prod(s_in[2:])
        return self._fold(n, s_in[0] * s_in[1],
                          lambda j: _ix_add(_ix_mul(j, e_size), e), y, x)

    def _argmin(self, n: IRNode, y: str, x: str, e) -> Tuple[str, str]:
        u = n.inputs[0]
        s_in = type_shape(n.input_tys[0])[2:]
        r = s_in[-2] * s_in[-1]
        ct = self.ctype_of(u)
        best, arg = self.tmp("best"), self.tmp("arg")
        first = self._read(u, 0, y, x, _ix_mul(e, r))
        self.emit(f"{ct} {best} = {first};")
        self.emit(f"long long {arg} = 0;")

        def step(j):
            t = self._read(u, 0, y, x, _ix_add(_ix_mul(e, r), j))
            self.emit(f"if ({t} < {best}) {{ {best} = {t}; {arg} = {j}; }}")

        self._steps(r, 1, step)
        return arg, "long long"

    def _stack(self, n: IRNode, y: str, x: str, e) -> Tuple[str, str]:
        kk = len(n.inputs)
        ct = self.ctype_of(n.uid)
        for u in n.inputs:
            if self.ctype_of(u) != ct or type_shape(self.node(u).ty) != \
                    type_shape(n.input_tys[0]):
                raise MKUnsupported(f"%{n.uid}: Stack of unlike operands")
        if isinstance(e, int):
            return self._read(n.inputs[e % kk], 0, y, x, e // kk), ct
        v = self.tmp("v")
        self.emit(f"{ct} {v} = {_ZERO[ct]};")
        self.emit(f"switch (({e}) % {kk}) {{")
        for j, u in enumerate(n.inputs):
            self.open(f"case {j}: {{")
            t = self._read(u, 0, y, x, f"({e}) / {kk}")
            self.emit(f"{v} = {t};")
            self.emit("break;")
            self.close()
        self.emit("}")
        return v, ct

    def _pad(self, n: IRNode, y: str, x: str, e) -> Tuple[str, str]:
        p = n.params
        h_in, w_in = type_shape(n.input_tys[0])[:2]
        ct = self.ctype_of(n.uid)
        yi = self.let("int", f"({y}) - {p['t']}", "y")
        xi = self.let("int", f"({x}) - {p['l']}", "x")
        t = self._read(n.inputs[0], 0, yi, xi, e)
        fill = torch.full((), p.get("value", 0),
                          dtype=_carrier_dtype(n.input_tys[0]))
        fill = torch_mask(fill, n.ty).to(_carrier_dtype(n.ty)).item()
        return (f"{self.inside(yi, xi, h_in, w_in)} ? {t} : "
                f"{_c_literal(fill, ct)}"), ct

    def _geometry(self, n: IRNode, y: str, x: str, e) -> Tuple[str, str]:
        p, u = n.params, n.inputs[0]
        if n.op == "Crop":
            t = self._read(u, 0, f"({y}) + {p['t']}", f"({x}) + {p['l']}",
                           e)
        elif n.op == "Downsample":
            t = self._read(u, 0, f"({y}) * {p['sy']}", f"({x}) * {p['sx']}",
                           e)
        else:                           # Upsample
            t = self._read(u, 0, f"mk_floordiv({y}, {p['sy']})",
                           f"mk_floordiv({x}, {p['sx']})", e)
        return t, self.ctype_of(u)

    def _winsum(self, n: IRNode, y: str, x: str, e) -> Tuple[str, str]:
        """The row pass of a box sum: sw column sums of its row."""
        stn = self.mk.winsum[n.uid]
        if self.ctype_of(stn.inputs[0]) != "long long":
            raise MKUnsupported(f"%{n.uid}: box sum over a non-integer "
                                f"carrier")
        sw = _winsum_geometry(stn)[3]
        i = self.local[n.uid]
        csc = self.mk.cols[n.uid].size + sw - 1
        base = self.let("int", f"(({y}) - or_{i}) * {csc} + (({x}) - "
                               f"oc_{i})", "cs")
        acc = self.tmp("acc")
        self.emit(f"mk_u64 {acc} = c{i}[{base}];")
        self._steps(sw, 1, lambda dx: self.emit(
            f"{acc} += c{i}[{base} + {dx}];"))
        return f"static_cast<long long>({acc})", "long long"

    def _body(self, n: IRNode, y: str, x: str, e) -> Tuple[str, str]:
        if n.uid in self.mk.winsum:
            return self._winsum(n, y, x, e)
        return {"Map": self._map, "Reduce": self._reduce,
                "ReducePatch": self._reduce_patch, "ArgMin": self._argmin,
                "Stack": self._stack, "Pad": self._pad,
                "Crop": self._geometry, "Downsample": self._geometry,
                "Upsample": self._geometry}[n.op](n, y, x, e)

    # ---- the jobs of a phase: each gets its element index ``p`` ----
    def _job_count(self, job: tuple) -> int:
        if job[0] == "colsum":
            sw = _winsum_geometry(self.mk.winsum[job[1]])[3]
            return self.mk.cols[job[1]].size + sw - 1
        u = job[1]
        if u is None:
            return self.mk.tile[0] * self.mk.tile[1]
        return self.mk.rows[u].size * self.mk.cols[u].size

    def _colsum_job(self, w_uid: int, p: str) -> None:
        """Column ``p`` of a box sum's column pass: the sums of sh rows of
        the chain's input at each row of the box sum's window, sliding down
        (add the row entering, subtract the row leaving; exact mod 2^64)."""
        stn = self.mk.winsum[w_uid]
        src = stn.inputs[0]
        l, b, sh, sw = _winsum_geometry(stn)
        i = self.local[w_uid]
        csc = self.mk.cols[w_uid].size + sw - 1
        x = self.let("int", f"oc_{i} + {l} + {p}", "x")
        acc = self.tmp("acc")
        self.emit(f"mk_u64 {acc} = 0ULL;")
        if sh > 1:
            k = self.tmp("k")
            self.open(f"for (int {k} = 0; {k} < {sh - 1}; ++{k}) {{")
            t = self._read(src, 0, f"or_{i} + {b} + {k}", x, 0)
            self.emit(f"{acc} += static_cast<mk_u64>({t});")
            self.close()
        r = self.tmp("r")
        self.open(f"for (int {r} = 0; {r} < {self.mk.rows[w_uid].size}; "
                  f"++{r}) {{")
        t = self._read(src, 0, f"or_{i} + {b + sh - 1} + {r}", x, 0)
        self.emit(f"{acc} += static_cast<mk_u64>({t});")
        self.emit(f"c{i}[{r} * {csc} + {p}] = {acc};")
        t = self._read(src, 0, f"or_{i} + {b} + {r}", x, 0)
        self.emit(f"{acc} -= static_cast<mk_u64>({t});")
        self.close()

    def _pixels_job(self, job: tuple, p: str) -> None:
        """One pixel of a window: the stored nodes of the window, each
        written to shared memory (zero outside its frame), and the output
        leaves, all from registers."""
        _, base, stored, outs = job
        if base is None:
            r, c, sc = "r0", "c0", self.mk.tile[1]
        else:
            i = self.local[base]
            r, c, sc = f"or_{i}", f"oc_{i}", self.mk.cols[base].size
        self.emit(f"const int y = {r} + {p} / {sc};")
        self.emit(f"const int x = {c} + {p} % {sc};")
        for u in stored:
            n = self.node(u)
            h, w = type_shape(n.ty)[:2]
            inner = math.prod(type_shape(n.ty)[2:])
            st = self.layout[("node", u)][1]

            def store(e, n=n, h=h, w=w, inner=inner, st=st):
                v = self._value(n, "y", "x", e)
                if st != self.ctype_of(n.uid):
                    v = f"static_cast<{st}>({v})"
                self.emit(f"w{self.local[n.uid]}"
                          f"[{_ix_add(_ix_mul(p, inner), e)}] = "
                          f"{self.inside('y', 'x', h, w)} ? {v} : "
                          f"{_ZERO[st]};")

            self._steps(inner, 0, store)
        # every output leaf has the segment's frame (emit_megakernel)
        h, w = self.mk.out_leaves[0].shape[:2]
        inside = f"if (y < {h} && x < {w}) {{"
        writes = []
        for j in outs:
            lf = self.mk.out_leaves[j]
            inner = math.prod(lf.shape[2:])

            def write(e, lf=lf, j=j, inner=inner):
                t = self._read(lf.uid, lf.k or 0, "y", "x", e)
                line = (f"out{j}[f * {h * w * inner} + "
                        f"{self.frame_index('y', 'x', h, w, inner, e)}] = "
                        f"{t};")
                if isinstance(e, int):
                    writes.append(line)     # after every value is computed
                else:
                    self.open(inside)
                    self.emit(line)
                    self.close()

            self._steps(inner, 0, write)
        if writes:
            self.open(inside)
            for line in writes:
                self.emit(line)
            self.close()

    def _job(self, job: tuple, p: str) -> None:
        if job[0] == "colsum":
            self._colsum_job(job[1], p)
        else:
            self._pixels_job(job, p)

    # ---- the kernel ----
    def _level(self, jobs: List[tuple]) -> None:
        """One phase: all threads stride over the elements of its jobs
        together (a job's range of the loop index each)."""
        counts = [self._job_count(job) for job in jobs]
        self.open(f"for (int i = threadIdx.x; i < {sum(counts)}; "
                  f"i += blockDim.x) {{")
        if len(jobs) == 1:
            self._job(jobs[0], "i")
        else:
            start = 0
            for job, count in zip(jobs, counts):
                self.open(f"if (i >= {start} && i < {start + count}) {{")
                self._job(job, self.let("int", f"i - {start}", "p"))
                self.close()
                start += count
        self.close()

    def _describe(self, job: tuple) -> str:
        if job[0] == "colsum":
            return (f"node {self.local[job[1]]}: column sums, "
                    f"{self.mk.rows[job[1]].size}x{self._job_count(job)}")
        _, base, stored, outs = job
        win = (f"{self.mk.rows[base].size}x{self.mk.cols[base].size}"
               if base is not None else
               f"{self.mk.tile[0]}x{self.mk.tile[1]}")
        what = [f"node {self.local[u]} = {self.node(u).op}" for u in stored]
        what += [f"output {j}" for j in outs]
        return f"window {win}: " + ", ".join(what)

    def write(self) -> Tuple[str, str]:
        mk, ir = self.mk, self.ir
        kname = f"{mk.name}_kernel"
        th, tw = mk.tile
        head = [
            f"// K3 megakernel {mk.name}: {mk.n_nodes} fused nodes, "
            f"generated by src/repro_torch/core/lowering/megakernel.py",
            f"// tile {th}x{tw}, {mk.threads} threads, {mk.smem_bytes} B of "
            f"shared memory, {mk.min_blocks} block(s) per SM, "
            f"{len(mk.levels)} phase(s); replaces "
            f"src/repro/core/lowering/megakernel.py::emit_megakernel",
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
            head.append(f"__device__ const {ct} k{self.local[u]}"
                        f"[{max(1, flat.size)}] = {{{body}}};")
        params = []
        for j, lf in enumerate(mk.in_leaves):
            params.append(f"const {_ctype(lf.dtype)}* __restrict__ in{j}")
            params.append(f"long long fs{j}")
        for j, lf in enumerate(mk.out_leaves):
            params.append(f"{_ctype(lf.dtype)}* __restrict__ out{j}")
        head += ["", f"__global__ void __launch_bounds__({mk.threads}, "
                 f"{mk.min_blocks})",
                 f"{kname}(" + ",\n    ".join(params) + ") {",
                 "  extern __shared__ __align__(16) unsigned char mk_smem[];",
                 "  const long long f = blockIdx.z;",
                 f"  const int r0 = static_cast<int>(blockIdx.y) * {th};",
                 f"  const int c0 = static_cast<int>(blockIdx.x) * {tw};"]
        names = {"node": "w", "colsum": "c"}
        for (kind, v), (off, ct) in self.layout.items():
            name = names[kind] + str(self.local[v])
            head.append(f"  {ct}* {name} = reinterpret_cast<{ct}*>(mk_smem "
                        f"+ {off});")
        # offsets in reverse schedule order: consumers before producers
        for n in reversed(mk.nodes):
            if mk.rows.get(n.uid, WHOLE) is WHOLE:
                continue
            head.append(f"  const int or_{self.local[n.uid]} = "
                        f"{mk.rows[n.uid].expr};")
            head.append(f"  const int oc_{self.local[n.uid]} = "
                        f"{mk.cols[n.uid].expr};")
        for q, jobs in enumerate(mk.levels):
            if q:
                self.emit("__syncthreads();")
            self.emit(f"// phase {q}: " + "; ".join(
                self._describe(job) for job in jobs))
            self._level(jobs)
        gx, gy = mk.grid_xy
        ins = ", ".join(f"static_cast<const {_ctype(lf.dtype)}*>(ins[{j}]), "
                        f"fstride[{j}]" for j, lf in enumerate(mk.in_leaves))
        outs = ", ".join(f"static_cast<{_ctype(lf.dtype)}*>(outs[{j}])"
                         for j, lf in enumerate(mk.out_leaves))
        smem = mk.smem_bytes
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
