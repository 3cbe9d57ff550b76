"""Rigel2: the hardware-description IR (paper §4).

Every module instance carries:
  - interface type: Static (fixed latency) or Stream (ready/valid) (§4)
  - schedule type: vector width = scalar lanes per transaction (§4.1)
  - rate R (tokens/cycle), latency L, burstiness B (§4.2-4.3)
  - a resource estimate (virtual-FPGA cost model; see DESIGN.md §6)

Unlike HLS, every Rigel2 module corresponds to one concrete hardware
generator instance — here each generator carries a deterministic resource
formula and its schedule annotations, the analog of emitting one Verilog
module definition.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from fractions import Fraction
from typing import Any, Dict, List, Optional, Tuple

from .dtypes import DType

# --------------------------------------------------------------------------
# virtual-FPGA resource model


@dataclass(frozen=True)
class Resources:
    luts: int = 0
    regs: int = 0
    dsps: int = 0
    bram_bits: int = 0

    def __add__(self, o: "Resources") -> "Resources":
        return Resources(self.luts + o.luts, self.regs + o.regs,
                         self.dsps + o.dsps, self.bram_bits + o.bram_bits)

    def scaled(self, m: int) -> "Resources":
        return Resources(self.luts * m, self.regs * m, self.dsps * m,
                         self.bram_bits * m)

    @property
    def clbs(self) -> int:
        # UltraScale+ CLB = 8 LUTs; registers co-located (2 FF / LUT)
        return max(math.ceil(self.luts / 8), math.ceil(self.regs / 16))

    @property
    def brams(self) -> int:
        # BRAM18 = 18Kib blocks, as counted by Vivado (paper §7.1)
        return math.ceil(self.bram_bits / 18432)

    def __repr__(self):
        return (f"Resources(clbs={self.clbs}, luts={self.luts}, "
                f"dsps={self.dsps}, brams={self.brams})")


def fifo_resources(depth: int, bits_per_token: int) -> Resources:
    """FIFO cost: small FIFOs land in shift registers (SRL), deeper ones in
    BRAM, rounded up to the next power-of-two ram depth (paper §7.3 notes the
    'next largest ram size' jump)."""
    if depth <= 0:
        return Resources()
    if depth <= 32:
        return Resources(luts=bits_per_token, regs=16)
    ram_depth = 1 << math.ceil(math.log2(depth))
    return Resources(luts=32, regs=32, bram_bits=ram_depth * bits_per_token)


# --------------------------------------------------------------------------
# schedule + interface types (paper fig. 3)


@dataclass(frozen=True)
class ScheduleType:
    """T[v; w,h} — an array of w*h*inner scalars processed v scalars per
    transaction. ``px_scalars`` is the number of scalars in one outer array
    element ("pixel" token payload, e.g. an 8x8 stencil patch = 64)."""

    scalar: DType
    w: int
    h: int
    px_scalars: int = 1
    v: int = 1  # vector width: scalar lanes per transaction

    @property
    def tokens_per_frame(self) -> int:
        # transactions needed for one frame
        return math.ceil(self.w * self.h * self.px_scalars / self.v)

    @property
    def token_bits(self) -> int:
        return self.scalar.bits() * self.v

    def __repr__(self):
        return (f"{self.scalar!r}[{self.v};{self.w},{self.h}"
                f"x{self.px_scalars}}}")


STATIC = "Static"
STREAM = "Stream"


@dataclass(frozen=True)
class Interface:
    kind: str  # STATIC | STREAM
    sched: ScheduleType

    def __repr__(self):
        return f"{self.kind}({self.sched!r})"


# --------------------------------------------------------------------------
# module instances


@dataclass
class RModule:
    """One mapped hardware generator instance (one Verilog module analog)."""

    name: str
    kind: str                    # generator family: Map/Reduce/Stencil/...
    iface_in: Optional[Interface]
    iface_out: Interface
    rate: Fraction               # R: output tokens per cycle (0 < R <= 1)
    latency: int                 # L: cycles from consume to produce
    burst: int = 0               # B: max excess tokens vs model trace (§4.3)
    resources: Resources = field(default_factory=Resources)
    src_uid: Optional[int] = None   # HWImg node this came from (None = inserted)
    info: Dict[str, Any] = field(default_factory=dict)

    def __repr__(self):
        return (f"<{self.name} {self.kind} R={self.rate} L={self.latency} "
                f"B={self.burst} {self.iface_out!r} {self.resources!r}>")


# --------------------------------------------------------------------------
# vector-width legality (paper §2.4): lanes must divide the array extents.


def valid_lane_counts(px_scalars: int, w: int, h: int) -> List[int]:
    """Legal vector widths at a site whose pixel payload has ``px_scalars``
    scalars in a (w, h) image: divisors of the payload, then whole-pixel
    multiples that divide the row, then whole rows that divide the column."""
    out = set()
    for d in range(1, px_scalars + 1):
        if px_scalars % d == 0:
            out.add(d)
    for d in range(1, w + 1):
        if w % d == 0:
            out.add(px_scalars * d)
    for d in range(1, h + 1):
        if h % d == 0:
            out.add(px_scalars * w * d)
    return sorted(out)


def optimize_lanes(px_scalars: int, w: int, h: int,
                   required_scalars_per_cycle: Fraction) -> Tuple[int, Fraction]:
    """``type:optimize`` (paper fig. 7): the legal vector width with the
    lowest cost that meets-or-exceeds the required throughput — i.e. the
    smallest legal V with rate = required/V <= 1 (fig. 6's red point).

    Whole-pixel lane counts that do *not* divide the (possibly padded) row
    width are legal too: the frame's final partial transaction is padded
    (``ScheduleType.tokens_per_frame`` rounds up), so the cheapest V at
    sub-row parallelism is the next whole-pixel multiple of the
    requirement, not the next row divisor. Earlier versions silently
    skipped these and over-provisioned lanes (e.g. V=8 instead of V=5 on
    a 1936-wide padded row)."""
    req = Fraction(required_scalars_per_cycle)
    cands = valid_lane_counts(px_scalars, w, h)
    best = None
    for v in cands:
        if Fraction(v) >= req:
            best = v
            break
    if px_scalars < req <= px_scalars * w:
        v_pad = px_scalars * math.ceil(req / px_scalars)
        if best is None or v_pad < best:
            best = v_pad
    if best is not None:
        return best, Fraction(req, best)
    # requirement exceeds the largest single instance: replicate instances
    vmax = cands[-1]
    return vmax, Fraction(1)  # caller replicates ceil(required/vmax) instances
