"""Pareto mechanics for the design-space explorer.

A design point is one (netlist, FIFO allocation) evaluated by the cycle
simulator: its area (modules + FIFOs, in ``hwsim.area`` units) and its
measured steady-state throughput (output pixels per cycle).  The front
minimizes area and maximizes throughput; the hand-annotated design is
overlaid against the front rather than inserted into it, so the report
answers the paper's §7 question — how close does automatic search come to
the hand design — instead of hiding the hand point under dominance.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

DepthItems = Tuple[Tuple[Tuple[int, int], int], ...]


def freeze_depths(depths) -> DepthItems:
    """Canonical hashable form of a per-edge depth mapping."""
    return tuple(sorted((tuple(k), int(v)) for k, v in depths.items()))


@dataclass(frozen=True)
class DesignPoint:
    """One evaluated hardware design point.

    ``area_units`` is the full design (modules + FIFOs) in CLB-equivalents
    (one BRAM18 = ``hwsim.area.BRAM_CLB_EQUIV`` CLBs); ``throughput`` is
    measured output pixels per cycle at steady state (frame-to-frame sink
    interval when the evaluation ran >= 2 frames).  ``origin`` is "auto"
    for swept points and "hand" for the HAND_FIFO overlay.  Deadlocked
    candidates keep ``completed=False`` and never enter a front."""

    app: str
    label: str
    origin: str                    # "auto" | "hand"
    T: str                         # effective throughput target (Fraction)
    solver: str                    # schedule variant: z3 | lp | asap
    fifo_policy: str               # analytic | sim | scale:<f> | jitter:<i>
    area_units: int
    area_clbs: int
    area_brams: int
    fifo_bits: int
    throughput: float
    cycles: int
    cycles_per_frame: int
    completed: bool
    cycles_skipped: int = 0
    depths: DepthItems = field(default=(), compare=False)

    def dominates(self, other: "DesignPoint") -> bool:
        """Weak dominance with at least one strict improvement: no worse
        in both objectives (min area, max throughput), better in one."""
        if not (self.completed and other.completed):
            return False
        no_worse = (self.area_units <= other.area_units
                    and self.throughput >= other.throughput)
        strictly = (self.area_units < other.area_units
                    or self.throughput > other.throughput)
        return no_worse and strictly

    def as_dict(self) -> Dict[str, object]:
        return {
            "label": self.label, "origin": self.origin, "T": self.T,
            "solver": self.solver, "fifo_policy": self.fifo_policy,
            "area_units": self.area_units, "area_clbs": self.area_clbs,
            "area_brams": self.area_brams, "fifo_bits": self.fifo_bits,
            "throughput_px_per_cycle": round(self.throughput, 6),
            "cycles": self.cycles,
            "cycles_per_frame": self.cycles_per_frame,
            "completed": self.completed,
            "cycles_skipped": self.cycles_skipped,
        }


@dataclass
class ParetoFront:
    """The non-dominated subset of a point set, sorted by ascending area
    (hence descending throughput)."""

    points: List[DesignPoint] = field(default_factory=list)

    @classmethod
    def of(cls, points: Iterable[DesignPoint]) -> "ParetoFront":
        """Skyline sweep: sort by (area asc, throughput desc), keep each
        point that strictly raises the best throughput seen so far.  Ties
        on both objectives keep the first point (deterministic given a
        deterministic candidate order)."""
        best: Dict[Tuple[int, float], DesignPoint] = {}
        for p in points:
            if not p.completed:
                continue
            key = (p.area_units, -p.throughput)
            if key not in best:
                best[key] = p
        front: List[DesignPoint] = []
        hi = float("-inf")
        for key in sorted(best):
            p = best[key]
            if p.throughput > hi:
                front.append(p)
                hi = p.throughput
        return cls(front)

    def merge(self, points: Iterable[DesignPoint]) -> "ParetoFront":
        return ParetoFront.of([*self.points, *points])

    def dominated(self, p: DesignPoint) -> bool:
        return any(q.dominates(p) for q in self.points)

    def best_at(self, min_throughput: float) -> Optional[DesignPoint]:
        """Cheapest front point meeting a throughput floor (the front is
        area-sorted, so the first match is the cheapest)."""
        for p in self.points:
            if p.throughput >= min_throughput:
                return p
        return None

    def report_lines(self, hand: Optional[DesignPoint] = None) -> List[str]:
        lines = [f"{'':2s}{'area':>7s} {'clb':>6s} {'bram':>5s} "
                 f"{'px/cyc':>9s} {'T':>6s} {'solver':>6s} {'policy':>12s}"]
        rows: Sequence[Tuple[str, DesignPoint]] = \
            [("", p) for p in self.points]
        if hand is not None:
            rows = [*rows, ("*", hand)]
        for mark, p in rows:
            lines.append(
                f"{mark:2s}{p.area_units:>7d} {p.area_clbs:>6d} "
                f"{p.area_brams:>5d} {p.throughput:>9.5f} {p.T:>6s} "
                f"{p.solver:>6s} {p.fifo_policy:>12s}")
        if hand is not None:
            status = ("dominated by the front" if self.dominated(hand)
                      else "on or beyond the front")
            lines.append(f"* hand-annotated design ({status})")
        return lines
