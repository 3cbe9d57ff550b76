"""FIFO area accounting: analytic vs simulated vs hand-annotated.

Reproduces the paper's Table-style auto-vs-hand comparison (§7.2-§7.3:
solved interfaces + sized FIFOs cost +11% with manual FIFO annotations and
+33% fully automatic, vs hand-optimized designs). Here the three columns
are:

  - ``analytic``  — the solver's allocation (slack + burst), fully automatic;
  - ``simulated`` — the simulation-guided allocation (hwsim.allocate), still
    fully automatic but tightened to observed high-water marks;
  - ``hand``      — the allocation with the app's hand annotations
    (``manual_fifo_overrides``: e.g. zero burst slack on DMA-absorbed
    border modules, keep the user-sized Filter FIFO).

Areas are reported in CLBs and BRAM18s via ``rigel.fifo_resources``, plus a
single scalar (``area_units``) that weighs one BRAM18 as ``BRAM_CLB_EQUIV``
CLBs so allocations that trade BRAMs for shift registers stay comparable.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from ..core.buffers import Edge
from ..core.rigel import Resources, fifo_resources

EdgeKey = Tuple[int, int]

# one BRAM18 tile is worth roughly this many CLBs of die area; the exact
# exchange rate only needs to be stable, not Vivado-exact, for the
# auto-vs-hand ratio structure to be meaningful
BRAM_CLB_EQUIV = 8


def area_units(r: Resources) -> int:
    return r.clbs + BRAM_CLB_EQUIV * r.brams


def fifo_area(depths: Mapping[EdgeKey, int],
              edges: Sequence[Edge],
              token_bits: Optional[Mapping[EdgeKey, int]] = None
              ) -> Resources:
    """Total FIFO resources for a per-edge depth allocation.  ``token_bits``
    overrides the edges' declared widths (e.g. proven-width narrowing from
    the value-range analysis, analysis/ranges.py, not ported yet)."""
    bits = {(e.src, e.dst): e.token_bits for e in edges}
    if token_bits is not None:
        bits.update(token_bits)
    total = Resources()
    for key, d in depths.items():
        total = total + fifo_resources(d, bits[key])
    return total


@dataclass
class AreaRow:
    """One app's three-column FIFO area comparison. ``modules`` is the
    netlist's own (allocation-independent) area; ratios are over the full
    design (modules + FIFOs), like the paper's table — a hand allocation
    with near-zero FIFO area would otherwise make ratios degenerate."""

    name: str
    modules: Resources
    analytic: Resources
    simulated: Resources
    hand: Resources
    analytic_bits: int
    simulated_bits: int
    hand_bits: int
    cycles: int
    throughput: float
    deadlocks: int
    edges_shrunk: int
    throughput_unchanged: bool
    # proven-width narrowing (the value-range analysis): the
    # simulated allocation re-priced with every FIFO at its proven carrier
    # width instead of the declared one (None = analysis not run)
    narrowed: Optional[Resources] = None
    narrowed_bits: Optional[int] = None

    def ratios(self) -> Dict[str, float]:
        mod = area_units(self.modules)
        ha = max(1, mod + area_units(self.hand))
        return {
            "auto_vs_hand": round((mod + area_units(self.analytic)) / ha, 3),
            "sim_vs_hand": round((mod + area_units(self.simulated)) / ha, 3),
            "sim_vs_analytic": round(
                (mod + area_units(self.simulated))
                / max(1, mod + area_units(self.analytic)), 3),
        }

    def as_dict(self) -> Dict[str, object]:
        r = self.ratios()
        narrowed = {}
        if self.narrowed_bits is not None and self.narrowed is not None:
            narrowed = {
                "fifo_bits_narrowed": self.narrowed_bits,
                "fifo_clbs_narrowed": self.narrowed.clbs,
                "fifo_brams_narrowed": self.narrowed.brams,
            }
        return {
            **narrowed,
            "cycles": self.cycles,
            "tokens_per_cycle": round(self.throughput, 4),
            "deadlocks": self.deadlocks,
            "edges_shrunk": self.edges_shrunk,
            "throughput_unchanged": self.throughput_unchanged,
            "fifo_bits_analytic": self.analytic_bits,
            "fifo_bits_simulated": self.simulated_bits,
            "fifo_bits_hand": self.hand_bits,
            "fifo_clbs_analytic": self.analytic.clbs,
            "fifo_clbs_simulated": self.simulated.clbs,
            "fifo_clbs_hand": self.hand.clbs,
            "fifo_brams_analytic": self.analytic.brams,
            "fifo_brams_simulated": self.simulated.brams,
            "fifo_brams_hand": self.hand.brams,
            "area_units_modules": area_units(self.modules),
            "area_units_analytic": area_units(self.analytic),
            "area_units_simulated": area_units(self.simulated),
            "area_units_hand": area_units(self.hand),
            "area_auto_vs_hand": r["auto_vs_hand"],
            "area_sim_vs_hand": r["sim_vs_hand"],
            "area_sim_vs_analytic": r["sim_vs_analytic"],
        }


def compare(name: str, design, alloc, hand_design,
            narrowed_token_bits: Optional[Mapping[EdgeKey, int]] = None
            ) -> AreaRow:
    """Build the three-column row for one app from its auto design, its
    simulation-guided allocation and its hand-annotated compile.  When
    ``narrowed_token_bits`` (proven-width narrowing) is
    given, a fourth column re-prices the simulated allocation with every
    FIFO at its proven carrier width."""
    bits = {(e.src, e.dst): e.token_bits for e in design.edges}
    hand_bits = {(e.src, e.dst): e.token_bits for e in hand_design.edges}
    mod_area = Resources()
    for m in design.modules:
        mod_area = mod_area + m.resources
    narrowed = narrowed_bits = None
    if narrowed_token_bits is not None:
        nbits = dict(bits)
        nbits.update(narrowed_token_bits)
        narrowed = fifo_area(alloc.depths, design.edges, narrowed_token_bits)
        narrowed_bits = sum(d * nbits[k] for k, d in alloc.depths.items())
    return AreaRow(
        name=name,
        modules=mod_area,
        analytic=fifo_area(alloc.analytic, design.edges),
        simulated=fifo_area(alloc.depths, design.edges),
        hand=fifo_area(hand_design.fifo.depth, hand_design.edges),
        analytic_bits=sum(d * bits[k] for k, d in alloc.analytic.items()),
        simulated_bits=alloc.total_bits(bits),
        hand_bits=sum(d * hand_bits[k]
                      for k, d in hand_design.fifo.depth.items()),
        cycles=alloc.verified.cycles,
        throughput=float(alloc.verified.throughput),
        deadlocks=0 if (alloc.baseline.completed
                        and alloc.verified.completed) else 1,
        edges_shrunk=alloc.shrunk_edges,
        throughput_unchanged=alloc.proven,
        narrowed=narrowed,
        narrowed_bits=narrowed_bits,
    )


def table_lines(rows: Sequence[AreaRow]) -> List[str]:
    with_narrowed = any(r.narrowed is not None for r in rows)
    head = (f"{'app':14s} {'analytic':>16s} {'simulated':>16s} "
            f"{'hand':>16s} {'auto/hand':>9s} {'sim/hand':>8s}")
    if with_narrowed:
        head += f" {'narrowed':>16s}"
    lines = [head]
    for r in rows:
        def cell(res: Resources) -> str:
            return f"{res.clbs}clb+{res.brams}bram"

        rr = r.ratios()
        line = (f"{r.name:14s} {cell(r.analytic):>16s} "
                f"{cell(r.simulated):>16s} {cell(r.hand):>16s} "
                f"{rr['auto_vs_hand']:>9.3f} {rr['sim_vs_hand']:>8.3f}")
        if with_narrowed:
            line += (f" {cell(r.narrowed):>16s}" if r.narrowed is not None
                     else f" {'-':>16s}")
        lines.append(line)
    return lines
