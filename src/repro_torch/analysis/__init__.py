"""The static verifier of the port (three passes, as the reference's).

  1. ranges.py    — value-range analysis over the HWImg DAG: wrap-freedom
                    proofs / wrap witnesses per node, and proven-width
                    narrowing for FIFO pricing;
  2. verify_ir.py — the lowering IR's structural invariants (``check_ir``:
                    what ``apply_rules`` checks after every rewrite);
  3. handshake.py — netlist token-rate balance, static FIFO occupancy
                    floors, trace-model deadlock certification, and the
                    three-way differential oracle
                    ``static_lower <= simulated hwm <= static_upper``,
                    backed by traces.py — the symbolic phase-trace algebra
                    that classifies every edge, certifies sound occupancy
                    brackets, and computes the cross-arm broadcast demand
                    gaps (``broadcast_extra_slots``) the analytic FIFO
                    solve provisions for.

``verify_design`` bundles all three for one compiled HWDesign (surfaced as
``HWDesign.verify()``); ``python -m repro_torch.analysis --all-apps
--check`` runs them over every registered app at both fifo solvers.  The
rewrite-rule sets are the port's backends: "torch" (the reference's
"jax") and "kernels" (its "pallas").  The oracle's simulation runs on
``device``: the cycle kernel on "cuda" (the default, which raises without
a card), the scalar engine on "cpu".

Importing this package loads neither the lowering nor torch:
``compile_pipeline`` reaches ``traces`` through it, and the IR pass's
names (which need the lowering) load on first use.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from .handshake import (CrossCheckResult, EdgeCheck,  # noqa: F401
                        HandshakeReport, certify, cross_check, edge_flow,
                        static_lower_bounds)
from .ranges import (Iv, NodeRange, RangeReport, analyze,  # noqa: F401
                     module_proven_bits, narrowed_token_bits)
from .traces import (EDGE_CLASSES, EdgeCertificate, PhaseTrace,  # noqa: F401
                     broadcast_extra_slots, broadcast_gaps, certify_edges,
                     classify_edge, deadlock_reason, edge_need_totals,
                     peak_backlog, required_capacities)

_VERIFY_IR = ("InvariantViolation", "assert_ir", "check_ir",
              "check_rewrites", "verify_enabled")

__all__ = [
    "analyze", "RangeReport", "NodeRange", "Iv", "narrowed_token_bits",
    "module_proven_bits",
    "check_ir", "assert_ir", "check_rewrites", "InvariantViolation",
    "verify_enabled",
    "edge_flow", "static_lower_bounds", "certify", "cross_check",
    "HandshakeReport", "EdgeCheck", "CrossCheckResult",
    "PhaseTrace", "EdgeCertificate", "EDGE_CLASSES", "classify_edge",
    "certify_edges", "edge_need_totals", "peak_backlog", "broadcast_gaps",
    "broadcast_extra_slots", "required_capacities", "deadlock_reason",
    "VerifyResult", "verify_design",
]


def __getattr__(name):
    # the IR pass imports the lowering (and so torch): load it on first use
    if name in _VERIFY_IR:
        from . import verify_ir
        return getattr(verify_ir, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


@dataclass
class VerifyResult:
    """One design's combined static-verification outcome."""

    name: str
    ranges: RangeReport
    ir_violations: List[str]
    handshake: HandshakeReport
    cross: Optional[CrossCheckResult] = None
    narrowed_fifo_bits: Optional[int] = None
    declared_fifo_bits: Optional[int] = None
    notes: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        """The CLI gate: every integer node proven or witnessed, zero IR
        invariant violations, no handshake errors (certified or
        sim-proven), and the three-way bound holding when simulated."""
        return (self.ranges.decided
                and not self.ir_violations
                and not self.handshake.errors
                and self.handshake.verdict in ("certified", "sim-proven")
                and (self.cross is None or self.cross.ok))

    def report_lines(self, verbose: bool = False) -> List[str]:
        lines = [f"verify {self.name}: {'ok' if self.ok else 'FAILED'}"]
        lines.extend(f" {ln}" for ln in self.ranges.report_lines(verbose))
        if self.ir_violations:
            lines.append(f" ir: {len(self.ir_violations)} violation(s)")
            lines.extend(f"  {v}" for v in self.ir_violations)
        else:
            lines.append(" ir: rewrite fixpoint structurally clean")
        lines.extend(f" {ln}"
                     for ln in self.handshake.report_lines(verbose))
        if self.cross is not None:
            lines.extend(f" {ln}" for ln in self.cross.report_lines())
        if (self.narrowed_fifo_bits is not None
                and self.declared_fifo_bits is not None):
            lines.append(
                f" proven-width FIFO bits: {self.declared_fifo_bits} "
                f"declared -> {self.narrowed_fifo_bits} narrowed")
        lines.extend(f" {ln}" for ln in self.notes)
        return lines


def verify_design(design, sim: bool = True, engine: str = "auto",
                  backend: str = "torch", device=None) -> VerifyResult:
    """Run all three static passes over a compiled HWDesign.

    ``sim=True`` adds the three-way differential oracle (one single-frame
    simulation on ``engine`` and ``device``); ``backend`` ("torch" or
    "kernels") selects the rewrite-rule set the IR pass exercises."""
    from .verify_ir import check_rewrites
    ranges = analyze(design.out_val)
    ir_violations = check_rewrites(design.out_val, backend=backend)
    handshake = certify(design)
    cross = (cross_check(design, engine=engine, device=device)
             if sim else None)
    result = VerifyResult(design.name, ranges, ir_violations, handshake,
                          cross)
    if design.fifo is not None:
        narrowed = narrowed_token_bits(design, ranges)
        result.declared_fifo_bits = design.fifo.total_bits
        result.narrowed_fifo_bits = sum(
            d * narrowed[k] for k, d in design.fifo.depth.items())
    return result
