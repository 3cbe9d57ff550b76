"""Pass 3 of the static verifier: netlist handshake / deadlock linting.

Works on the mapped RModule netlist (core/mapper.py) + its solved FIFO
allocation, entirely from the analytic schedule model (core/schedule.py)
and the simulator's consumption specs (hwsim/sim.py's ``need_spec``) — no
simulation needed.  Three layers:

  1. **token-rate balance** (``edge_flow``): on every edge, the consumer's
     worst within-frame token need (recomputed *unclamped* from the
     simulator's own ``need_spec`` profile) must not exceed the producer's
     tokens per frame — under-production is starvation by construction, a
     hard lint error the interface solver is supposed to make impossible.
     The per-frame pixel payloads of both interfaces are recorded for the
     report but are not compared directly: frame-granular DMA sources,
     serializers and data-dependent ``Filter`` consumers legitimately
     declare different pixel bookkeeping on the two sides of one edge.
  2. **static depth lower bound** (``static_lower_bounds``): any edge whose
     consumer needs at least one token per frame must see occupancy >= 1
     (a token is pushed before it can be popped, and the push records the
     high-water mark).  This is the sound floor of the three-way
     differential ``static_lower <= simulated hwm <= max(analytic,
     installed) depth + 1`` that the CI gate asserts on every app under
     both fifo solvers.
  3. **deadlock certification** (``certify``): replay the §4.2 trace model
     per edge — the producer's cumulative pixels (plus burst) against the
     consumer's consumption trace — and check (a) the consumer never gets
     ahead of the producer (starvation-freedom, the ``check_schedule``
     condition) and (b) the model's transient backlog never exceeds the
     installed FIFO capacity, bounding reconvergent-fanout latency skew.
     The numeric trace replay is exact only on *rate-matched
     pixel-streaming* edges (equal per-frame pixel payloads and equal
     scalar service rates on both sides).  The remaining edges are no
     longer left unmodeled: ``analysis/traces.py`` classifies every edge
     (stream / dma-frame / serializer / data-dependent — the verdict
     ladder certified > sim-proven > at-risk applies per design) and
     certifies a sound occupancy bracket ``static_lower <= hwm <=
     static_upper`` where the ceiling is ``min(installed capacity,
     producer tokens per frame)`` — on those classes backpressure
     throttles the producer benignly, so capacity (not an exact trace) is
     the operative bound, and the cross-check asserts the bracket against
     the simulated marks.  Clean modeled edges => the installed depths
     admit the solved schedule on the paper's monotone-dataflow design
     space.  Simulation-shrunk depths intentionally sit *below* the
     model's backlog (that is the point of measuring); they fall back to
     the ``sim-proven`` verdict when the shrink re-verified
     (``fifo_sim_proven``).

Note ``certify`` is a per-edge lint, not a whole-graph deadlock proof:
cross-edge join stalls (a fanout blocked on one arm while the other
starves) are what ``traces.broadcast_extra_slots`` (cross-arm demand
gaps, fed into the analytic solver) and the differential ``cross_check``
close together.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from fractions import Fraction
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from ..core import schedule as sched
from ..hwsim.sim import need_spec
from .traces import EDGE_CLASSES, classify_edge

EdgeKey = Tuple[int, int]

# model slop for the capacity bound, in consumer-visible tokens: one slot
# for the producer's output register (capacity = depth + 1) is accounted
# explicitly; two more tokens absorb the trace model's ceil/start rounding
CAPACITY_SLOP_TOKENS = 2


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclass
class EdgeCheck:
    """One edge's static handshake record."""

    key: EdgeKey
    names: Tuple[str, str]
    tpf: int                       # producer tokens per frame on this edge
    need_total: int                # tokens the consumer needs per frame
    raw_need: int                  # unclamped worst within-frame need
    prod_px: int                   # producer px payload per frame
    cons_px: int                   # consumer input-interface px per frame
    installed_depth: int
    static_lower: int              # sound hwm floor (tokens)
    static_upper: int = 0          # sound hwm ceiling (tokens)
    klass: str = "stream"          # traces.EDGE_CLASSES certificate class
    model_backlog: int = 0         # trace-model peak backlog (tokens)
    residue: int = 0               # tokens produced but never consumed
    starved: bool = False          # consumption trace outruns production
    shortfall: int = 0             # backlog tokens beyond capacity + slop
    modeled: bool = True           # numeric trace replay exact on this edge

    @property
    def certified(self) -> bool:
        """The edge carries a sound static occupancy bracket."""
        return (self.klass in EDGE_CLASSES
                and self.static_upper >= self.static_lower)

    @property
    def rate_balanced(self) -> bool:
        return self.raw_need <= self.tpf

    def line(self) -> str:
        s = (f"  {self.key[0]:3d}->{self.key[1]:<3d} "
             f"{self.names[0]}->{self.names[1]}: tpf={self.tpf} "
             f"need={self.need_total} depth={self.installed_depth} "
             f"hwm in [{self.static_lower}, {self.static_upper}]")
        s += f" backlog~{self.model_backlog}" if self.modeled \
            else f" [{self.klass}]"
        if self.residue:
            s += f" residue={self.residue}"
        if self.starved:
            s += " STARVED"
        if self.shortfall:
            s += f" SHORTFALL(+{self.shortfall})"
        if not self.rate_balanced:
            s += (f" IMBALANCE(raw_need={self.raw_need} > tpf={self.tpf})")
        return s


@dataclass
class HandshakeReport:
    edges: List[EdgeCheck] = field(default_factory=list)
    errors: List[str] = field(default_factory=list)
    verdict: str = "certified"     # certified | sim-proven | at-risk
    notes: List[str] = field(default_factory=list)

    @property
    def lower_bounds(self) -> Dict[EdgeKey, int]:
        """Per FIFO key (parallel edges share one FIFO solution entry:
        merge by max — each edge's bound holds for the shared key)."""
        out: Dict[EdgeKey, int] = {}
        for e in self.edges:
            out[e.key] = max(out.get(e.key, 0), e.static_lower)
        return out

    @property
    def upper_bounds(self) -> Dict[EdgeKey, int]:
        """Certified per-FIFO hwm ceilings (parallel edges merged by max:
        the shared physical FIFO's mark is bounded by the loosest arm)."""
        out: Dict[EdgeKey, int] = {}
        for e in self.edges:
            out[e.key] = max(out.get(e.key, 0), e.static_upper)
        return out

    @property
    def certified_edge_fraction(self) -> float:
        """Fraction of edges carrying a sound static occupancy bracket —
        the bench-gated coverage metric (1.0 = no edge left unmodeled)."""
        if not self.edges:
            return 1.0
        return sum(1 for e in self.edges if e.certified) / len(self.edges)

    def report_lines(self, verbose: bool = False) -> List[str]:
        flagged = [e for e in self.edges
                   if e.starved or e.shortfall or not e.rate_balanced]
        lines = [f"handshake: {len(self.edges)} edges, "
                 f"{len(self.errors)} errors, verdict={self.verdict}, "
                 f"certified={self.certified_edge_fraction:.0%}"]
        for e in (self.edges if verbose else flagged):
            lines.append(e.line())
        lines.extend(f"  {err}" for err in self.errors)
        lines.extend(f"  {n}" for n in self.notes)
        return lines


def edge_flow(design) -> List[EdgeCheck]:
    """Token-rate balance + consumption-need accounting per edge."""
    checks: List[EdgeCheck] = []
    depths = design.fifo.depth if design.fifo is not None else {}
    for e in design.edges:
        prod, cons = design.modules[e.src], design.modules[e.dst]
        ps = prod.iface_out.sched
        ci = (cons.iface_in or cons.iface_out).sched
        tpf_e = ps.tokens_per_frame
        spec = need_spec(cons, prod, tpf_e)
        need_total = spec.need_frame(spec.out_total)
        if spec.profile is None:
            raw = need_total
        else:
            # the engine clamps needs at tpf; recompute the worst
            # within-frame need unclamped so over-demand is visible
            p = min(len(spec.profile),
                    _ceil_div(spec.out_total * spec.v_out, spec.pxs_out))
            npx = int(spec.profile[p - 1]) if p > 0 else 0
            raw = _ceil_div(npx * spec.pxs_in, spec.v_in)
        installed = int(depths.get((e.src, e.dst), 0))
        checks.append(EdgeCheck(
            key=(e.src, e.dst), names=(prod.name, cons.name),
            tpf=tpf_e, need_total=need_total, raw_need=raw,
            prod_px=ps.w * ps.h * ps.px_scalars,
            cons_px=ci.w * ci.h * ci.px_scalars,
            installed_depth=installed,
            static_lower=1 if need_total >= 1 else 0,
            static_upper=min(installed + 1, tpf_e),
            klass=classify_edge(prod, cons),
            residue=max(0, tpf_e - need_total)))
    return checks


def static_lower_bounds(design) -> Dict[EdgeKey, int]:
    """Sound per-FIFO occupancy floors (see HandshakeReport.lower_bounds)."""
    report = HandshakeReport(edges=edge_flow(design))
    return report.lower_bounds


def certify(design, depths: Optional[Mapping[EdgeKey, int]] = None,
            horizon: Optional[int] = None) -> HandshakeReport:
    """Trace-model deadlock certification for the installed (or overridden)
    FIFO depths; see the module docstring for the two per-edge conditions."""
    report = HandshakeReport(edges=edge_flow(design))
    if design.fifo is None:
        report.errors.append("design has no FIFO solution to certify")
        report.verdict = "at-risk"
        return report
    h = horizon or min(design.cycles_per_frame() + 16, 200_000)
    t = np.arange(h, dtype=np.int64)
    starts = design.fifo.start
    for chk, e in zip(report.edges, design.edges):
        if depths is not None and chk.key in depths:
            chk.installed_depth = int(depths[chk.key])
            chk.static_upper = min(chk.installed_depth + 1, chk.tpf)
        p, c = design.modules[e.src], design.modules[e.dst]
        vp = p.iface_out.sched.v
        ci = (c.iface_in or c.iface_out).sched
        co = c.iface_out.sched
        cons_rate = min(c.rate * Fraction(ci.tokens_per_frame,
                                          co.tokens_per_frame), Fraction(1))
        # the trace model is exact only on rate-matched px-streaming edges;
        # everywhere else backpressure throttles the producer benignly and
        # the simulation cross-check owns the question
        chk.modeled = (chk.prod_px == chk.cons_px
                       and p.rate * vp == cons_rate * ci.v)
        if not chk.modeled:
            continue
        prod_px = np.minimum(
            (sched.trace(p.rate, p.latency, starts[e.src], t)
             + e.src_burst) * vp,
            (chk.tpf + e.src_burst) * vp)
        cons_px = np.minimum(
            sched.consumption_trace(cons_rate, starts[e.dst], t) * ci.v,
            ci.tokens_per_frame * ci.v)
        # (a) starvation-freedom: the check_schedule condition, per edge
        if np.any(cons_px > prod_px + vp):
            chk.starved = True
        # (b) capacity: the model's peak backlog fits depth + 1 (+ slop)
        backlog_px = int(np.max(prod_px - np.maximum(cons_px, 0)))
        chk.model_backlog = max(0, _ceil_div(backlog_px, vp) - e.src_burst)
        cap = chk.installed_depth + 1 + CAPACITY_SLOP_TOKENS
        if chk.model_backlog > cap:
            chk.shortfall = chk.model_backlog - cap
    n_modeled = sum(1 for c in report.edges if c.modeled)
    by_class: Dict[str, int] = {}
    for c in report.edges:
        by_class[c.klass] = by_class.get(c.klass, 0) + 1
    breakdown = ", ".join(f"{k}={by_class[k]}" for k in EDGE_CLASSES
                          if k in by_class)
    report.notes.append(
        f"{n_modeled}/{len(report.edges)} edges rate-matched (exact trace "
        f"replay); all carry certified occupancy brackets ({breakdown})")
    for chk in report.edges:
        if not chk.rate_balanced:
            report.errors.append(
                f"token-rate imbalance on {chk.key} "
                f"{chk.names[0]}->{chk.names[1]}: worst within-frame need "
                f"{chk.raw_need} exceeds producer tokens/frame {chk.tpf}")
        if chk.starved:
            report.errors.append(
                f"starvation on {chk.key} {chk.names[0]}->{chk.names[1]}: "
                f"consumption trace outruns production")
    shortfalls = [c for c in report.edges if c.shortfall]
    if report.errors:
        report.verdict = "at-risk"
    elif shortfalls:
        if design.fifo_sim_proven:
            report.verdict = "sim-proven"
            report.notes.append(
                f"{len(shortfalls)} FIFO(s) below the trace-model backlog "
                "(simulation-shrunk depths; re-simulation proved them)")
        else:
            report.verdict = "at-risk"
            for c in shortfalls:
                report.errors.append(
                    f"under-depth FIFO on {c.key} "
                    f"{c.names[0]}->{c.names[1]}: model backlog "
                    f"~{c.model_backlog} tokens exceeds capacity "
                    f"{c.installed_depth + 1} (+{CAPACITY_SLOP_TOKENS} slop)")
    return report


@dataclass
class CrossCheckResult:
    """The three-way differential oracle's outcome on one design."""

    hwm: Dict[EdgeKey, int]
    lower: Dict[EdgeKey, int]
    upper: Dict[EdgeKey, int]     # min(installed depth + 1, tokens/frame)
    violations: List[str] = field(default_factory=list)
    completed: bool = True
    engine: str = ""

    @property
    def ok(self) -> bool:
        return self.completed and not self.violations

    def report_lines(self) -> List[str]:
        lines = [f"cross-check: {len(self.hwm)} FIFOs, "
                 f"{'ok' if self.ok else 'VIOLATED'} (engine={self.engine})"]
        lines.extend(f"  {v}" for v in self.violations)
        return lines


def cross_check(design, engine: str = "auto",
                max_cycles: Optional[int] = None,
                device=None) -> CrossCheckResult:
    """Assert ``static_lower <= simulated hwm <= static_upper`` per FIFO,
    from one single-frame run at the *installed* depths — the design as
    shipped.  Completion proves deadlock-freedom; the lower arm proves the
    linter's floors are realized by actual token flow (a floor the
    simulator never reaches means the linter over-claims or the simulator
    drops tokens); the upper arm is the certified ceiling ``min(installed
    depth + 1, producer tokens per frame)`` — derived uniformly from the
    installed depths, so it covers shrunk installs (``fifo_solver="sim"``)
    and grown ones (cross-arm broadcast slots) alike, and asserts that the
    simulator's capacity accounting (occupancy <= depth + 1: slot plus
    output register) is never breached.  Any violation is a bug in one of
    the three engines (linter, simulator, or buffer solver).

    Runs a single frame: the floors are per-frame guarantees, and the
    tokens-per-frame arm of the ceiling is a single-frame production
    total; multi-frame steady state can carry inter-frame residue.

    ``engine`` and ``device`` go to ``hwsim.simulate``: "auto" is the
    cycle kernel on ``device`` "cuda" (None; it raises without a card)
    and the scalar engine on "cpu"."""
    from ..hwsim import simulate
    res = simulate(design, max_cycles=max_cycles, frames=1, engine=engine,
                   device=device)
    hwm = res.hwm_by_key()
    report = HandshakeReport(edges=edge_flow(design))
    lower = report.lower_bounds
    upper = report.upper_bounds
    out = CrossCheckResult(hwm=hwm, lower=lower, upper=upper,
                           completed=res.completed, engine=res.engine)
    if not res.completed:
        out.violations.append("simulation did not complete at the "
                              f"installed depths: {res.deadlock}")
        return out
    for key in sorted(lower):
        h = hwm.get(key, 0)
        if h < lower[key]:
            out.violations.append(
                f"fifo {key}: simulated hwm {h} < static lower "
                f"bound {lower[key]} (linter or simulator bug)")
        if key in upper and h > upper[key]:
            out.violations.append(
                f"fifo {key}: simulated hwm {h} > capacity bound "
                f"{upper[key]} (solver or simulator bug)")
    return out
