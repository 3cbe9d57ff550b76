"""Simulation-guided FIFO allocation (the paper's auto-vs-hand area story).

The analytic solve (core/buffers.py) sizes each FIFO as slack + burst, with
slack measured in *cycles* — a conservative bound that treats every slack
cycle as a resident token. At pipeline rates below 1 token/cycle the FIFO
never actually holds that many, and the paper's §7.3 gap between automatic
(+33%) and hand-tuned (+11%) area is mostly this conservatism. This module
closes the gap mechanically: simulate a frame against the analytic depths,
shrink every FIFO to its observed high-water mark (plus an optional guard
margin), then re-simulate to *prove* throughput is unchanged and no deadlock
appeared.

Soundness: capacity never drops below the observed high-water mark, and in
a deterministic dataflow simulation a FIFO that never held more than H
tokens behaves identically with capacity H — the verification run is the
machine-checked version of that argument. Modules whose burstiness is
data-dependent and not exercised by the deterministic run (Filter /
SparseTake / External) keep their annotated burst slots as a floor. Edges
where shrinking would *cost* area (a wide FIFO falling out of BRAM into a
larger pile of shift registers) keep the analytic depth, so the simulated
allocation's area is <= the analytic allocation's under the same metric.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..core.rigel import fifo_resources
from .area import area_units
from .sim import UNEXERCISED_BURSTY, SimResult, simulate

EdgeKey = Tuple[int, int]


@dataclass
class AllocationResult:
    depths: Dict[EdgeKey, int]          # simulation-guided allocation
    analytic: Dict[EdgeKey, int]        # the solver's allocation
    baseline: SimResult                 # simulated against analytic depths
    verified: SimResult                 # simulated against ``depths``
    guard: int
    notes: List[str] = field(default_factory=list)
    reverted: bool = False              # verification failed; depths=analytic
    frames: int = 1                     # frames per simulated run
    grown_edges: int = 0                # FIFOs grown past a deadlocked
                                        # analytic depth (upward search)

    @property
    def proven(self) -> bool:
        """Shrunk allocation re-simulated to the same throughput, no
        deadlock. A reverted allocation is never 'proven' — the fallback
        to analytic depths is safe to ship but must fail the CI gate."""
        return (not self.reverted
                and self.verified.completed and self.baseline.completed
                and self.verified.cycles == self.baseline.cycles)

    @property
    def shrunk_edges(self) -> int:
        return sum(1 for k, d in self.depths.items()
                   if d < self.analytic[k])

    def total_bits(self, token_bits: Dict[EdgeKey, int]) -> int:
        return sum(d * token_bits[k] for k, d in self.depths.items())

    def report_lines(self) -> List[str]:
        lines = [f"simulated allocation: {self.shrunk_edges}/"
                 f"{len(self.depths)} FIFOs shrunk"
                 + (f", {self.grown_edges} grown past a deadlocked "
                    "analytic depth" if self.grown_edges else "")
                 + f" (guard={self.guard}, "
                 f"frames={self.frames}, engine={self.baseline.engine}), "
                 f"throughput {'unchanged' if self.proven else 'CHANGED'}"]
        for k in sorted(self.depths):
            if self.depths[k] != self.analytic[k]:
                lines.append(f"  fifo {k[0]}->{k[1]}: "
                             f"{self.analytic[k]} -> {self.depths[k]}")
        lines.extend(self.notes)
        return lines


class AllocationError(RuntimeError):
    """The allocator has nothing to size: the design has no FIFO solution,
    or its simulation deadlocks even without capacity limits."""


def allocate_fifos(design, guard: int = 0,
                   max_cycles: Optional[int] = None, frames: int = 1,
                   engine: str = "auto", device=None) -> AllocationResult:
    """Shrink ``design``'s FIFO allocation to simulated high-water marks.

    Starts from the analytic (solver) depths, simulates ``frames``
    back-to-back frames (multi-frame runs measure the steady state:
    inter-frame FIFO residue and crop drain can push marks above the
    single-frame ones), sets each FIFO to
    ``min(analytic, max(hwm - 1 + guard, burst_floor))``, keeps the
    analytic depth where shrinking would increase area (SRL-vs-BRAM
    inversion), then re-simulates to prove the run time is bit-identical.

    When the analytic allocation itself deadlocks (the cycle-accurate
    solver's known gap: reconvergent resampling joins — PYRAMID's
    fanout -> downsample/upsample diamond — need the fanout edge to
    absorb a whole resampling phase of skew the per-edge slack model
    never sees), the allocator *searches upward* instead of aborting: an
    unbounded run measures the true high-water marks, depths start at
    ``max(analytic, hwm - 1 + guard)`` and any edge still implicated in a
    deadlock is grown toward its unbounded mark until the run completes
    at the unbounded frame time.  The grown allocation is the baseline
    the shrink pass then tightens; ``grown_edges`` counts the repairs.

    Every simulation runs on ``engine`` and ``device`` (see
    ``sim.simulate``).  Raises RuntimeError only if even the unbounded
    simulation fails (the netlist itself is broken — nothing to size):
    an ``AllocationError``, which the explorer records and passes over.
    A failure of the engine itself (the cycle kernel's build or launch)
    is not one and propagates."""
    if design.fifo is None:
        raise AllocationError("design has no FIFO solution to tighten")
    bits = {(e.src, e.dst): e.token_bits for e in design.edges}
    analytic = dict(design.fifo.depth)
    floors: Dict[EdgeKey, int] = {}
    for key in analytic:
        prod = design.modules[key[0]]
        floors[key] = (design.edges_map[key].src_burst
                       if prod.kind in UNEXERCISED_BURSTY else 0)
    notes: List[str] = []
    grown = 0
    cap = analytic
    baseline = simulate(design, max_cycles=max_cycles, frames=frames,
                        engine=engine, device=device)
    if not baseline.completed:
        first_deadlock = baseline.deadlock
        unbounded = simulate(design, unbounded=True, max_cycles=max_cycles,
                             frames=frames, engine=engine, device=device)
        if not unbounded.completed:
            raise AllocationError(
                f"baseline simulation deadlocked: {baseline.deadlock}; "
                f"unbounded run too: {unbounded.deadlock}")
        hwm_u = unbounded.hwm_by_key()
        trial = {k: max(d, max(hwm_u.get(k, 0) - 1, 0) + guard, floors[k])
                 for k, d in analytic.items()}
        while True:
            baseline = simulate(design, fifo_depths=trial,
                                max_cycles=max_cycles, frames=frames,
                                engine=engine, device=device)
            if baseline.completed and baseline.cycles <= unbounded.cycles:
                break
            bumped = False
            run_hwm = baseline.hwm_by_key()
            for k in sorted(trial):
                if (trial[k] < hwm_u.get(k, 0)
                        and run_hwm.get(k, 0) >= trial[k]):
                    trial[k] += 1
                    bumped = True
            if not bumped:       # no at-capacity edge left to grow: jump
                trial = {k: max(analytic[k], hwm_u.get(k, 0), floors[k])
                         for k in analytic}
        cap = trial
        grown = sum(1 for k, d in trial.items() if d > analytic[k])
        notes.append(f"  analytic allocation deadlocked ({first_deadlock}); "
                     f"upward search grew {grown} FIFO(s) to the "
                     "simulated marks")
    hwm = baseline.hwm_by_key()
    depths: Dict[EdgeKey, int] = {}
    for key, d_cap in cap.items():
        want = min(d_cap, max(max(hwm.get(key, 0) - 1, 0) + guard,
                              floors[key]))
        if want < d_cap and (area_units(fifo_resources(want, bits[key]))
                             > area_units(fifo_resources(d_cap, bits[key]))):
            notes.append(f"  fifo {key[0]}->{key[1]}: kept depth "
                         f"{d_cap} (shrinking to {want} would leave BRAM "
                         "for costlier SRLs)")
            want = d_cap
        depths[key] = want
    verified = simulate(design, fifo_depths=depths, max_cycles=max_cycles,
                        frames=frames, engine=engine, device=device)
    alloc = AllocationResult(depths, analytic, baseline, verified, guard,
                             notes, frames=frames, grown_edges=grown)
    if not alloc.proven:
        # cannot happen for a capacity >= observed-hwm shrink of a
        # deterministic run; if it does, the simulator itself is broken —
        # fall back to the baseline allocation (analytic, or the grown
        # depths when the analytic ones deadlocked), and stay un-``proven``
        # so the CI gate (bench_hwsim --check) fails loudly instead of
        # shipping a simulator regression silently
        alloc.depths = dict(cap)
        alloc.reverted = True
        alloc.notes.append("  VERIFICATION FAILED: shrunk allocation changed "
                           "behavior; reverted to analytic depths")
    return alloc
