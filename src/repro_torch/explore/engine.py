"""The design-space exploration engine (paper §7 by search, not by hand).

``explore_design`` sweeps hardware design points for one pipeline:

  - **throughput targets** (``t_ladder``): each target is a full recompile
    through ``compile_pipeline`` — SDF rate solve, ``optimize_lanes`` lane
    selection, conversion insertion — so lane counts and netlist shape
    vary across the ladder;
  - **schedule variants** (``solvers``): the optimal register-minimizing
    start schedule ("z3"/"lp") vs the earliest-start schedule ("asap"),
    which trades FIFO placement;
  - **FIFO depth policies** per compiled netlist: the analytic solve, the
    simulation-proven shrink (``hwsim.allocate``), scaled analytic
    variants, and seeded per-edge random jitter (the randomized part of
    the sweep — same ``ExploreOptions.seed``, same candidates).

Every candidate is evaluated by the cycle simulator — by default the
population-batched engine (``hwsim.population``), which advances every
depth variant of a netlist in one launch of the cycle kernel
(``csrc/cyclesim.cu``, one thread block per variant) — and priced with
the ``hwsim.area`` model.  ``ExploreOptions.device`` places the cycle
engines: "cuda" (the default, which raises without a card) or "cpu",
where they run their plain version.  Completed points form the
area-vs-throughput Pareto front; the app's HAND_FIFO design is evaluated
the same way and overlaid.  Deadlocked candidates are kept (reported,
never on the front): an under-provisioned FIFO allocation that deadlocks
is a real answer the search must see, not an error.

Before simulating, each netlist's candidates pass through a static
pre-filter (``analysis.traces.required_capacities`` /
``deadlock_reason``): a depth set that provably deadlocks — some
broadcast out-edge has less capacity than the cross-arm residue it must
hold — is recorded as a deadlocked point *without* a simulation run,
carrying the static proof as its diagnosis.  On PYRAMID this skips the
sweep's slowest candidates (each would otherwise burn a full
``stall_limit`` plateau before the simulator gives up).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from fractions import Fraction
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..analysis.traces import deadlock_reason, required_capacities
from ..core.compile import (CompileOptions, ExploreOptions, HWDesign,
                            compile_pipeline)
from ..core.rigel import Resources
from ..hwsim.area import area_units, fifo_area
from ..hwsim.occupancy import OccupancyTrace
from ..hwsim.sim import SimResult, build_sim
from ..hwsim.vector import resolve_device
from .pareto import DesignPoint, ParetoFront, freeze_depths

EdgeKey = Tuple[int, int]

# sweep-axis defaults for pipelines without a registered EXPLORE_SPACE:
# the ladder is relative to the design's requested T
_DEFAULT_SOLVERS = ("lp", "asap")
_DEFAULT_SCALES = (0.5, 0.75, 1.25)
_DEFAULT_JITTER = 4
_JITTER_RANGE = (0.4, 1.6)


@dataclass
class ExploreResult:
    """One sweep: the Pareto front, the hand overlay, every evaluated
    point, and the throughput-of-the-search metrics the bench commits."""

    app: str
    options: ExploreOptions
    front: ParetoFront
    hand: Optional[DesignPoint]
    points: List[DesignPoint]
    eval_seconds: float
    wall_seconds: float
    cycles_skipped: int
    notes: List[str] = field(default_factory=list)
    static_rejects: int = 0

    @property
    def n_evaluated(self) -> int:
        return len(self.points)

    @property
    def points_per_sec(self) -> float:
        return self.n_evaluated / self.eval_seconds \
            if self.eval_seconds > 0 else 0.0

    def best_area_ratio(self) -> Optional[float]:
        """Cheapest front point at >= (1 - tol) x the hand design's
        throughput, as a fraction of the hand design's area — the sweep's
        auto-vs-hand answer.  None when the hand overlay is missing or no
        front point reaches the floor."""
        if self.hand is None:
            return None
        floor = self.hand.throughput * (1.0 - self.options.throughput_tol)
        p = self.front.best_at(floor)
        if p is None:
            return None
        return p.area_units / max(1, self.hand.area_units)

    def as_dict(self) -> Dict[str, object]:
        d: Dict[str, object] = {
            "front_size": len(self.front.points),
            "points_evaluated": self.n_evaluated,
            "points_per_sec": round(self.points_per_sec, 2),
            "eval_seconds": round(self.eval_seconds, 3),
            "wall_seconds": round(self.wall_seconds, 3),
            "cycles_skipped": self.cycles_skipped,
            "static_rejects": self.static_rejects,
            "engine": self.options.engine,
            "seed": self.options.seed,
        }
        ratio = self.best_area_ratio()
        if ratio is not None:
            d["best_area_ratio"] = round(ratio, 4)
        if self.hand is not None:
            d["hand"] = self.hand.as_dict()
        d["front"] = [p.as_dict() for p in self.front.points]
        return d

    def report_lines(self) -> List[str]:
        n_dead = sum(1 for p in self.points if not p.completed)
        lines = [
            f"{self.app}: {self.n_evaluated} design points evaluated in "
            f"{self.eval_seconds:.2f}s ({self.points_per_sec:.1f} pts/s, "
            f"engine={self.options.engine}, "
            f"{self.cycles_skipped} cycles event-jumped, "
            f"{n_dead} deadlocked, {self.static_rejects} rejected "
            "statically), front size "
            f"{len(self.front.points)}"]
        lines.extend(self.front.report_lines(hand=self.hand))
        ratio = self.best_area_ratio()
        if ratio is not None:
            lines.append(
                f"best auto area at hand throughput: {ratio:.3f}x hand")
        lines.extend(f"note: {n}" for n in self.notes)
        return lines


def _modules_area(design: HWDesign) -> Resources:
    total = Resources()
    for m in design.modules:
        total = total + m.resources
    return total


def _throughput(design: HWDesign, res: SimResult) -> Tuple[float, int]:
    """(output pixels per cycle, cycles per frame) — steady-state when the
    run recorded >= 2 frame boundaries, whole-run otherwise."""
    sched = design.modules[design.out_module].iface_out.sched
    px_frame = sched.w * sched.h
    if res.completed and len(res.frame_ends) >= 2:
        cpf = res.frame_ends[-1] - res.frame_ends[-2]
    elif res.completed and res.frame_ends:
        cpf = res.frame_ends[-1] + 1
    else:
        cpf = max(1, res.cycles)
    if not res.completed:
        # partial: credit what actually drained before the deadlock
        done_frac = res.sink_tokens / max(1, design.out_tokens_per_frame
                                          * res.frames)
        return done_frac * px_frame * res.frames / max(1, res.cycles), cpf
    return px_frame / max(1, cpf), cpf


def _point(design: HWDesign, app: str, origin: str, label: str, solver: str,
           policy: str, depths: Dict[EdgeKey, int],
           res: SimResult) -> DesignPoint:
    bits = {(e.src, e.dst): e.token_bits for e in design.edges}
    total = _modules_area(design) + fifo_area(depths, design.edges)
    tput, cpf = _throughput(design, res)
    return DesignPoint(
        app=app, label=label, origin=origin, T=str(design.T),
        solver=solver, fifo_policy=policy,
        area_units=area_units(total), area_clbs=total.clbs,
        area_brams=total.brams,
        fifo_bits=sum(d * bits[k] for k, d in depths.items()),
        throughput=tput, cycles=res.cycles, cycles_per_frame=cpf,
        completed=res.completed, cycles_skipped=res.cycles_skipped,
        depths=freeze_depths(depths))


def _evaluate(design: HWDesign, depth_sets: Sequence[Dict[EdgeKey, int]],
              options: ExploreOptions) -> List[SimResult]:
    """Evaluate one netlist's depth variants with the selected engine."""
    if options.engine == "population":
        from ..hwsim.population import PopulationSim
        out: List[SimResult] = []
        for lo in range(0, len(depth_sets), options.population):
            chunk = depth_sets[lo:lo + options.population]
            out.extend(PopulationSim(design.modules, design.edges, chunk,
                                     frames=options.frames,
                                     device=options.device)
                       .run(max_cycles=options.max_cycles))
        return out
    if options.engine == "vector":
        from ..hwsim.vector import VectorSim
        return [VectorSim(design.modules, design.edges, ds,
                          frames=options.frames, device=options.device)
                .run(max_cycles=options.max_cycles) for ds in depth_sets]
    # "scalar": the Python loop on the host — the serial baseline the
    # points/s of the other engines are compared with
    return [build_sim(design.modules, design.edges, ds,
                      frames=options.frames)
            .run(max_cycles=options.max_cycles) for ds in depth_sets]


def _depth_variants(design: HWDesign, options: ExploreOptions,
                    scales: Sequence[float], jitter: int,
                    rng: np.random.RandomState, notes: List[str]
                    ) -> List[Tuple[str, Dict[EdgeKey, int]]]:
    """The FIFO depth policies for one compiled netlist, deduplicated.
    The rng is consumed in a fixed order (jitter draws always happen,
    even for variants later deduplicated) so candidate identity depends
    only on the seed and the sweep axes."""
    ana: Dict[EdgeKey, int] = dict(design.fifo.depth) if design.fifo else {}
    keys = sorted(ana)
    sets: List[Tuple[str, Dict[EdgeKey, int]]] = [("analytic", ana)]
    from ..hwsim.allocate import AllocationError, allocate_fifos
    try:
        alloc = allocate_fifos(design, frames=options.frames,
                               engine="vector", device=options.device)
        sets.append(("sim", dict(alloc.depths)))
    except AllocationError as ex:  # only a netlist with nothing to size
        notes.append(f"sim-proven allocation failed: {ex}")
    for f in scales:
        sets.append((f"scale:{f:g}",
                     {k: max(0, int(round(v * f))) for k, v in ana.items()}))
    for i in range(jitter):
        fac = rng.uniform(*_JITTER_RANGE, size=len(keys))
        sets.append((f"jitter:{i}",
                     {k: max(0, int(round(ana[k] * fac[j])))
                      for j, k in enumerate(keys)}))
    seen = set()
    uniq = []
    for policy, ds in sets:
        frozen = freeze_depths(ds)
        if frozen in seen:
            continue
        seen.add(frozen)
        uniq.append((policy, ds))
    return uniq


def _resolve_axes(design: HWDesign, options: ExploreOptions
                  ) -> Tuple[List[Fraction], Tuple[str, ...],
                             Tuple[float, ...], int]:
    space: Dict[str, object] = {}
    try:
        from ..apps import EXPLORE_SPACES
        space = EXPLORE_SPACES.get(design.name, {})
    except Exception:  # pragma: no cover - apps registry always importable
        pass
    t_req = design._t_request or design.T
    raw_ladder = options.t_ladder or space.get("t_ladder") \
        or (t_req, t_req / 2, t_req / 4)
    ladder = []
    for x in raw_ladder:
        f = Fraction(str(x)) if not isinstance(x, Fraction) else x
        if f > 0 and f not in ladder:
            ladder.append(f)
    solvers = tuple(options.solvers or space.get("solvers")
                    or _DEFAULT_SOLVERS)
    scales = tuple(options.scales or space.get("scales") or _DEFAULT_SCALES)
    jitter = options.jitter if options.jitter is not None \
        else int(space.get("jitter", _DEFAULT_JITTER))
    return ladder, solvers, scales, jitter


def _hand_point(design: HWDesign, options: ExploreOptions,
                hand: Dict[str, int], notes: List[str]
                ) -> Optional[DesignPoint]:
    """Compile + evaluate the hand-annotated design (manual burst
    overrides at the requested T, the paper's §7.2 manual column)."""
    uf = design._uf
    t_req = design._t_request or design.T
    try:
        hd = compile_pipeline(uf, t_req, CompileOptions(
            manual_fifo_overrides=dict(hand)))
    except Exception as ex:  # pragma: no cover - hand compile is routine
        notes.append(f"hand overlay failed: {ex}")
        return None
    # the engine's own failures (the cycle kernel's build or launch)
    # propagate
    depths = dict(hd.fifo.depth) if hd.fifo else {}
    res = _evaluate(hd, [depths], options)[0]
    return _point(hd, design.name, "hand", "hand", "z3", "hand", depths, res)


def explore_design(design: HWDesign,
                   options: Optional[ExploreOptions] = None,
                   hand: Optional[Dict[str, int]] = None) -> ExploreResult:
    """Sweep the design space around ``design`` and return the
    area-vs-throughput Pareto front (see module docstring).  ``hand``
    overrides the app registry's HAND_FIFO annotations for the overlay
    point ({} evaluates the plain analytic design as "hand")."""
    options = options or ExploreOptions()
    resolve_device(options.device)
    if design._uf is None:
        raise ValueError(
            "explore() needs a design produced by compile_pipeline "
            "(the pipeline is recompiled per throughput target)")
    app = design.name
    if hand is None:
        try:
            from ..apps import SIM_CASES
            if app in SIM_CASES:
                hand = SIM_CASES[app]()[2]
        except Exception:  # pragma: no cover
            hand = None
    notes: List[str] = []
    ladder, solvers, scales, jitter = _resolve_axes(design, options)
    rng = np.random.RandomState(options.seed)
    wall0 = time.perf_counter()

    # phase 1: compile the (T, solver) netlists and enumerate candidates.
    # rng consumption is per-netlist in a fixed order, so the candidate
    # list is a pure function of (seed, axes) — the budget only truncates.
    netlists: List[Tuple[HWDesign, str,
                         List[Tuple[str, Dict[EdgeKey, int]]]]] = []
    n_cand = 0
    for T in ladder:
        for solver in solvers:
            if options.max_points is not None \
                    and n_cand >= options.max_points:
                break
            try:
                d_t = compile_pipeline(design._uf, T,
                                       CompileOptions(fifo_solver=solver))
            except Exception as ex:
                notes.append(f"T={T} solver={solver}: compile failed: {ex}")
                continue
            variants = _depth_variants(d_t, options, scales, jitter, rng,
                                       notes)
            if options.max_points is not None:
                variants = variants[:options.max_points - n_cand]
            n_cand += len(variants)
            netlists.append((d_t, solver, variants))

    # phase 2: evaluate, population-batched per netlist; the wall-clock
    # budget is checked between batches (the first batch always runs).
    # Statically-provable deadlocks (cross-arm broadcast residue beyond a
    # candidate's capacity) skip simulation and carry the proof instead.
    points: List[DesignPoint] = []
    eval_s = 0.0
    static_rejects = 0
    for d_t, solver, variants in netlists:
        if points and options.budget_s is not None \
                and time.perf_counter() - wall0 > options.budget_s:
            notes.append(
                f"budget exhausted: {len(points)}/{n_cand} candidates "
                "evaluated")
            break
        t0 = time.perf_counter()
        required = required_capacities(d_t.modules, d_t.edges)
        live: List[Tuple[str, Dict[EdgeKey, int]]] = []
        rejected: List[Tuple[str, Dict[EdgeKey, int], str]] = []
        for policy, ds in variants:
            reason = deadlock_reason(ds, required) if required else None
            if reason is None:
                live.append((policy, ds))
            else:
                rejected.append((policy, ds, reason))
        results = _evaluate(d_t, [ds for _, ds in live], options) \
            if live else []
        eval_s += time.perf_counter() - t0
        for (policy, ds), res in zip(live, results):
            label = f"T={d_t.T} {solver} {policy}"
            points.append(_point(d_t, app, "auto", label, solver, policy,
                                 ds, res))
        for policy, ds, reason in rejected:
            res = SimResult(cycles=0, sink_tokens=0, deadlock=reason,
                            occupancy=OccupancyTrace([], 0),
                            frames=options.frames, engine="static")
            label = f"T={d_t.T} {solver} {policy}"
            points.append(_point(d_t, app, "auto", label, solver, policy,
                                 ds, res))
        static_rejects += len(rejected)
    if static_rejects:
        notes.append(f"{static_rejects} candidate(s) rejected by the "
                     "static broadcast-residue pre-filter (no simulation)")

    hand_pt = _hand_point(design, options, hand, notes) \
        if hand is not None else None
    front = ParetoFront.of(points)
    return ExploreResult(
        app=app, options=options, front=front, hand=hand_pt, points=points,
        eval_seconds=eval_s, wall_seconds=time.perf_counter() - wall0,
        cycles_skipped=sum(p.cycles_skipped for p in points), notes=notes,
        static_rejects=static_rejects)


def explore_app(name: str, options: Optional[ExploreOptions] = None
                ) -> ExploreResult:
    """Sweep one registered app (``repro_torch.apps.SIM_CASES``) at its
    default sim-case size, hand annotations included."""
    from ..apps import SIM_CASES
    if name not in SIM_CASES:
        raise KeyError(f"unknown app {name!r} "
                       f"(want one of {sorted(SIM_CASES)})")
    uf, t_req, hand = SIM_CASES[name]()
    design = compile_pipeline(uf, t_req, CompileOptions())
    return explore_design(design, options, hand=hand)
