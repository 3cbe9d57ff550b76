"""The top-level compile flow of the port.

The torch counterpart of the reference's ``core/compile.py``.
``compile_pipeline(uf, T, options=CompileOptions(...))`` runs the paper's
hardware flow on the host (numpy, scipy, ``Fraction``):

  1. pipeline interface solve (Static vs Stream, §5.1)
  2. SDF rate propagation and normalisation (§4.1, §7.1)
  3. local mapping of every operator, meets-or-exceeds (§5.2)
  4. automatic interface conversion insertion (§5.3)
  5. FIFO buffer allocation via register minimization (§4.2-4.3), or the
     cycle simulator's measured allocation (``fifo_solver="sim"``, §7.3)

and returns an ``HWDesign`` with the module netlist, solved FIFOs, the
resource and cycle-count report, the cycle simulator (``simulate`` /
``optimize_fifos``), the design-space explorer (``explore``), the static
verifier (``verify``), the frame server (``serve``), and three
executables: ``backend="numpy"`` (the
bit-accurate executor, on the host), ``"torch"`` (the generic lowering)
and ``"kernels"`` (the lowering with dispatch to the CUDA kernels and one
generated CUDA kernel per fused segment).

Compiling touches no device and imports neither the lowering nor torch:
the first ``lower`` / ``run`` on a lowering backend does.

Device rule: every lowering entry point runs on ``device="cuda"`` unless
the call or ``CompileOptions.device`` names another; with no card and no
explicit ``device="cpu"`` it raises.  The numpy backend runs on the host.
The cycle simulator follows the same rule through ``SimOptions.device``
(``CompileOptions.device`` for ``fifo_solver="sim"``, and
``ExploreOptions.device`` for ``explore``, and for ``verify``'s oracle):
its default engine is the cycle kernel on the card, and the scalar
engine on ``device="cpu"``.  ``serve`` runs its frames on the lowering's
device.

The reference's deprecated loose keyword arguments (aliases of the
``CompileOptions`` / ``SimOptions`` fields) are not carried over.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from fractions import Fraction
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from . import buffers as buf
from . import schedule as sched
from .executor import evaluate
from .hwimg import UserFunction, Val, toposort
from .mapper import (MAPPERS, WIRING_OPS, Site, make_converter, make_fanout,
                     solve_interface, solve_rates)
from .rigel import (Resources, RModule, STATIC, STREAM,
                    fifo_resources)

# the lowering engine's backends; ``lowering.engine`` imports them from
# here, so that compiling does not load the lowering
LOWERING_BACKENDS = ("torch", "kernels")
BACKENDS = ("numpy",) + LOWERING_BACKENDS
FIFO_SOLVERS = ("z3", "lp", "asap", "sim")
SIM_ENGINES = ("auto", "scalar", "vector")
EXPLORE_ENGINES = ("population", "vector", "scalar")


@dataclass(frozen=True)
class CompileOptions:
    """Typed option bundle for :func:`compile_pipeline`.

    ``fifo_solver``: "z3" (paper), "lp", "asap", or "sim" — measured, not
    bounded, buffering (paper §7.3): solve analytically (z3), then run the
    cycle simulator over ``sim_frames`` back-to-back frames, shrink every
    FIFO to its steady-state high-water mark (+``sim_guard``), re-simulate
    to prove the run time unchanged, and install the proven depths.
    ``include_burst=False`` + ``manual_fifo_overrides`` reproduce *manual*
    FIFO allocation (paper §7.2/§7.3).  z3 is optional: without it the
    "z3" solve takes the exact LP, which reaches the same optimum.

    ``backend`` is the default engine for ``HWDesign.run``: "numpy" (the
    reference executor on the host), "torch" (the generic plain lowering)
    or "kernels" (the same plus dispatch of matched subgraphs to the
    hand-written CUDA kernels).  ``device`` is the lowering backends'
    default device and the device of ``fifo_solver="sim"``'s simulations;
    None means "cuda"."""
    fifo_solver: str = "z3"
    include_burst: bool = True
    manual_fifo_overrides: Optional[Dict[str, int]] = None
    backend: str = "kernels"
    device: Optional[str] = None
    sim_frames: int = 2
    sim_guard: int = 0

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r} "
                             f"(want one of {BACKENDS})")
        if self.fifo_solver not in FIFO_SOLVERS:
            raise ValueError(f"unknown fifo_solver {self.fifo_solver!r} "
                             f"(want one of {FIFO_SOLVERS})")
        if self.sim_frames < 1:
            raise ValueError("sim_frames must be >= 1")
        if self.sim_guard < 0:
            raise ValueError("sim_guard must be >= 0")


@dataclass(frozen=True)
class SimOptions:
    """The cycle-simulation bundle for ``HWDesign.simulate()`` and
    ``optimize_fifos()``: which cycle engine to run, on which device, how
    many back-to-back frames (steady state), and an optional cycle budget.
    ``engine``: "vector" (the packed-state engine: the cycle kernel on the
    card, its plain version on the CPU), "scalar" (the Python loop, on the
    host) or "auto", the fastest exact engine of ``device``: "vector" on
    "cuda", "scalar" on "cpu".  ``device`` None means "cuda", which raises
    without a card."""
    engine: str = "auto"
    frames: int = 1
    max_cycles: Optional[int] = None
    device: Optional[str] = None

    def __post_init__(self):
        if self.engine not in SIM_ENGINES:
            raise ValueError(f"unknown engine {self.engine!r} "
                             "(want auto, scalar, or vector)")
        if self.frames < 1:
            raise ValueError("frames must be >= 1")


@dataclass(frozen=True)
class ExploreOptions:
    """Typed option bundle for ``HWDesign.explore()`` /
    ``repro_torch.explore.explore_design``: the design-space exploration
    engine (area-vs-throughput Pareto sweep over the cycle simulator).

    Budgets: ``budget_s`` stops the sweep on wall-clock (the first
    evaluation batch always runs); ``max_points`` caps the candidate list
    deterministically (use it, not ``budget_s``, when reproducible fronts
    matter). ``seed`` drives the randomized FIFO-depth variants. Sweep axes
    default to the app's registered ``EXPLORE_SPACE``
    (``repro_torch.apps.EXPLORE_SPACES``) and can be overridden here:
    ``t_ladder`` (throughput targets, each recompiled through
    ``rigel.optimize_lanes``; strings like "1/2" or Fractions),
    ``solvers`` (schedule variants: "z3"/"lp" optimal vs "asap"
    earliest-start), ``scales`` (analytic-depth scale factors), ``jitter``
    (count of seeded per-edge random depth variants per netlist).
    ``engine`` selects the evaluation path: "population" (every depth
    variant of a netlist in one launch of the cycle kernel, the fast
    path), "vector" (serial runs of the packed-state engine), or "scalar"
    (the Python loop on the host, the baseline the points/s are compared
    with).  ``device`` is the cycle engines' device ("cuda" for None, or
    "cpu", where they run their plain version); it also runs the
    sim-proven allocation of each netlist."""
    budget_s: Optional[float] = None
    max_points: Optional[int] = None
    seed: int = 0
    frames: int = 2
    max_cycles: Optional[int] = None
    population: int = 16
    t_ladder: Optional[Tuple[Any, ...]] = None
    solvers: Optional[Tuple[str, ...]] = None
    scales: Optional[Tuple[float, ...]] = None
    jitter: Optional[int] = None
    throughput_tol: float = 0.02
    engine: str = "population"
    device: Optional[str] = None

    def __post_init__(self):
        if self.engine not in EXPLORE_ENGINES:
            raise ValueError(f"unknown explore engine {self.engine!r} "
                             "(want population, vector, or scalar)")
        if self.frames < 1:
            raise ValueError("frames must be >= 1")
        if self.population < 1:
            raise ValueError("population must be >= 1")
        if self.budget_s is not None and self.budget_s <= 0:
            raise ValueError("budget_s must be positive")
        if self.max_points is not None and self.max_points < 1:
            raise ValueError("max_points must be >= 1")
        if self.jitter is not None and self.jitter < 0:
            raise ValueError("jitter must be >= 0")
        if self.throughput_tol < 0:
            raise ValueError("throughput_tol must be >= 0")
        for s in self.solvers or ():
            if s not in ("z3", "lp", "asap"):
                raise ValueError(f"unknown explore solver {s!r} "
                                 "(want z3, lp, or asap)")


@dataclass
class HWDesign:
    name: str
    T: Fraction                       # effective input throughput (px/cycle)
    kind: str                         # STATIC or STREAM pipeline
    modules: List[RModule]
    edges: List[buf.Edge]
    fifo: Optional[buf.BufferSolution]
    out_module: int
    out_tokens_per_frame: int
    in_val: Val
    out_val: Val
    notes: List[str] = field(default_factory=list)
    options: CompileOptions = field(default_factory=CompileOptions)
    # fifo_solver="sim": the analytic depths the simulation-guided
    # allocation replaced (report() shows the two areas side by side) and
    # whether the shrink re-verified (False = reverted to analytic depths)
    fifo_analytic: Optional[Dict[Tuple[int, int], int]] = None
    fifo_sim_proven: Optional[bool] = None
    # the UserFunction this design was compiled from and the T the caller
    # requested (before SDF normalization): explore() recompiles the same
    # pipeline at other throughput targets
    _uf: Optional[UserFunction] = field(default=None, repr=False)
    _t_request: Optional[Fraction] = field(default=None, repr=False)
    _lowered: Dict[Tuple[str, str, str], Any] = field(
        default_factory=dict, repr=False)
    _hwsim: List[Any] = field(default_factory=list, repr=False)
    _verify: List[Any] = field(default_factory=list, repr=False)
    _serve_stats: List[Any] = field(default_factory=list, repr=False)

    # ---- reports ----
    @property
    def resources(self) -> Resources:
        total = Resources()
        for m in self.modules:
            total = total + m.resources
        if self.fifo is not None:
            for (s, d), depth in self.fifo.depth.items():
                total = total + fifo_resources(depth,
                                               self.edges_map[(s, d)].token_bits)
        return total

    @property
    def edges_map(self) -> Dict[Tuple[int, int], buf.Edge]:
        return {(e.src, e.dst): e for e in self.edges}

    def cycles_per_frame(self) -> int:
        """End-to-end cycles for one frame (paper fig. 9 'Cycles' column)."""
        m = self.modules[self.out_module]
        s = self.fifo.start[self.out_module] if self.fifo else 0
        return sched.finish_cycle(m.rate, m.latency, s,
                                  self.out_tokens_per_frame)

    def check_schedule(self, horizon: Optional[int] = None) -> bool:
        """Deadlock / starvation check: along every edge the consumer's
        consumption trace must never exceed what the producer (plus FIFO
        slack) has made available (§4.2)."""
        if self.fifo is None:
            return True
        h = horizon or min(self.cycles_per_frame() + 16, 200_000)
        t = np.arange(h, dtype=np.int64)
        ok = True
        for e in self.edges:
            p, c = self.modules[e.src], self.modules[e.dst]
            sp, sc = self.fifo.start[e.src], self.fifo.start[e.dst]
            # compare in scalar (pixel-payload) units: producer tokens carry
            # V_p scalars, consumer tokens V_c — conversions preserve scalars
            vp = p.iface_out.sched.v
            ci = (c.iface_in or c.iface_out).sched
            vc = ci.v
            # rate-changing consumers (pad/crop/reduce) consume at
            # out_rate * in_tokens / out_tokens
            co = c.iface_out.sched
            cons_rate = c.rate * Fraction(ci.tokens_per_frame,
                                          co.tokens_per_frame)
            cons_rate = min(cons_rate, Fraction(1))
            prod_px = (sched.trace(p.rate, p.latency, sp, t)
                       + e.src_burst) * vp
            cons_px = sched.consumption_trace(cons_rate, sc, t) * vc
            cap_px = min(len(cons_px), len(prod_px))
            if np.any(cons_px[:cap_px] > prod_px[:cap_px] + vp):
                ok = False
        return ok

    def simulate(self, fifo_depths: Optional[Dict[Tuple[int, int], int]] = None,
                 unbounded: bool = False, sample_every: int = 0,
                 options: Optional[SimOptions] = None):
        """Cycle-level dataflow simulation of the mapped module graph
        (hwsim/): valid/ready token handshakes over the solved FIFO depths
        (or ``fifo_depths`` overrides; ``unbounded=True`` removes all
        capacity limits).  ``options`` (a :class:`SimOptions`) selects the
        engine and its device, the back-to-back frame count (steady state)
        and a cycle budget.  Returns a SimResult with the run's cycle
        count, sink
        throughput, per-FIFO high-water marks and a deadlock diagnosis.
        The latest result feeds ``report()``."""
        opt = options or SimOptions()
        from ..hwsim import simulate as _simulate
        res = _simulate(self, fifo_depths=fifo_depths, unbounded=unbounded,
                        max_cycles=opt.max_cycles, sample_every=sample_every,
                        frames=opt.frames, engine=opt.engine,
                        device=opt.device)
        self._hwsim[:] = [res]
        return res

    def optimize_fifos(self, guard: int = 0,
                       options: Optional[SimOptions] = None):
        """Simulation-guided FIFO allocation (hwsim/allocate.py): shrink
        every FIFO from its analytic depth to the simulated high-water mark
        (+``guard``), re-simulate to prove the frame time is unchanged, and
        return the AllocationResult (``SimOptions.frames > 1`` sizes
        against the steady state).  The result feeds ``report()``."""
        opt = options or SimOptions()
        from ..hwsim import allocate_fifos
        alloc = allocate_fifos(self, guard=guard, max_cycles=opt.max_cycles,
                               frames=opt.frames, engine=opt.engine,
                               device=opt.device)
        self._hwsim[:] = [alloc]
        return alloc

    def verify(self, sim: bool = True, backend: str = "torch",
               options: Optional[SimOptions] = None):
        """Static verification (analysis/): value-range analysis with
        wrap-freedom proofs / witnesses over the HWImg DAG, the rewrite
        fixpoint of ``backend``'s rule set ("torch" or "kernels") re-run
        under the IR structural-invariant checker, and the netlist
        handshake/deadlock lint with its three-way differential oracle
        ``static_lower <= simulated hwm <= capacity`` (``sim=False`` skips
        the simulation the oracle needs).  ``options`` shares
        :class:`SimOptions` with ``simulate()``: its ``engine`` and
        ``device`` run the oracle (the cycle kernel on the card by default,
        the scalar engine on "cpu").  Returns a VerifyResult; the latest
        result feeds ``report()``."""
        opt = options or SimOptions()
        from ..analysis import verify_design
        res = verify_design(self, sim=sim, engine=opt.engine,
                            backend=backend, device=opt.device)
        self._verify[:] = [res]
        return res

    def explore(self, options: Optional[ExploreOptions] = None):
        """Design-space exploration (explore/): sweep throughput targets
        (lane counts via ``rigel.optimize_lanes``), FIFO depth policies
        (analytic / sim-proven / scaled / seeded-random) and schedule
        solver variants; evaluate every candidate with the cycle engines
        (by default every depth variant of a netlist in one launch of the
        cycle kernel) plus the hwsim area model; return an
        ``ExploreResult`` whose ``front`` is the area-vs-throughput Pareto
        front with the app's hand-annotated design overlaid.  Requires a
        design produced by :func:`compile_pipeline` (the pipeline is
        recompiled per throughput target)."""
        from ..explore import explore_design
        return explore_design(self, options or ExploreOptions())

    # ---- execution ----
    def lower(self, backend: Optional[str] = None, device=None,
              megakernel: str = "auto"):
        """The lowering-compiler executable for this design, cached per
        (backend, device, megakernel): explicit IR -> rewrite rules ->
        segments (megakernels on the kernels backend unless
        ``megakernel="off"``) -> engine.  The numpy backend has none."""
        b = backend or self.options.backend
        if b not in LOWERING_BACKENDS:
            raise ValueError(f"backend {b!r} has no lowering (want one of "
                             f"{LOWERING_BACKENDS})")
        from .lowering.engine import CompiledPipeline, resolve_device
        dev = resolve_device(device if device is not None
                             else self.options.device)
        key = (b, str(dev), megakernel)
        if key not in self._lowered:
            self._lowered[key] = CompiledPipeline(
                self.out_val, backend=b, device=dev, megakernel=megakernel)
        return self._lowered[key]

    def run(self, inputs: Dict[str, Any], backend: Optional[str] = None,
            device=None):
        """One frame (inputs without a frame axis), bit-exact against the
        numpy executor; numpy results.  ``backend="numpy"`` is the
        executor itself, on the host."""
        b = backend or self.options.backend
        if b == "numpy":
            return evaluate(self.out_val, inputs)
        return self.lower(b, device)(inputs)

    def run_batch(self, inputs: Dict[str, Any],
                  backend: Optional[str] = None, device=None):
        """A batch: every input carries a leading frame axis.  On a
        lowering backend each kernel launches once for the whole batch;
        the numpy backend loops over the frames.  Numpy results."""
        b = backend or self.options.backend
        if b != "numpy":
            return self.lower(b, device).run_batch(inputs)

        def frame(i):
            one = {k: tuple(e[i] for e in val) if isinstance(val, tuple)
                   else val[i] for k, val in inputs.items()}
            return evaluate(self.out_val, one)

        n = next(e[0].shape[0] if isinstance(e, tuple) else e.shape[0]
                 for e in inputs.values())
        outs = [frame(i) for i in range(n)]
        if isinstance(outs[0], tuple):
            return tuple(np.stack([o[j] for o in outs])
                         for j in range(len(outs[0])))
        return np.stack(outs)

    def run_batch_device(self, inputs: Dict[str, Any],
                         backend: Optional[str] = None, device=None):
        """Batched execution whose results stay on the device as tensors
        (a lowering backend only)."""
        b = backend or self.options.backend
        if b == "numpy":
            raise ValueError("run_batch_device needs a lowering backend "
                             f"(one of {LOWERING_BACKENDS}); the numpy "
                             "backend runs on the host")
        return self.lower(b, device).run_batch_device(inputs)

    def serve(self, backend: Optional[str] = None, config=None,
              warm_inputs=None, policy=None, device=None):
        """Boot a streaming frame server (serve/) for this design and
        return the started server: an asyncio scheduler admits frames
        through per-app QoS classes (load shedding with typed
        ``Overloaded`` errors), buckets them by input signature, tops
        batches up while the previous batch is in flight (continuous
        batching), and dispatches each batch on a CUDA stream of its own
        (pinned host buffers, asynchronous copies), with the frame axis
        split over ``config.devices``.  Use as a context manager::

            with design.serve(config=ServeConfig(max_batch=8)) as srv:
                fut = srv.submit({"convolution.in": frame})
                out = fut.result(timeout=60)

        ``backend`` defaults to the design's backend, or "kernels" when
        that is "numpy" (the executor has no batched device path; the swap
        is recorded in ``design.notes`` and shows in ``report()`` /
        ``ServeStats``).  ``config`` is a
        :class:`repro_torch.serve.ServeConfig`; ``warm_inputs`` (exemplar
        frame dicts) and ``policy`` (a QoSPolicy) forward to
        ``FrameServer.register``; ``device`` (default: the design's
        ``CompileOptions.device``, else "cuda", which raises without a
        card) is where the frames run.  The most recent server's stats
        feed back into ``report()``."""
        from ..serve import FrameServer
        b = backend or self.options.backend
        if b == "numpy":
            b = "kernels"
            note = ("serve: backend 'numpy' swapped to 'kernels' (serving "
                    "batches through the lowering engine; pass backend= to "
                    "override)")
            if note not in self.notes:
                self.notes.append(note)
        srv = FrameServer(config=config)
        srv.register(self, backend=b, warm_inputs=warm_inputs,
                     policy=policy, device=device)
        self._serve_stats[:] = [srv.stats]
        srv.start()
        return srv

    def lowering_report(self) -> str:
        """Fused-dispatch and megakernel notes and per-signature call
        counts for every instantiated (backend, device, megakernel)
        lowering."""
        lines: List[str] = []
        for (b, dev, mk), lp in sorted(self._lowered.items()):
            lines.append(f" -- lowering backend={b} device={dev} "
                         f"megakernel={mk} --")
            lines.extend(f"  {ln}" for ln in lp.report_lines())
        return "\n".join(lines)

    def report(self) -> str:
        r = self.resources
        lines = [f"== {self.name}  T={float(self.T):.3g}px/cyc  {self.kind} "
                 f"pipeline ==",
                 f" modules={len(self.modules)} "
                 f"CLBs={r.clbs} DSPs={r.dsps} BRAMs={r.brams} "
                 f"cycles/frame={self.cycles_per_frame()}",
                 f" fifo_bits={self.fifo.total_bits if self.fifo else 0} "
                 f"(solver={self.fifo.solver if self.fifo else '-'})"]
        if self.fifo_analytic is not None and self.fifo is not None:
            # fifo_solver="sim": analytic vs simulation-proven, side by side
            from ..hwsim import area_units, fifo_area
            bits = {(e.src, e.dst): e.token_bits for e in self.edges}
            ana_bits = sum(d * bits[k]
                           for k, d in self.fifo_analytic.items())
            verdict = ("proven by re-simulation" if self.fifo_sim_proven
                       else "NOT PROVEN — reverted to analytic depths")
            lines.append(
                f" fifo solve: analytic bits={ana_bits} "
                f"area={area_units(fifo_area(self.fifo_analytic, self.edges))}u"
                f"  ->  simulated bits={self.fifo.total_bits} "
                f"area={area_units(fifo_area(self.fifo.depth, self.edges))}u "
                f"({verdict})")
        for i, m in enumerate(self.modules):
            s = self.fifo.start[i] if self.fifo else 0
            lines.append(f"  [{i:3d}] s={s:6d} {m!r}")
        if self._lowered:
            lines.append(self.lowering_report())
        for st in self._serve_stats:
            lines.append(" -- serve --")
            lines.extend(f"  {ln}" for ln in st.report_lines())
        for hs in self._hwsim:
            lines.append(" -- hwsim --")
            lines.extend(f"  {ln}" for ln in hs.report_lines())
        for vr in self._verify:
            lines.append(" -- verify --")
            lines.extend(f"  {ln}" for ln in vr.report_lines())
        return "\n".join(lines)


def compile_pipeline(uf: UserFunction, T: Fraction = Fraction(1),
                     options: Optional[CompileOptions] = None) -> HWDesign:
    """The full HWTool flow for one pipeline at target throughput T.

    ``options`` (a :class:`CompileOptions`) holds every compile-time knob.
    ``fifo_solver="sim"`` solves analytically (z3), runs the cycle
    simulator over ``sim_frames`` back-to-back frames, shrinks every FIFO
    to its steady-state high-water mark (+``sim_guard``), re-simulates to
    prove the run time unchanged, and installs the proven depths
    (``report()`` shows analytic vs simulated side by side; the analytic
    depths stay available as ``fifo_analytic``).  ``include_burst=False``
    + overrides reproduce *manual* FIFO allocation (paper §7.2/§7.3): the
    user zeroes burst slack on modules whose bursts are absorbed elsewhere
    (e.g. pad/crop backed by AXI DMA).  Nothing is lowered, and no device
    is touched, until the first ``lower``/``run`` on a lowering backend.
    """
    opt = options or CompileOptions()
    include_burst = opt.include_burst
    manual_fifo_overrides = opt.manual_fifo_overrides
    sim_frames, sim_guard = opt.sim_frames, opt.sim_guard
    fifo_solver = opt.fifo_solver
    sim_solver = fifo_solver == "sim"
    if sim_solver:
        fifo_solver = "z3"        # the analytic solve the simulation tightens
    T = Fraction(T)
    inp, out = uf.build()
    kind = solve_interface(out)
    # SDF rate normalization (paper §7.1: "HWTool does not produce hardware
    # at exactly the T requested"): scale the input throughput down so that
    # no site's pixel rate exceeds 1 px/cycle per minimum-size instance.
    # This is why the paper's CONVOLUTION runs at T=0.98, not 1.0 — its Pad
    # amplifies the pixel count by 2106368/2073600.
    raw = solve_rates(out, Fraction(1))
    max_ratio = max([r for r in raw.values() if r > 0] or [Fraction(1)])
    T_eff = T / max_ratio if max_ratio > 1 else T
    rates = solve_rates(out, T_eff)

    order = [v for v in toposort(out)]
    # resolve wiring ops (Concat / TupleIndex / FanOut / FanIn) to their
    # producing value: they become wires (FanOut modules are re-inserted
    # explicitly below for every multi-consumer producer)
    resolved: Dict[int, Val] = {}

    def resolve(v: Val) -> Val:
        if v.uid in resolved:
            return resolved[v.uid]
        r = v
        if v.op in ("TupleIndex",):
            src = resolve(v.inputs[0])
            if src.op in ("Concat", "FanOut"):
                i = v.p["i"]
                r = resolve(src.inputs[i if src.op == "Concat" else 0])
            else:
                r = src
        elif v.op in ("FanIn",):
            r = resolve(v.inputs[0])
        resolved[v.uid] = r
        return r

    real_nodes = [v for v in order
                  if v.op not in WIRING_OPS and resolve(v) is v]

    # --- map every real node locally (§5.2) ---
    modules: List[RModule] = []
    node_to_mod: Dict[int, int] = {}
    notes: List[str] = []
    for v in real_nodes:
        in_rate = rates[resolve(v.inputs[0]).uid] if v.inputs else Fraction(0)
        site = Site(v, rates[v.uid], in_rate, kind)
        m = MAPPERS[v.op](v, site)
        node_to_mod[v.uid] = len(modules)
        modules.append(m)
        if m.iface_out.kind == STREAM and kind == STATIC:
            kind = STREAM  # §5.1: halt-and-mark (defensive; solve above)

    # --- wire edges through resolved values; insert conversions (§5.3) ---
    consumers: Dict[int, List[Tuple[Val, int]]] = {}
    for v in real_nodes:
        for i in v.inputs:
            src = resolve(i)
            if src.op == "Const":
                continue  # register banks need no FIFO / conversion
            consumers.setdefault(src.uid, []).append((v, node_to_mod[v.uid]))

    edges: List[buf.Edge] = []
    for src_uid, cons in consumers.items():
        pi = node_to_mod[src_uid]
        prod = modules[pi]
        tail = pi
        if len(cons) > 1:
            fo = make_fanout(prod, len(cons), kind)
            fo.src_uid = None
            modules.append(fo)
            edges.append(buf.Edge(pi, len(modules) - 1,
                                  prod.iface_out.sched.token_bits,
                                  prod.latency, prod.burst))
            tail = len(modules) - 1
            notes.append(f"inserted FanOut({len(cons)}) after {prod.name}")
        for cv, ci in cons:
            cons_mod = modules[ci]
            want = cons_mod.iface_in.sched.v if cons_mod.iface_in else \
                cons_mod.iface_out.sched.v
            conv = make_converter(modules[tail], want, kind)
            head = tail
            if conv is not None:
                modules.append(conv)
                edges.append(buf.Edge(head, len(modules) - 1,
                                      modules[head].iface_out.sched.token_bits,
                                      modules[head].latency,
                                      modules[head].burst))
                head = len(modules) - 1
                notes.append(f"inserted {conv.name} {modules[tail].iface_out.sched.v}"
                             f"->{want} before {cons_mod.name}")
            edges.append(buf.Edge(head, ci,
                                  modules[head].iface_out.sched.token_bits,
                                  modules[head].latency, modules[head].burst))

    # --- AXI DMA sink (paper §6: the testbench simulates the AXI memory
    # system). The sink consumes the pipeline output at its steady rate, so
    # bursty tail modules (Crop) get an isolating FIFO in auto mode. ---
    out_res0 = resolve(out)
    om = node_to_mod[out_res0.uid]
    sink = RModule("axi_dma", "Sink", modules[om].iface_out,
                   modules[om].iface_out, modules[om].rate, 0,
                   resources=Resources(luts=64, regs=64))
    modules.append(sink)
    edges.append(buf.Edge(om, len(modules) - 1,
                          modules[om].iface_out.sched.token_bits,
                          modules[om].latency, modules[om].burst))

    # --- manual FIFO overrides (§7.2-7.3): the designer replaces the burst
    # slack of named modules (e.g. zero for pad/crop whose bursts are
    # absorbed by the AXI DMA, or an enlarged Filter FIFO in DESCRIPTOR) ---
    if manual_fifo_overrides:
        edges = [
            buf.Edge(e.src, e.dst, e.token_bits, e.src_latency,
                     manual_fifo_overrides.get(modules[e.src].name,
                                               e.src_burst))
            for e in edges
        ]

    # --- FIFO allocation (§4.2-4.3) ---
    # cross-arm demand gaps (analysis/traces.py): a broadcast out-edge must
    # also hold tokens pushed in lockstep for a hungrier sibling arm but
    # never popped by its own consumer — invisible to the per-edge slack
    # LP.  Only netlists with a multi-out producer can have them (the
    # profiled need tables behind the gaps cost O(W*H) to build, so skip
    # the pass entirely on pure chains).
    extra_slots = None
    srcs = [e.src for e in edges]
    if len(srcs) > len(set(srcs)):          # some producer has >= 2 out-edges
        from ..analysis.traces import broadcast_extra_slots
        extra_slots = broadcast_extra_slots(modules, edges) or None
    fifo = buf.solve_buffers(len(modules), edges, solver=fifo_solver,
                             include_burst=include_burst,
                             extra_slots=extra_slots)
    if extra_slots:
        notes.append(
            "cross-arm broadcast residue: "
            + ", ".join(f"fifo {k} +{v} slots"
                        for k, v in sorted(extra_slots.items())))

    out_res = resolve(out)
    out_mod = node_to_mod[out_res.uid]
    out_sched = modules[out_mod].iface_out.sched
    if T_eff != T:
        notes.append(f"SDF normalization: requested T={float(T):.4g} -> "
                     f"effective T={float(T_eff):.4g} (max ratio "
                     f"{float(max_ratio):.5g})")
    design = HWDesign(uf.name, T_eff, kind, modules, edges, fifo, out_mod,
                      out_sched.tokens_per_frame, inp, out, notes,
                      options=opt)
    design._uf = uf
    design._t_request = T
    if sim_solver:
        # measured-not-bounded FIFO sizing (§7.3): simulate, shrink to the
        # steady-state high-water marks, prove, install
        alloc = design.optimize_fifos(guard=sim_guard,
                                      options=SimOptions(frames=sim_frames,
                                                         device=opt.device))
        design.fifo_analytic = dict(alloc.analytic)
        design.fifo_sim_proven = alloc.proven
        design.fifo = fifo.with_depths(alloc.depths, edges, solver="sim")
        grown = (f", {alloc.grown_edges} grown past a deadlocked analytic "
                 "depth (reconvergent-join repair)" if alloc.grown_edges
                 else "")
        design.notes.append(
            f"fifo_solver=sim: {alloc.shrunk_edges}/{len(alloc.depths)} "
            f"FIFOs shrunk over {sim_frames} simulated frame(s){grown}, "
            f"{fifo.total_bits} -> {design.fifo.total_bits} bits "
            f"({'proven' if alloc.proven else 'NOT PROVEN — reverted'})")
    return design
