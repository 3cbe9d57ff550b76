"""The port's hardware half against the reference, on the CPU.

- ``compile_pipeline``: the interface and rate solve, local mapping, FIFO
  allocation, resources, cycles and ``check_schedule`` equal the
  reference's field for field, on the five apps at paper and ``sim_case``
  sizes and on CONVOLUTION at every fig. 9 throughput;
- the scalar cycle simulator and ``allocate_fifos`` equal the reference's
  scalar engine at each ``sim_case`` (1 and 2 frames, bounded and not),
  ``fifo_solver="sim"`` installs the same proven depths, and the area
  rows against ``HAND_FIFO`` are the same;
- the executor equals the reference's on the five apps, the point-function
  probes and a Float operand mixed with an integer one;
- the reference's own system, schedule, rigel and solver properties,
  held for the port (its schedule properties with the scalar engine).

The reference's ``compile_pipeline`` imports its lowering for every
netlist with a fanout, and that lowering needs
``jax.experimental.enable_x64``, which this jax no longer has.  So the
reference's numbers come from one subprocess that aliases it before
importing ``repro`` and asks for the scalar engine (its vectorized one is
the same lowering's).  The subprocess starts with the module and runs
while the port-only tests do.
"""
import inspect
import json
import os
import subprocess
import sys
import textwrap
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")

from hypothesis import given, settings, strategies as st  # noqa: E402

import repro.core as jax_core  # noqa: E402
from repro.core.executor import evaluate as ref_evaluate  # noqa: E402
from repro.apps import BENCH_CASES as REF_BENCH_CASES  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
from repro_torch import CompileOptions, SimOptions, compile_pipeline  # noqa
from repro_torch.apps import (BENCH_CASES, PIPELINES, SIM_CASES,  # noqa: E402
                              Convolution, Stereo, golden_convolution)
from repro_torch.apps.convolution import PAPER_CONV  # noqa: E402
from repro_torch.core import buffers as buf  # noqa: E402
from repro_torch.core import schedule as sched  # noqa: E402
from repro_torch.core.executor import evaluate  # noqa: E402
from repro_torch.core.rigel import (ScheduleType, fifo_resources,  # noqa
                                    optimize_lanes, valid_lane_counts)
from repro_torch.core.dtypes import UInt  # noqa: E402
from repro_torch.hwsim import (VectorSim, allocate_fifos,  # noqa: E402
                               area_units, compare, fifo_area)
from repro_torch.hwsim.sim import (CycleSim, _need_proportional,  # noqa
                                   _SimEdge, _SimMod, simulate)
from repro_torch.kernels.megakernel.check import point_fn_probes  # noqa

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
APPS = sorted(PIPELINES)

# label -> (app, where: "paper" | "sim", T or None for the case's own)
COMPILE_CASES = {f"{app}_paper": (app, "paper", "1") for app in APPS}
COMPILE_CASES.update({f"{app}_sim": (app, "sim", None) for app in APPS})
COMPILE_CASES.update({f"convolution_T{t}".replace("/", "_"):
                      ("convolution", "paper", str(t))
                      for t in PAPER_CONV if t != 1})
SIM_RUNS = [(app, frames, unbounded) for app in APPS for frames in (1, 2)
            for unbounded in (False, True)]


def _summary(d):
    """One compiled design as plain JSON: every field the two packages
    must agree on (Fractions as strings, edge keys as pairs)."""
    f, r = d.fifo, d.resources
    return {
        "name": d.name, "kind": d.kind, "T": str(d.T),
        "modules": [{"name": m.name, "kind": m.kind, "rate": str(m.rate),
                     "latency": m.latency, "burst": m.burst,
                     "lanes": m.iface_out.sched.v,
                     "iface_in": repr(m.iface_in),
                     "iface_out": repr(m.iface_out),
                     "resources": [m.resources.luts, m.resources.regs,
                                   m.resources.dsps, m.resources.bram_bits],
                     "info": repr(sorted(m.info.items()))}
                    for m in d.modules],
        "edges": [[e.src, e.dst, e.token_bits, e.src_latency, e.src_burst]
                  for e in d.edges],
        "out": [d.out_module, d.out_tokens_per_frame],
        "start": [int(s) for s in f.start],
        "slack": sorted([a, b, int(v)] for (a, b), v in f.slack.items()),
        "depth": sorted([a, b, int(v)] for (a, b), v in f.depth.items()),
        "total_bits": int(f.total_bits), "solver": f.solver,
        "cycles": int(d.cycles_per_frame()),
        "check_schedule": bool(d.check_schedule()),
        "resources": [r.luts, r.regs, r.dsps, r.bram_bits, r.clbs, r.brams],
        "notes": list(d.notes),
    }


def _sim_summary(res):
    return {"cycles": int(res.cycles), "sink_tokens": int(res.sink_tokens),
            "deadlock": res.deadlock, "frames": res.frames,
            "frame_ends": [int(c) for c in res.frame_ends],
            "edges": [[list(map(int, k)), int(h), int(hc),
                       None if hf is None else int(hf), int(pu), int(po)]
                      for k, h, hc, hf, pu, po in res.edge_signature()],
            "needed": sorted([a, b, int(v)] for (a, b), v in
                             res.occupancy.needed_depth_by_key().items())}


def _alloc_summary(alloc, edges):
    bits = {(e.src, e.dst): e.token_bits for e in edges}
    return {"depths": sorted([a, b, int(v)]
                             for (a, b), v in alloc.depths.items()),
            "analytic": sorted([a, b, int(v)]
                               for (a, b), v in alloc.analytic.items()),
            "proven": bool(alloc.proven), "reverted": alloc.reverted,
            "shrunk": alloc.shrunk_edges, "grown": alloc.grown_edges,
            "bits": int(alloc.total_bits(bits)),
            "baseline": int(alloc.baseline.cycles),
            "verified": int(alloc.verified.cycles),
            "notes": list(alloc.notes)}


_REF_SCRIPT = textwrap.dedent('''
    import json, sys
    from fractions import Fraction
    import jax, jax.experimental
    jax.experimental.enable_x64 = jax.enable_x64   # this process only
    from repro.apps import PIPELINES, SIM_CASES
    from repro.core import CompileOptions, compile_pipeline
    import repro.hwsim.allocate as allocate
    from repro.hwsim import allocate_fifos, compare
    from repro.hwsim.sim import simulate

    _sim = allocate.simulate
    # the scalar engine everywhere, fifo_solver="sim" included
    allocate.simulate = lambda *a, **k: _sim(*a, **dict(k, engine="scalar"))
''') + "\n".join(inspect.getsource(f) for f in (
    _summary, _sim_summary, _alloc_summary)) + textwrap.dedent('''

    spec, part = json.load(open(sys.argv[1])), sys.argv[3]
    out = {"compile": {}, "sim": {}, "alloc": {}, "sim_solver": {},
           "area": {}}
    for label, (app, where, t) in spec["compile"].items():
        if (where == "sim") != (part == "sim"):
            continue
        if where == "sim":
            uf, T, _ = SIM_CASES[app]()
        else:
            uf, T = PIPELINES[app](), Fraction(t)
        out["compile"][label] = _summary(compile_pipeline(uf, T=T))
    if part == "sim":
        sim_designs = {app: compile_pipeline(*SIM_CASES[app]()[:2])
                       for app in SIM_CASES}
        for app, frames, unbounded in spec["sim"]:
            res = simulate(sim_designs[app], unbounded=unbounded,
                           frames=frames, engine="scalar")
            out["sim"][f"{app}-{frames}-{unbounded}"] = _sim_summary(res)
        d = sim_designs["pyramid"]
        out["sim"]["pyramid-zero"] = _sim_summary(simulate(
            d, fifo_depths={k: 0 for k in d.fifo.depth}, engine="scalar"))
        for app, d in sim_designs.items():
            uf, T, hand = SIM_CASES[app]()
            alloc = allocate_fifos(d, frames=1, engine="scalar")
            out["alloc"][f"{app}-1"] = _alloc_summary(alloc, d.edges)
            hd = compile_pipeline(uf, T=T, options=CompileOptions(
                manual_fifo_overrides=hand))
            out["area"][app] = compare(app, d, alloc, hd).as_dict()
            # fifo_solver="sim" allocates over 2 frames on the z3 design:
            # its allocation is the 2-frame one
            s = compile_pipeline(uf, T=T,
                                 options=CompileOptions(fifo_solver="sim"))
            (alloc2,) = s._hwsim
            out["alloc"][f"{app}-2"] = _alloc_summary(alloc2, s.edges)
            out["sim_solver"][app] = {
                "summary": _summary(s), "proven": s.fifo_sim_proven,
                "analytic": sorted([a, b, v] for (a, b), v in
                                   s.fifo_analytic.items())}
    json.dump(out, open(sys.argv[2], "w"))
''')


class _Reference:
    """The reference's numbers, computed in two subprocesses (the compile
    cases at paper size; the sim cases) started at construction; ``get()``
    waits for them."""

    def __init__(self, tmp):
        spec = {"compile": COMPILE_CASES, "sim": SIM_RUNS}
        (tmp / "spec.json").write_text(json.dumps(spec))
        (tmp / "ref.py").write_text(_REF_SCRIPT)
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH=os.path.join(ROOT, "src"))
        self.procs = {part: (tmp / f"{part}.json", subprocess.Popen(
            [sys.executable, str(tmp / "ref.py"), str(tmp / "spec.json"),
             str(tmp / f"{part}.json"), part], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
            for part in ("paper", "sim")}
        self.data = None

    def get(self):
        if self.data is None:
            data = {}
            for out, proc in self.procs.values():
                _, err = proc.communicate(timeout=600)
                assert proc.returncode == 0, err[-4000:]
                for key, val in json.loads(out.read_text()).items():
                    data.setdefault(key, {}).update(val)
            self.data = data
        return self.data

    def close(self):
        for _, proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    ref = _Reference(tmp_path_factory.mktemp("ref_hw"))
    yield ref
    ref.close()


class _PortDesigns:
    """The port's designs and allocations, each computed once per module
    (a fixture's object)."""

    def __init__(self):
        self.designs, self.allocs = {}, {}

    def design(self, label):
        """The design for a COMPILE_CASES label."""
        if label not in self.designs:
            app, where, t = COMPILE_CASES[label]
            if where == "sim":
                uf, T, _ = SIM_CASES[app]()
            else:
                uf, T = PIPELINES[app](), Fraction(t)
            self.designs[label] = compile_pipeline(uf, T=T)
        return self.designs[label]

    def conv(self, T):
        return self.design("convolution_paper" if T == 1 else
                           f"convolution_T{T}".replace("/", "_"))

    def sim(self, app):
        return self.design(f"{app}_sim")

    def sim_solver(self, app):
        """The app's sim_case compiled with fifo_solver="sim"."""
        key = f"{app}_fifo_sim"
        if key not in self.designs:
            uf, T, _ = SIM_CASES[app]()
            self.designs[key] = compile_pipeline(
                uf, T=T, options=CompileOptions(fifo_solver="sim",
                                                device="cpu"))
        return self.designs[key]

    def alloc(self, app, frames):
        """allocate_fifos over ``frames`` frames on the app's sim_case
        design; the 2-frame one is what fifo_solver="sim" ran (its
        sim_frames is 2)."""
        if (app, frames) not in self.allocs:
            if frames == 2:
                (self.allocs[app, 2],) = self.sim_solver(app)._hwsim
            else:
                self.allocs[app, frames] = allocate_fifos(
                    self.sim(app), frames=frames, device="cpu")
        return self.allocs[app, frames]


@pytest.fixture(scope="module")
def port():
    return _PortDesigns()


# ---- the port alone: the reference's system tests (fig. 9 and §7) ----


@pytest.mark.parametrize("T", sorted(PAPER_CONV))
def test_convolution_matches_paper_fig9(T, port):
    d = port.conv(T)
    t_eff, cycles = PAPER_CONV[T]
    assert abs(float(d.T) - t_eff) < 0.01, (float(d.T), t_eff)
    assert abs(d.cycles_per_frame() - cycles) / cycles < 0.011
    assert d.check_schedule()


def test_conv_resource_scaling_near_linear(port):
    """Paper fig. 10: compute resources scale about linearly with T."""
    ratio = port.conv(Fraction(4)).resources.clbs / port.conv(1).resources.clbs
    assert 3.0 < ratio < 5.0, ratio


def test_auto_fifo_overhead_vs_manual(port):
    """Paper §7.3 / fig. 11: automatic FIFO allocation costs BRAM against
    the manual one (the DMA absorbs pad/crop bursts); compute costs the
    same."""
    auto = port.conv(1)
    manual = compile_pipeline(
        Convolution(), T=Fraction(1),
        options=CompileOptions(manual_fifo_overrides={"crop": 0, "pad": 0}))
    assert auto.resources.brams > manual.resources.brams
    assert auto.resources.brams <= 4 * manual.resources.brams
    assert abs(auto.resources.clbs - manual.resources.clbs) < 32


def test_solver_modes_agree(port):
    """z3 (here the exact LP it falls back to) and the LP give equal
    totals."""
    lp = compile_pipeline(Convolution(), T=Fraction(1),
                          options=CompileOptions(fifo_solver="lp"))
    assert port.conv(1).fifo.total_bits == lp.fifo.total_bits


def test_compiled_design_runs_bit_exact_on_every_backend():
    conv = Convolution(w=64, h=32)
    d = compile_pipeline(conv, T=Fraction(1),
                         options=CompileOptions(backend="numpy"))
    img = np.random.RandomState(0).randint(0, 256, (32, 64)).astype(np.int64)
    want = golden_convolution(img, conv.kernel)
    assert np.array_equal(d.run({"convolution.in": img}), want)
    for backend in ("torch", "kernels"):
        assert np.array_equal(d.run({"convolution.in": img},
                                    backend=backend, device="cpu"), want)


def test_stereo_static_interface():
    d = compile_pipeline(Stereo(w=64, h=16, nd=8), T=Fraction(1, 2))
    assert d.kind == "Static"
    assert d.check_schedule()


# ---- the port alone: the reference's schedule properties ----

# smaller than the sim cases: the scalar engine steps every module
SIZES = {
    "convolution": dict(w=48, h=20),
    "stereo": dict(w=32, h=12, nd=8),
    "flow": dict(w=24, h=12),
    "descriptor": dict(w=32, h=24, n_features=16, filter_burst=64),
}


@pytest.mark.parametrize("name", sorted(SIZES))
def test_apps_analytic_bound_is_dynamically_sufficient(name):
    """The solver's depths impose no slowdown: a frame takes as long under
    the analytic allocation as with unbounded FIFOs, and no FIFO's
    simulated high-water mark exceeds its analytic capacity."""
    uf, T, _ = SIM_CASES[name](**SIZES[name])
    design = compile_pipeline(uf, T=T)
    bounded = simulate(design, device="cpu")
    free = simulate(design, unbounded=True, device="cpu")
    assert bounded.engine == free.engine == "scalar"
    assert bounded.deadlock is None
    assert bounded.cycles == free.cycles
    ana = design.fifo.depth
    for key, need in bounded.occupancy.needed_depth_by_key().items():
        assert need <= ana[key]


def test_pyramid_analytic_bound_covers_reconvergent_diamond():
    """The cross-arm broadcast residue (analysis/traces.py) provisions
    PYRAMID's reconvergent Downsample/Upsample diamond: the analytic
    allocation completes one frame and three without deadlock."""
    uf, T, _ = SIM_CASES["pyramid"]()
    design = compile_pipeline(uf, T=T)
    assert simulate(design, device="cpu").deadlock is None
    assert any("cross-arm broadcast residue" in n for n in design.notes)
    assert simulate(design, frames=3, device="cpu").deadlock is None


def test_zero_latency_chain_needs_no_buffering_and_runs_at_full_rate():
    n = 6
    edges = [buf.Edge(i, i + 1, token_bits=8, src_latency=0, src_burst=0)
             for i in range(n - 1)]
    sol = buf.solve_buffers(n, edges, solver="lp")
    assert sol.total_bits == 0 and sol.start == [0] * n
    n_mods, n_tok = 5, 40
    mods = [_SimMod(i, f"m{i}", "Map", Fraction(1), 0, n_tok, False)
            for i in range(n_mods)]
    sim_edges = []
    for i in range(n_mods - 1):
        e = _SimEdge(i, (i, i + 1), cap=1, token_bits=8)
        sim_edges.append(e)
        mods[i].out_edges.append(e)
        mods[i + 1].in_edges.append((e, _need_proportional(n_tok, n_tok)))
        mods[i + 1].consumed.append(0)
    res = CycleSim(mods, sim_edges).run()
    assert res.deadlock is None and res.cycles <= n_tok + n_mods
    assert all(e.needed_depth == 0 for e in res.occupancy.per_edge)


def _diamond(depth_fast):
    lat, n_tok = 10, 60
    f = _SimMod(0, "fanout", "FanOut", Fraction(1), 0, n_tok, False)
    m = _SimMod(1, "slow", "Map", Fraction(1), lat, n_tok, False)
    j = _SimMod(2, "join", "Map", Fraction(1), 0, n_tok, False)
    e_fast = _SimEdge(0, (0, 2), cap=None if depth_fast is None
                      else depth_fast + 1, token_bits=8)
    e_in = _SimEdge(1, (0, 1), cap=2, token_bits=8)
    e_slow = _SimEdge(2, (1, 2), cap=2, token_bits=8)
    f.out_edges.extend([e_fast, e_in])
    m.in_edges.append((e_in, _need_proportional(n_tok, n_tok)))
    m.consumed.append(0)
    m.out_edges.append(e_slow)
    for e in (e_fast, e_slow):
        j.in_edges.append((e, _need_proportional(n_tok, n_tok)))
        j.consumed.append(0)
    return CycleSim([f, m, j], [e_fast, e_in, e_slow]).run()


def test_fanout_reconvergence_slack_is_the_simulated_mark():
    """The analytic slack lands on the fast edge of a reconvergent fan-out,
    and it is exactly the simulated high-water mark there; less depth
    loses throughput."""
    lat = 10
    sol = buf.solve_buffers(3, [buf.Edge(0, 2, 8, 0, 0),
                                buf.Edge(0, 1, 8, 0, 0),
                                buf.Edge(1, 2, 8, lat, 0)], solver="lp")
    assert sol.depth[(0, 2)] == lat and sol.depth[(1, 2)] == 0
    free, exact, starved = _diamond(None), _diamond(lat), _diamond(lat // 2)
    fast = [e for e in free.occupancy.per_edge if e.key == (0, 2)][0]
    assert fast.needed_depth == lat
    assert exact.deadlock is None and exact.cycles == free.cycles
    assert starved.deadlock is None and starved.cycles > exact.cycles


def test_trace_fits_bound_the_border_bursts():
    for cum, R in ((sched.crop_trace(16, 12, 3, 2, 2, 1), None),
                   (sched.downsample_trace(12, 8, 2, 2), Fraction(1, 4))):
        R = R or Fraction(int(cum[-1]), 16 * 12)
        L, B = sched.fit_LB(cum, R)
        model = sched.trace(R, L, 0, np.arange(len(cum), dtype=np.int64))
        assert np.all(model <= cum) and np.all(cum - model <= B)
    need = sched.pad_need_trace(2, 2, 1, 1, 1, 1)
    assert need.tolist() == [0, 0, 0, 0, 0, 1, 2, 2, 2, 3, 4, 4,
                             4, 4, 4, 4]


# ---- the port alone: rigel's lane selection and FIFO costs ----


def test_valid_lane_counts_and_optimize_lanes():
    cands = valid_lane_counts(4, 6, 2)
    assert {1, 2, 4} <= set(cands)
    assert {4 * d for d in (1, 2, 3, 6)} <= set(cands)
    assert 4 * 6 * 2 in cands
    assert optimize_lanes(1, 1920, 1080, Fraction(3)) == (3, 1)
    v, rate = optimize_lanes(1, 1936, 8, Fraction(5))
    assert v == 5 and rate == 1
    assert ScheduleType(UInt(8), 1936, 8, 1, v).tokens_per_frame * v \
        >= 1936 * 8
    assert optimize_lanes(1, 1936, 8, Fraction(9, 2)) == (5, Fraction(9, 10))
    assert optimize_lanes(64, 10, 10, Fraction(3)) == (4, Fraction(3, 4))
    assert optimize_lanes(1, 4, 2, Fraction(100)) == (8, 1)
    for req in (Fraction(1, 7), Fraction(2), Fraction(11, 3), Fraction(13)):
        assert optimize_lanes(1, 14, 3, req)[1] <= 1


def test_fifo_resources_srl_vs_bram_boundary():
    srl, bram = fifo_resources(32, 16), fifo_resources(33, 16)
    assert srl.bram_bits == 0 and srl.luts == 16
    assert bram.bram_bits == 64 * 16
    assert fifo_resources(0, 16).luts == 0


# ---- the port alone: the solvers' properties (hypothesis) ----


@st.composite
def dags(draw):
    n = draw(st.integers(3, 12))
    edges = []
    for dst in range(1, n):
        n_in = draw(st.integers(1, min(3, dst)))
        srcs = draw(st.lists(st.integers(0, dst - 1), min_size=n_in,
                             max_size=n_in, unique=True))
        for src in srcs:
            edges.append(buf.Edge(src, dst,
                                  token_bits=draw(st.integers(1, 64)),
                                  src_latency=draw(st.integers(0, 50)),
                                  src_burst=draw(st.integers(0, 10))))
    return n, edges


@given(dags())
@settings(max_examples=40, deadline=None)
def test_buffer_solution_feasible_and_optimal(d):
    n, edges = d
    z3_sol = buf.solve_buffers(n, edges, solver="z3")
    lp_sol = buf.solve_buffers(n, edges, solver="lp")
    asap = buf.solve_buffers(n, edges, solver="asap")
    assert all(s >= 0 for s in z3_sol.start) and min(z3_sol.start) == 0
    assert z3_sol.total_bits == lp_sol.total_bits <= asap.total_bits


@given(st.integers(1, 8), st.integers(1, 8), st.integers(0, 30),
       st.integers(0, 10))
@settings(max_examples=60, deadline=None)
def test_fit_recovers_model_trace(num, den, L, s):
    R = Fraction(min(num, den), den)
    actual = sched.trace(R, L, s, np.arange(L + s + 200, dtype=np.int64))
    L_fit, B_fit = sched.fit_LB(actual, R)
    assert B_fit == 0
    assert L_fit == L + s or actual[-1] == 0


@given(st.integers(1, 6), st.integers(2, 8), st.integers(0, 20),
       st.lists(st.integers(0, 3), min_size=20, max_size=120))
@settings(max_examples=40, deadline=None)
def test_fit_bounds_any_trace(num, den, L, bursts):
    R = Fraction(min(num, den), den)
    actual = np.cumsum(np.asarray(bursts, dtype=np.int64))
    L_fit, B_fit = sched.fit_LB(actual, R)
    model = sched.trace(R, L_fit, 0, np.arange(len(actual), dtype=np.int64))
    assert np.all(model <= actual) and np.all(actual - model <= B_fit)


def test_finish_cycle_closed_form():
    R, L, s, n = Fraction(3, 7), 11, 4, 1000
    tc = sched.finish_cycle(R, L, s, n)
    tr = sched.trace(R, L, s, np.arange(tc + 2, dtype=np.int64))
    assert tr[tc] >= n and tr[tc - 1] < n


# ---- options, backends and reports ----


def test_options_are_validated():
    for bad in (dict(backend="pallas"), dict(fifo_solver="milp"),
                dict(sim_frames=0), dict(sim_guard=-1)):
        with pytest.raises(ValueError):
            CompileOptions(**bad)
    assert SimOptions(engine="vector", device="cpu").engine == "vector"
    with pytest.raises(ValueError, match="want auto, scalar, or vector"):
        SimOptions(engine="xla")
    with pytest.raises(ValueError):
        SimOptions(frames=0)
    with pytest.raises(TypeError):
        compile_pipeline(Stereo(w=16, h=4, nd=4), fifo_solver="lp")


def test_auto_engine_is_the_kernel_on_cuda(port, monkeypatch):
    """With no device the default engine is the cycle kernel: "auto"
    resolves to "vector" on "cuda" (the kernel's launch is stubbed here:
    there is no card), and so do ``optimize_fifos`` and
    ``fifo_solver="sim"``'s allocation."""
    seen, run = [], VectorSim.run

    def kernel_run(self, max_cycles=None, event_jump=True):
        seen.append(self.device)
        plain = self.with_caps(self.cap)
        plain.device = "cpu"
        return run(plain, max_cycles, event_jump)

    d = port.design("pyramid_sim")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(VectorSim, "run", kernel_run)
    res = d.simulate()
    assert res.engine == "vector" and seen == ["cuda"]
    assert res.edge_signature() == simulate(d, engine="scalar") \
        .edge_signature()
    assert d.optimize_fifos().proven
    assert seen == ["cuda"] * 3


def test_auto_engine_is_scalar_on_the_cpu(port):
    d = port.design("stereo_sim")
    assert d.simulate(options=SimOptions(device="cpu")).engine == "scalar"
    assert simulate(d, device="cpu").engine == "scalar"
    # sampling is scalar-only, on any device
    assert d.simulate(sample_every=64).occupancy.samples
    alloc = d.optimize_fifos(options=SimOptions(device="cpu"))
    assert alloc.baseline.engine == alloc.verified.engine == "scalar"


def test_vector_engine_on_the_cpu_runs_the_plain_version(port):
    d = port.design("pyramid_sim")
    got = d.simulate(options=SimOptions(engine="vector", device="cpu"))
    ref = simulate(d, engine="scalar")
    assert got.engine == "vector" and got.deadlock is None
    assert got.edge_signature() == ref.edge_signature()
    assert (got.cycles, got.frame_ends) == (ref.cycles, ref.frame_ends)


def test_numpy_backend_is_the_executor_on_the_host():
    uf, inputs = BENCH_CASES["stereo"]()
    d = compile_pipeline(uf, options=CompileOptions(backend="numpy"))
    rng = np.random.RandomState(3)
    one, batch = inputs(rng), inputs(rng, frames=2)
    assert np.array_equal(d.run(one), evaluate(d.out_val, one))
    got = d.run_batch(batch)
    for f in range(2):
        frame = {k: tuple(e[f] for e in v) for k, v in batch.items()}
        assert np.array_equal(got[f], evaluate(d.out_val, frame))
    with pytest.raises(ValueError, match="lowering backend"):
        d.run_batch_device(batch)
    with pytest.raises(ValueError, match="no lowering"):
        d.lower()
    assert not d._lowered


def test_report_shows_netlist_lowering_and_hwsim():
    d = compile_pipeline(Convolution(w=48, h=20))
    d.run({"convolution.in": np.zeros((20, 48), np.int64)}, device="cpu")
    d.optimize_fifos(options=SimOptions(device="cpu"))
    rep = d.report()
    assert rep.startswith("== convolution  T=")
    assert "cycles/frame=" in rep and "[ 10]" in rep
    assert " -- lowering backend=kernels device=cpu" in rep
    assert " -- hwsim --" in rep and "simulated allocation" in rep


# ---- the executor against the reference's ----


def _leaves(r):
    if isinstance(r, tuple):
        return [x for e in r for x in _leaves(e)]
    return [np.asarray(r)]


def _same(a, b):
    a, b = _leaves(a), _leaves(b)
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y)
        for x, y in zip(a, b))


def _mixed_float(c):
    """A Float operand mixed with an integer one in Add and Max: the
    executor computes and keeps float64."""
    class Mixed(c.UserFunction):
        def __init__(self):
            super().__init__("mixed", c.Array2d(c.UInt(8), 6, 4))

        def define(self, x):
            f = c.Map(c.ToFloat)(x)
            return c.Concat(c.Map(c.Add)(f, x), c.Map(c.Max)(x, f))

    x = np.random.RandomState(4).randint(0, 256, (2, 4, 6)).astype(np.int64)
    return Mixed(), x


def _executor_case(c, case):
    if case in BENCH_CASES:
        bench = BENCH_CASES if c is port_core else REF_BENCH_CASES
        uf, inputs = bench[case]()
        return uf, inputs(np.random.RandomState(9), frames=2)
    if case == "mixed_float":
        uf, x = _mixed_float(c)
    else:
        uf, x = point_fn_probes(c)[case]
    return uf, {f"{uf.name}.in": x}


EXECUTOR_CASES = APPS + sorted(point_fn_probes(port_core)) + ["mixed_float"]


@pytest.mark.parametrize("case", EXECUTOR_CASES)
def test_executor_matches_reference(case):
    uf, batch = _executor_case(port_core, case)
    ref_uf, _ = _executor_case(jax_core, case)
    out, ref_out = uf.build()[1], ref_uf.build()[1]
    n = next(iter(batch.values()))
    n = (n[0] if isinstance(n, tuple) else n).shape[0]
    for f in range(n):
        frame = {k: tuple(e[f] for e in v) if isinstance(v, tuple) else v[f]
                 for k, v in batch.items()}
        got, want = evaluate(out, frame), ref_evaluate(ref_out, frame)
        assert _same(got, want)
        if case == "mixed_float":
            assert [x.dtype for x in _leaves(got)] == [np.float64] * 2


# ---- the port against the reference (the subprocess's numbers) ----


@pytest.mark.parametrize("label", sorted(COMPILE_CASES))
def test_compile_matches_reference(label, reference, port):
    got = json.loads(json.dumps(_summary(port.design(label))))
    want = reference.get()["compile"][label]
    for key in want:
        assert got[key] == want[key], key
    assert got["check_schedule"]


@pytest.mark.parametrize("app,frames,unbounded", SIM_RUNS)
def test_scalar_simulator_matches_reference(app, frames, unbounded,
                                            reference, port):
    res = simulate(port.sim(app), unbounded=unbounded, frames=frames,
                   engine="scalar")
    got = json.loads(json.dumps(_sim_summary(res)))
    assert got == reference.get()["sim"][f"{app}-{frames}-{unbounded}"]
    assert res.deadlock is None


def test_scalar_simulator_diagnoses_the_reference_deadlock(reference, port):
    """PYRAMID's reconvergent diamond with every FIFO at depth 0 wedges:
    the same cycle, marks and diagnosis as the reference's."""
    d = port.sim("pyramid")
    res = simulate(d, fifo_depths={k: 0 for k in d.fifo.depth},
                   engine="scalar")
    assert "blocked on full" in res.deadlock
    got = json.loads(json.dumps(_sim_summary(res)))
    assert got == reference.get()["sim"]["pyramid-zero"]


@pytest.mark.parametrize("frames", [1, 2])
@pytest.mark.parametrize("app", APPS)
def test_allocate_fifos_matches_reference(app, frames, reference, port):
    d = port.sim(app)
    alloc = port.alloc(app, frames)
    assert alloc.frames == frames and alloc.analytic == d.fifo.depth
    got = json.loads(json.dumps(_alloc_summary(alloc, d.edges)))
    assert got == reference.get()["alloc"][f"{app}-{frames}"]
    assert alloc.proven
    assert area_units(fifo_area(alloc.depths, d.edges)) <= \
        area_units(fifo_area(alloc.analytic, d.edges))


@pytest.mark.parametrize("app", APPS)
def test_sim_fifo_solver_installs_reference_depths(app, reference, port):
    d = port.sim_solver(app)
    want = reference.get()["sim_solver"][app]
    assert json.loads(json.dumps(_summary(d))) == want["summary"]
    assert d.fifo.solver == "sim" and d.fifo_sim_proven is want["proven"]
    assert sorted([a, b, v] for (a, b), v in d.fifo_analytic.items()) \
        == want["analytic"]
    assert "analytic bits=" in d.report()


@pytest.mark.parametrize("app", APPS)
def test_area_rows_against_hand_fifo_match_reference(app, reference, port):
    uf, T, hand = SIM_CASES[app]()
    hand_design = compile_pipeline(
        uf, T=T, options=CompileOptions(manual_fifo_overrides=hand))
    row = compare(app, port.sim(app), port.alloc(app, 1), hand_design)
    got = json.loads(json.dumps(row.as_dict()))
    assert got == reference.get()["area"][app]
    r = row.ratios()
    assert r["auto_vs_hand"] >= 1.0 or not hand
    assert r["sim_vs_analytic"] <= 1.0
    assert row.deadlocks == 0 and row.throughput_unchanged
