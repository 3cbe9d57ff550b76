"""The port's packed-state cycle engines on the CPU, against the reference.

- ``VectorSim(device="cpu")``, the plain version of the cycle kernel
  (``csrc/cyclesim.cu``), gives every ``SimResult`` field equal to the
  reference's numpy path (``repro.hwsim.vector.VectorSim.run(jit=False)``),
  ``cycles_skipped`` and ``cycles_saved`` included, and the edge signature
  of the port's scalar engine: 1-3 frames, unbounded, a starved netlist,
  event jumps on and off (PYRAMID's deadlock and a stall tail), and the
  horizon with and without a frame boundary, on the reference tests' own
  sizes and the FLOW, PYRAMID and CONVOLUTION ``sim_case``s;
- ``PopulationSim(device="cpu")`` equals the reference's
  ``run(jit=False)``, result for result;
- the ingest model equals the reference's;
- the kernel's packing of a netlist (CSR lists, computed and tabulated
  needs) describes the same netlist as the plain version's;
- the engines' device rule: "auto" is the kernel on the card and the
  scalar engine on the CPU; with no card and no device they raise.

The reference's numpy path imports no jax, so it runs in this process on
the port's netlists (the port's compile equals the reference's,
``tests/test_torch_hw.py``).  The kernel itself runs on the card only
(``tests/test_torch_card.py``, ``chip_smoke.py``).
"""
import dataclasses
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.hwsim import ingest as ref_ingest  # noqa: E402
from repro.hwsim.population import PopulationSim as RefPopulationSim  # noqa
from repro.hwsim.vector import VectorSim as RefVectorSim  # noqa: E402
from repro_torch import SimOptions, compile_pipeline  # noqa: E402
from repro_torch.apps import SIM_CASES  # noqa: E402
from repro_torch.core.buffers import Edge  # noqa: E402
from repro_torch.core.dtypes import UInt  # noqa: E402
from repro_torch.core.rigel import Interface, RModule, ScheduleType  # noqa
from repro_torch.hwsim import (PopulationSim, VectorSim,  # noqa: E402
                               poisson_arrival_cycles, replay_ingest,
                               simulate_ingest)
from repro_torch.hwsim.sim import build_sim, simulate  # noqa: E402
from repro_torch.kernels.cyclesim import ops as cyc  # noqa: E402
import _cyclesim_host as cyc_host  # noqa: E402
from _torch_cases import map_chain  # noqa: E402

# the reference tests' own sizes (tests/test_hwsim.py), and the sim_cases
SIZES = {
    "flow": dict(w=24, h=12),
    "convolution": dict(w=48, h=20),
    "stereo": dict(w=32, h=12, nd=8),
    "flow_sim": {},
    "pyramid_sim": {},
    "convolution_sim": {},
    "stereo_sim": {},
    "descriptor_sim": {},
}


@pytest.fixture(scope="module")
def designs():
    out = {}
    for label, kw in SIZES.items():
        uf, T, hand = SIM_CASES[label.replace("_sim", "")](**kw)
        out[label] = compile_pipeline(uf, T=T)
    return out


def _all(res):
    """Every field of a SimResult, the reference's or the port's."""
    return dataclasses.asdict(res)


def _pair(design, depths=None, unbounded=False, frames=1, **run):
    """(port plain, reference numpy) results of one netlist."""
    depths = dict(design.fifo.depth) if depths is None else depths
    got = VectorSim(design.modules, design.edges, depths,
                    unbounded=unbounded, frames=frames,
                    device="cpu").run(**run)
    ref = RefVectorSim(design.modules, design.edges, depths,
                       unbounded=unbounded, frames=frames).run(
        jit=False, **run)
    return got, ref


def _same_as_scalar(got, design, depths=None, frames=1, **kw):
    sc = build_sim(design.modules, design.edges,
                   dict(design.fifo.depth) if depths is None else depths,
                   frames=frames, **kw).run()
    assert got.edge_signature() == sc.edge_signature()
    assert (got.cycles, got.sink_tokens, got.frame_ends, got.deadlock) == \
        (sc.cycles, sc.sink_tokens, sc.frame_ends, sc.deadlock)


@pytest.mark.parametrize("label,frames", [
    ("flow", 1), ("flow", 2), ("flow", 3), ("convolution", 1),
    ("flow_sim", 2), ("pyramid_sim", 1), ("pyramid_sim", 2),
    ("convolution_sim", 1), ("stereo_sim", 1), ("descriptor_sim", 1)])
def test_plain_vector_equals_reference_and_scalar(designs, label, frames):
    d = designs[label]
    got, ref = _pair(d, frames=frames)
    assert got.engine == "vector" and got.deadlock is None
    assert _all(got) == _all(ref)
    _same_as_scalar(got, d, frames=frames)


def test_plain_vector_unbounded_matches_reference(designs):
    d = designs["stereo"]
    got, ref = _pair(d, depths={}, unbounded=True)
    assert _all(got) == _all(ref)
    assert all(e.depth is None for e in got.occupancy.per_edge)
    _same_as_scalar(got, d, depths={}, unbounded=True)


def _starved_pair():
    def mod(name, total):
        st = ScheduleType(UInt(8), total, 1)
        return RModule(name, "Map", Interface("Static", st),
                       Interface("Static", st), Fraction(1), 0)

    return [mod("src", 5), mod("snk", 10)], [Edge(0, 1, 8, 0, 0)]


@pytest.mark.parametrize("event_jump", [True, False])
def test_plain_vector_starvation_and_stall_tail(event_jump):
    """A need table the producer can never satisfy stalls and names the
    starved module; the event jump leaps the no-progress tail in one hop,
    with the reference's counts."""
    mods, edges = _starved_pair()
    runs = []
    for cls, kw in ((VectorSim, dict(device="cpu")), (RefVectorSim, {})):
        vs = cls(mods, edges, {(0, 1): 3}, **kw)
        vs.need_buf = np.arange(1, 11, dtype=np.int64)   # need(k) = k
        runs.append(vs.run(event_jump=event_jump, **(
            {} if cls is VectorSim else dict(jit=False))))
    got, ref = runs
    assert _all(got) == _all(ref)
    assert "starved" in got.deadlock and "snk" in got.deadlock
    assert got.sink_tokens == 5
    assert (got.cycles_skipped > 0) == event_jump


@pytest.mark.parametrize("label", ["flow_sim", "pyramid_sim"])
def test_plain_vector_event_jump_off_matches(designs, label):
    d = designs[label]
    got, ref = _pair(d, frames=2, event_jump=False)
    assert _all(got) == _all(ref)
    assert got.cycles_skipped == 0 and got.cycles_saved == 0
    _same_as_scalar(got, d, frames=2)


@pytest.mark.parametrize("event_jump", [True, False])
def test_plain_vector_pyramid_deadlock_path(designs, event_jump):
    """A zero-depth residue edge wedges PYRAMID's diamond: the same
    diagnosis, cycles and signature as the reference and the scalar
    engine; the jump skips the dead tail and reports it as saved."""
    d = designs["pyramid_sim"]
    depths = dict(d.fifo.depth)
    depths[(6, 1)] = 0
    got, ref = _pair(d, depths=depths, event_jump=event_jump)
    assert got.deadlock is not None
    assert _all(got) == _all(ref)
    _same_as_scalar(got, d, depths=depths)
    assert (got.cycles_saved > 0) == event_jump


def test_plain_vector_horizon(designs):
    d = designs["flow"]
    got, ref = _pair(d, max_cycles=40)
    assert got.deadlock == "horizon exceeded (40 cycles)"
    assert got.cycles == 40 and _all(got) == _all(ref)


def test_plain_vector_horizon_on_frame_boundary_keeps_frame_end(designs):
    d = designs["convolution"]
    full = simulate(d, engine="scalar", frames=2)
    horizon = full.frame_ends[0] + 1
    got, ref = _pair(d, frames=2, max_cycles=horizon)
    sc = simulate(d, engine="scalar", frames=2, max_cycles=horizon)
    assert got.frame_ends == sc.frame_ends == [full.frame_ends[0]]
    assert _all(got) == _all(ref)
    assert got.edge_signature() == sc.edge_signature()


def test_plain_population_matches_reference_serial(designs):
    d = designs["flow"]
    ana = dict(d.fifo.depth)
    variants = [ana, {k: v * 2 for k, v in ana.items()},
                {k: 0 for k in ana}]
    got = PopulationSim(d.modules, d.edges, variants, frames=2,
                        device="cpu").run()
    ref = RefPopulationSim(d.modules, d.edges, variants, frames=2).run(
        jit=False)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert g.engine == "population-serial"
        assert _all(g) == _all(r)


def test_plain_population_runs_through_the_kernels_wrapper(designs,
                                                           monkeypatch):
    """On the CPU a population is one call of the cycle kernel's wrapper,
    which routes the CPU capacities to the plain version (no serial loop
    of its own around it)."""
    import repro_torch.kernels.cyclesim as cyc_pkg
    calls = []
    wrapped = cyc_pkg.cycle_sim

    def counted(sim, caps, *a, **k):
        calls.append(tuple(caps.shape))
        return wrapped(sim, caps, *a, **k)

    monkeypatch.setattr(cyc_pkg, "cycle_sim", counted)
    d = designs["flow"]
    ana = dict(d.fifo.depth)
    variants = [ana, {k: v + 1 for k, v in ana.items()}]
    got = PopulationSim(d.modules, d.edges, variants, device="cpu").run()
    assert calls == [(2, len(d.edges))]
    singles = [VectorSim(d.modules, d.edges, v, device="cpu").run()
               for v in variants]
    assert [_all(g) | {"engine": 0} for g in got] == \
        [_all(s) | {"engine": 0} for s in singles]


def test_diagnosis_reads_needs_without_the_full_table(designs):
    """A stalled run's diagnosis computes each edge's need from its spec
    (the reference's text) and leaves the full need table unbuilt; only a
    table set by hand marks the netlist as hand-tabulated, which the
    kernel's packing then ships whole."""
    d = designs["pyramid_sim"]
    depths = dict(d.fifo.depth)
    depths[(6, 1)] = 0
    got, ref = _pair(d, depths=depths)
    assert got.deadlock is not None and got.deadlock == ref.deadlock
    fresh = VectorSim(d.modules, d.edges, depths, device="cpu")
    state = fresh.with_caps(fresh.cap)._run_plain(
        fresh._default_horizon(), fresh._stall_limit())[0]
    fresh = VectorSim(d.modules, d.edges, depths, device="cpu")
    assert fresh._diagnose(state) == ref.deadlock
    assert fresh._need_buf is None and not fresh.need_by_hand
    fresh.need_buf                       # built lazily: not by hand
    assert not fresh.need_by_hand
    off, _buf = cyc._need_tables(fresh)
    assert (off < 0).any()               # proportional needs computed
    fresh.need_buf = fresh.need_buf.copy()
    assert fresh.need_by_hand
    off, buf = cyc._need_tables(fresh)
    assert np.array_equal(off, fresh.need_off) and buf is fresh.need_buf


def test_cycle_check_cli_on_the_cpu(capsys):
    """``python -m repro_torch.launch.cycle_check`` with ``--device cpu``:
    the plain version through ``simulate()`` against the scalar engine in
    a worker process, every shared field equal."""
    import json
    from repro_torch.launch import cycle_check
    assert cycle_check.main(["--apps", "pyramid", "--size", "sim_case",
                             "--device", "cpu"]) == 0
    row = json.loads(capsys.readouterr().out.splitlines()[0])
    assert row["equal"] and row["max_abs_err"] == 0
    assert row["cycles"] == row["scalar_cycles"] == 2055
    assert row["deadlock"] is None and row["shape"] == [32, 64]


def test_ingest_matches_reference():
    assert np.array_equal(poisson_arrival_cycles(64, 12.5, seed=3),
                          ref_ingest.poisson_arrival_cycles(64, 12.5, seed=3))
    for args in ((200, 32, Fraction(1, 24), 8, 1),
                 (120, 40, Fraction(1, 48), 4, 2)):
        got = simulate_ingest(*args[:4], seed=args[4])
        ref = ref_ingest.simulate_ingest(*args[:4], seed=args[4])
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
        assert got.report_lines() == ref.report_lines()
    burst = [0, 0, 0, 1, 1, 400, 401, 402]
    got = replay_ingest(burst, Fraction(1, 30), 3)
    ref = ref_ingest.replay_ingest(burst, Fraction(1, 30), 3)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.source == "trace"
    with pytest.raises(ValueError, match="capacity"):
        replay_ingest(burst, Fraction(1, 30), 0)


def test_kernel_packing_describes_the_netlist(designs):
    """The kernel's packing (kernels/cyclesim/ops.py), built on the CPU:
    each module's int32 CSR out- and in-edges are its edges, each module's
    ring starts at the word-aligned prefix sum of ``leff + 1`` bits, and
    every edge's need, tabulated or stepped by its packed quotient and
    remainder, is the plain version's table for every k, on every app."""
    for label in SIZES:
        d = designs[label]
        vs = VectorSim(d.modules, d.edges, dict(d.fifo.depth), frames=2,
                       device="cpu")
        net = {k: v.numpy() for k, v in
               cyc.pack(vs, torch.device("cpu")).items()}
        for key in ("out_ptr", "out_idx", "in_ptr", "in_idx"):
            assert net[key].dtype == np.int32
        for m in range(vs.M):
            outs = net["out_idx"][net["out_ptr"][m]:net["out_ptr"][m + 1]]
            ins = net["in_idx"][net["in_ptr"][m]:net["in_ptr"][m + 1]]
            assert list(outs) == list(np.flatnonzero(vs.src == m))
            assert list(ins) == list(np.flatnonzero(vs.dst == m))
        mod = dict(zip(cyc.MOD_FIELDS, net["mod"].T))
        assert np.array_equal(mod["leff"], vs.leff)
        bits = np.concatenate([[0], np.cumsum(-(-(vs.leff + 1) // 64) * 64)])
        assert np.array_equal(mod["ring"] * 64, bits[:-1]), label
        assert cyc.ring_offsets(vs.leff)[1] * 64 == bits[-1]
        edge = dict(zip(cyc.EDGE_FIELDS, net["edge"].T))
        profiled = 0
        for e in range(vs.E):
            k = np.arange(1, vs.ot[e] + 1)
            if edge["need_off"][e] >= 0:
                profiled += 1
                got = net["need_buf"][edge["need_off"][e] + k - 1]
            else:
                tpf, ot = edge["tpf"][e], edge["ot"][e]
                qs, rs = edge["qstep"][e], edge["rstep"][e]
                assert qs * ot + rs == tpf and 0 <= rs < ot
                # the kernel's step: q, r += qs, rs; r wraps past ot
                q, r = np.empty(len(k), np.int64), np.empty(len(k), np.int64)
                q[0], r[0] = qs, rs
                for i in range(1, len(k)):
                    q[i], r[i] = q[i - 1] + qs, r[i - 1] + rs
                    if r[i] >= ot:
                        q[i], r[i] = q[i] + 1, r[i] - ot
                got = np.minimum(tpf, q + (r > 0))
            want = vs.need_buf[vs.need_off[e] + k - 1]
            assert np.array_equal(got, want), (label, e)
        assert profiled == sum(s.profile is not None for s in vs.specs)
        if label == "convolution":
            assert profiled > 0              # Pad and Crop are tabulated
    # the warp form where a lane holds at most 3 modules and 3 edges, the
    # block form past that (modules over the block's threads)
    assert cyc.threads_for(58, 73) == 32 and cyc.warp_slots(58, 73) == (2, 3)
    assert cyc.warp_slots(96, 96) == (3, 3) and cyc.warp_slots(97, 8) is None
    assert cyc.threads_for(300, 299) == 256 and cyc.warp_slots(1, 700) is None
    assert cyc.threads_for(1, 700) == 32 and cyc.form_for(1, 700) == "block"
    assert cyc.smem_bytes(58, 73, 100, "warp", True) == 800
    assert cyc.smem_bytes(58, 73, 100, "warp", False) == 0
    assert cyc.smem_bytes(58, 73, 100, "block", True) == \
        8 * (12 * 73 + 4 * 58 + 1 + 31) + 800


def test_engine_resolution_by_device(designs, monkeypatch):
    d = designs["flow"]
    assert simulate(d, device="cpu").engine == "scalar"
    assert d.simulate(options=SimOptions(device="cpu")).engine == "scalar"
    vec = d.simulate(options=SimOptions(engine="vector", device="cpu"))
    assert vec.engine == "vector"
    assert vec.edge_signature() == simulate(d, engine="scalar") \
        .edge_signature()
    assert d.simulate(sample_every=64).engine == "scalar"
    with pytest.raises(ValueError, match="sampling"):
        d.simulate(sample_every=64,
                   options=SimOptions(engine="vector", device="cpu"))
    with pytest.raises(ValueError, match="engine"):
        SimOptions(engine="quantum")
    alloc = d.optimize_fifos(options=SimOptions(frames=2, device="cpu"))
    assert alloc.proven and alloc.baseline.engine == "scalar"
    with pytest.raises(ValueError, match="device"):
        VectorSim(d.modules, d.edges, {}, device="meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: VectorSim(d.modules, d.edges, {}),
                 lambda: VectorSim(d.modules, d.edges, {}, device="cuda"),
                 lambda: PopulationSim(d.modules, d.edges, [{}]),
                 lambda: simulate(d),
                 lambda: d.simulate(),
                 lambda: d.optimize_fifos(),
                 lambda: simulate(d, engine="vector")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_cycle_kernel_wrapper_routes_by_device(designs):
    """A CPU ``caps`` takes the plain version; any other device raises;
    malformed capacities are refused before any launch."""
    d = designs["flow"]
    vs = VectorSim(d.modules, d.edges, dict(d.fifo.depth), device="cpu")
    caps = torch.from_numpy(np.stack([vs.cap, vs.cap * 2]))
    runs = cyc.cycle_sim(vs, caps, 10_000, vs._stall_limit())
    assert [s["t"] for s, _, code in runs] == \
        [vs.run().cycles, vs.with_caps(vs.cap * 2).run().cycles]
    assert all(code is None for _, _, code in runs)
    with pytest.raises(ValueError, match="int64"):
        cyc.cycle_sim(vs, caps.int(), 100, 10)
    with pytest.raises(ValueError, match="device"):
        cyc.cycle_sim(vs, caps.to("meta"), 100, 10)


# ---- the kernel's source built on the host (tests/_cyclesim_host.py) ----


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    if not cyc_host.available():
        pytest.skip("needs g++ to build the kernel's source on the host")
    return cyc_host.build(tmp_path_factory.mktemp("cyclesim_host"))


def _host_case(designs, case):
    """(VectorSim on the CPU, capacity rows, run keywords) of a case."""
    kw = dict(event_jump=True, max_cycles=None)
    if case.startswith("flow_sim"):
        d = designs["flow_sim"]
        vs = VectorSim(d.modules, d.edges, dict(d.fifo.depth), frames=2,
                       device="cpu")
        kw["event_jump"] = not case.endswith("nojump")
    elif case.startswith("pyramid_deadlock"):
        d = designs["pyramid_sim"]
        depths = dict(d.fifo.depth)
        depths[(6, 1)] = 0
        vs = VectorSim(d.modules, d.edges, depths, device="cpu")
        kw["event_jump"] = not case.endswith("nojump")
    elif case == "convolution_frame_boundary":
        d = designs["convolution"]
        vs = VectorSim(d.modules, d.edges, dict(d.fifo.depth), frames=2,
                       device="cpu")
        kw["max_cycles"] = vs.run().frame_ends[0] + 1
    elif case == "flow_first_cycles":
        d = designs["flow_sim"]
        vs = VectorSim(d.modules, d.edges, dict(d.fifo.depth), device="cpu")
        kw["max_cycles"] = 343
    elif case == "stereo_unbounded":
        d = designs["stereo"]
        vs = VectorSim(d.modules, d.edges, {}, unbounded=True, device="cpu")
    elif case == "hand_table":
        mods, edges = _starved_pair()
        vs = VectorSim(mods, edges, {(0, 1): 3}, device="cpu")
        vs.need_buf = np.arange(1, 11, dtype=np.int64)
    elif case.startswith("ring_word_edges"):
        mods, edges, depths = map_chain((63, 64, 65, 0, 63, 64, 65, 1),
                                        total=4,
                                        rates=(Fraction(1), Fraction(1, 2)))
        vs = VectorSim(mods, edges, depths, frames=2, device="cpu")
        kw["event_jump"] = not case.endswith("nojump")
    elif case == "wrap_jump":
        mods, edges, depths = map_chain((0, 100, 0), total=1)
        vs = VectorSim(mods, edges, depths, device="cpu")
    elif case == "slow_consumer":
        mods, edges, depths = map_chain(
            (0, 3, 0), total=8, depth=1,
            rates=(Fraction(1), Fraction(1), Fraction(1, 50)))
        vs = VectorSim(mods, edges, depths, device="cpu")
    elif case == "wide_counters":
        # 2**16 tokens a frame over 2**15 + 1 frames: a module's count
        # passes int32, so the warp form counts in 64 bits; the horizon
        # cuts the run
        mods, edges, depths = map_chain((0, 2, 0, 1), total=2 ** 16,
                                        rates=(Fraction(1), Fraction(1, 2)))
        vs = VectorSim(mods, edges, depths, frames=2 ** 15 + 1,
                       device="cpu")
        kw["max_cycles"] = 300
    elif case == "population":
        d = designs["flow_sim"]
        ana = dict(d.fifo.depth)
        vs = VectorSim(d.modules, d.edges, ana, frames=2, device="cpu")
        rows = [vs.cap] + [np.maximum(1, (vs.cap - 1) * f // 4 + 1)
                           for f in (0, 2, 7)]
        return vs, np.stack(rows), kw
    else:
        raise KeyError(case)
    return vs, vs.cap[None], kw


HOST_CASES = ["flow_sim_2f", "flow_sim_2f_nojump", "pyramid_deadlock",
              "pyramid_deadlock_nojump", "convolution_frame_boundary",
              "flow_first_cycles", "stereo_unbounded", "hand_table",
              "ring_word_edges", "ring_word_edges_nojump", "wrap_jump",
              "slow_consumer", "wide_counters", "population"]


def _kernel_vs_plain(fn, vs, caps, form, event_jump, max_cycles):
    """Every SimResult field of the host-built kernel's runs against the
    plain version's, row by row."""
    horizon = max_cycles or vs._default_horizon()
    stall = vs._stall_limit()
    caps = torch.from_numpy(np.ascontiguousarray(caps, np.int64))
    got = cyc_host.host_cycle_sim(fn, vs, caps, horizon, stall, event_jump,
                                  form=form)
    want = cyc.cycle_sim_ref(vs, caps, horizon, stall, event_jump)
    assert len(got) == len(want) == len(caps)
    results = []
    for row, g, w in zip(caps.numpy(), got, want):
        rg, rw = (vs._result(*x, horizon, cap=row) for x in (g, w))
        assert _all(rg) == _all(rw)
        results.append(rg)
    return results


@pytest.mark.parametrize("form", ["warp", "block"])
@pytest.mark.parametrize("case", HOST_CASES)
def test_kernel_source_on_the_host_matches_plain(designs, host_kernel,
                                                 case, form):
    """The CUDA source's warp and block forms, built as host C++ with a
    host thread per CUDA thread, against the plain version: frames,
    jumps on and off, a deadlock, a horizon on a frame boundary and in the
    first cycles (t < leff), no capacity bound, a hand-set need table,
    latencies at the ring words' edges (63, 64, 65), a maturation found
    across the ring's wrap, a producer blocked by a slow consumer while
    jumps longer than its latency pass (its matured launches counted
    once), counts past int32 (the warp form's 64-bit counters), and four
    designs in one launch."""
    vs, caps, kw = _host_case(designs, case)
    res = _kernel_vs_plain(host_kernel, vs, caps, form, **kw)
    if case == "wrap_jump":
        # one token launched at cycle 1 matures at 101: the jump from
        # cycle 3 finds its bit past the ring's end (position 1 < p = 3)
        assert res[0].cycles_skipped == 98 and res[0].deadlock is None
    if case.startswith("ring_word_edges"):
        assert (res[0].cycles_skipped > 0) == kw["event_jump"]
    if case == "slow_consumer":
        assert res[0].cycles_skipped > 300 and res[0].sink_tokens == 8
    assert cyc.counter_bits(vs) == (64 if case == "wide_counters" else 32)


@pytest.mark.parametrize("form", ["warp", "block"])
def test_kernel_source_global_ring_on_the_host(designs, host_kernel,
                                               monkeypatch, form):
    """With no shared memory to spare the rings go to global memory (the
    kernel's other template form), with the same results."""
    monkeypatch.setattr(cyc, "SMEM_LIMIT", 0)
    vs, caps, kw = _host_case(designs, "ring_word_edges")
    assert cyc.layout(vs, form)["ring"] == "global"
    _kernel_vs_plain(host_kernel, vs, caps, form, **kw)
    vs, caps, kw = _host_case(designs, "flow_sim_2f")
    _kernel_vs_plain(host_kernel, vs, caps, form, **kw)


def test_kernel_source_block_form_on_a_long_chain(host_kernel):
    """300 modules are past the warp form: the block form, modules over
    256 threads with a block stride, throttled and latent."""
    rates = (Fraction(1), Fraction(1, 2), Fraction(1), Fraction(2, 3))
    mods, edges, depths = map_chain([i % 7 for i in range(300)],
                                    rates=rates)
    vs = VectorSim(mods, edges, depths, frames=2, device="cpu")
    assert cyc.layout(vs) == dict(cyc.layout(vs, "block"), threads=256)
    with pytest.raises(ValueError, match="warp form"):
        cyc.layout(vs, "warp")
    (res,) = _kernel_vs_plain(host_kernel, vs, vs.cap[None], None, True,
                              None)
    assert res.deadlock is None and res.sink_tokens == 96
