"""The port's design-space explorer on the CPU, against the reference.

- the Pareto mechanics (dominance, skyline, ties, merge, best-at-floor,
  canonical depths), the reference's units as one parametrised test;
- ``explore_design(..., ExploreOptions(device="cpu"))`` evaluates the
  same points as the reference's explorer (every metric but
  ``cycles_skipped``, the depth sets and the hand overlay), whose
  population engine and sim-proven allocation run on its XLA loops;
- seeded determinism, ``max_points`` truncation, the engines agreeing
  with each other, the hand overlay and ratio, ``HWDesign.explore``, the
  options' validation and the CLI's ``--check``;
- with no card and no device, ``explore`` raises.

The reference's explorer imports its lowering-free jit engines through
``jax.experimental.enable_x64``, which this jax no longer has, so its
points come from a subprocess that aliases it before importing ``repro``
(as ``tests/test_torch_hw.py`` does); it starts with the module and runs
while the port-only tests do.
"""
import json
import os
import subprocess
import sys
import textwrap
from fractions import Fraction

import pytest

torch = pytest.importorskip("torch")

from repro_torch import (CompileOptions, ExploreOptions,  # noqa: E402
                         compile_pipeline)
from repro_torch.apps import EXPLORE_SPACES, SIM_CASES  # noqa: E402
from repro_torch.explore import (DesignPoint, ParetoFront,  # noqa: E402
                                 explore_design, freeze_depths)
from repro_torch.explore.__main__ import main as explore_main  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = {"convolution": dict(w=48, h=20), "flow": dict(w=24, h=12)}
# the sweeps held against the reference: one (T, solver) netlist, and the
# app's registered space cut to 10 candidates
SWEEPS = {
    "single": dict(t_ladder=("1",), solvers=("lp",), max_points=6, seed=0,
                   engine="population"),
    "space": dict(max_points=10, seed=3),
}

_REF_SCRIPT = textwrap.dedent('''
    import json, sys
    import jax, jax.experimental
    jax.experimental.enable_x64 = jax.enable_x64   # this process only
    from repro.apps import SIM_CASES
    from repro.core import ExploreOptions, compile_pipeline
    from repro.explore import explore_design

    sweeps, sizes = json.loads(sys.argv[1]), json.loads(sys.argv[2])
    uf, T, hand = SIM_CASES["flow"](**sizes["flow"])
    d = compile_pipeline(uf, T=T)
    out = {}
    for name, opts in sweeps.items():
        for k in ("t_ladder", "solvers"):
            if k in opts:
                opts[k] = tuple(opts[k])
        res = explore_design(d, ExploreOptions(**opts), hand=hand)
        out[name] = {
            "points": [dict(p.as_dict(), depths=[[list(k), v]
                                                 for k, v in p.depths])
                       for p in res.points],
            "hand": res.hand.as_dict(),
            "front": [p.label for p in res.front.points],
            "ratio": res.best_area_ratio(), "notes": res.notes}
    json.dump(out, open(sys.argv[3], "w"))
''')


def _points(res):
    """A sweep's points as plain JSON, ``cycles_skipped`` dropped: the
    reference's population counts its skipped cycles on a global clock."""
    out = []
    for p in res.points:
        d = dict(p.as_dict(), depths=[[list(k), v] for k, v in p.depths])
        d.pop("cycles_skipped")
        out.append(d)
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref_explore") / "ref.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", _REF_SCRIPT, json.dumps(SWEEPS),
         json.dumps(SIZES), str(path)], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def get():
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        return json.loads(path.read_text())
    return get


def _design(name):
    uf, T, hand = SIM_CASES[name](**SIZES[name])
    return compile_pipeline(uf, T=T), hand


@pytest.fixture(scope="module")
def flow(reference):        # the reference starts before the port works
    return _design("flow")


def _opts(engine="population", n=6, **kw):
    return ExploreOptions(t_ladder=("1",), solvers=("lp",), max_points=n,
                          seed=0, engine=engine, device="cpu", **kw)


# ---- Pareto mechanics (pure units) ----


def _pt(area, tput, completed=True, label="p"):
    return DesignPoint(
        app="unit", label=label, origin="auto", T="1", solver="lp",
        fifo_policy="analytic", area_units=area, area_clbs=area,
        area_brams=0, fifo_bits=0, throughput=tput, cycles=100,
        cycles_per_frame=100, completed=completed)


def _dominance_is_weak_with_one_strict():
    assert _pt(10, 1.0).dominates(_pt(20, 1.0))
    assert _pt(10, 2.0).dominates(_pt(10, 1.0))
    assert not _pt(10, 1.0).dominates(_pt(10, 1.0))
    assert not _pt(10, 1.0).dominates(_pt(20, 2.0))
    assert not _pt(1, 9.0, completed=False).dominates(_pt(99, 0.1))
    assert not _pt(1, 9.0).dominates(_pt(99, 0.1, completed=False))


def _front_is_the_skyline():
    pts = [_pt(10, 1.0), _pt(20, 2.0), _pt(15, 0.5), _pt(30, 2.0),
           _pt(5, 3.0, completed=False)]
    front = ParetoFront.of(pts)
    assert [(p.area_units, p.throughput) for p in front.points] == \
        [(10, 1.0), (20, 2.0)]
    assert front.dominated(_pt(25, 1.5))
    assert not front.dominated(_pt(9, 0.9))


def _front_ties_keep_first():
    a, b = _pt(10, 1.0, label="first"), _pt(10, 1.0, label="second")
    assert [p.label for p in ParetoFront.of([a, b]).points] == ["first"]


def _merge_re_sweeps():
    front = ParetoFront.of([_pt(10, 1.0), _pt(20, 2.0)])
    merged = front.merge([_pt(8, 1.5)])
    assert [(p.area_units, p.throughput) for p in merged.points] == \
        [(8, 1.5), (20, 2.0)]


def _best_at_floor_is_cheapest_qualifying():
    front = ParetoFront.of([_pt(10, 1.0), _pt(20, 2.0), _pt(40, 3.0)])
    assert front.best_at(1.5).area_units == 20
    assert front.best_at(0.1).area_units == 10
    assert front.best_at(9.0) is None


def _freeze_depths_is_canonical():
    assert freeze_depths({(1, 2): 4, (0, 1): 3}) == \
        freeze_depths({(0, 1): 3, (1, 2): 4})


@pytest.mark.parametrize("unit", [
    _dominance_is_weak_with_one_strict, _front_is_the_skyline,
    _front_ties_keep_first, _merge_re_sweeps,
    _best_at_floor_is_cheapest_qualifying, _freeze_depths_is_canonical],
    ids=lambda f: f.__name__.strip("_"))
def test_pareto_units(unit):
    unit()


# ---- the sweep ----


def test_seeded_sweep_is_deterministic(flow):
    design, hand = flow
    opts = ExploreOptions(max_points=6, seed=3, device="cpu")
    a = explore_design(design, opts, hand=hand)
    b = explore_design(design, opts, hand=hand)
    assert [p.as_dict() for p in a.points] == \
        [p.as_dict() for p in b.points]
    assert [p.depths for p in a.front.points] == \
        [p.depths for p in b.front.points]


def test_max_points_truncates_deterministically(flow):
    design, hand = flow
    big = explore_design(design, ExploreOptions(max_points=7, seed=1,
                                                device="cpu"), hand=hand)
    small = explore_design(design, ExploreOptions(max_points=4, seed=1,
                                                  device="cpu"), hand=hand)
    assert small.n_evaluated == 4 and big.n_evaluated == 7
    assert [p.as_dict() for p in small.points] == \
        [p.as_dict() for p in big.points[:4]]


def test_engines_evaluate_the_same_points(flow):
    """Population, serial vector and scalar evaluation of one candidate
    list: the same points; the two packed-state engines count the same
    skipped cycles too (each design keeps its own clock)."""
    design, hand = flow
    runs = {e: explore_design(design, _opts(e), hand=hand)
            for e in ("population", "vector", "scalar")}
    assert _points(runs["population"]) == _points(runs["vector"]) \
        == _points(runs["scalar"])
    assert [p.cycles_skipped for p in runs["population"].points] == \
        [p.cycles_skipped for p in runs["vector"].points]
    assert len(runs["population"].points) > 1


def test_hand_overlay_ratio_and_design_method(flow):
    design, _ = flow
    res = design.explore(_opts(n=4))
    assert res.n_evaluated <= 4 and res.app == design.name
    assert res.hand is not None and res.hand.origin == "hand"
    ratio = res.best_area_ratio()
    assert ratio is not None and ratio <= 1.01
    assert "hand-annotated design" in "\n".join(res.report_lines())
    d = res.as_dict()
    assert d["front"] and d["points_evaluated"] == res.n_evaluated


def test_hand_compile_uses_manual_overrides():
    design, hand = _design("convolution")
    assert hand
    res = explore_design(design, _opts(n=3), hand=hand)
    manual = compile_pipeline(
        SIM_CASES["convolution"](**SIZES["convolution"])[0], T=Fraction(1),
        options=CompileOptions(manual_fifo_overrides=hand))
    assert res.hand.fifo_bits == manual.fifo.total_bits


def test_explore_needs_provenance_options_and_a_device(flow, monkeypatch):
    import dataclasses
    design, _ = flow
    bare = dataclasses.replace(design)
    bare._uf = None
    with pytest.raises(ValueError, match="compile_pipeline"):
        explore_design(bare, _opts())
    with pytest.raises(ValueError, match="engine"):
        ExploreOptions(engine="quantum")
    with pytest.raises(ValueError, match="solver"):
        ExploreOptions(solvers=("lp", "magic"))
    with pytest.raises(ValueError, match="population"):
        ExploreOptions(population=0)
    assert sorted(EXPLORE_SPACES) == sorted(SIM_CASES)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for opts in (ExploreOptions(max_points=2),
                 ExploreOptions(max_points=2, engine="scalar")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            design.explore(opts)


def test_engine_failures_propagate_and_allocation_failures_are_noted(
        flow, monkeypatch):
    """A failure of the cycle engine (the kernel's build or launch)
    propagates out of the sweep, from the allocator's runs and from the
    evaluation alike; only the allocator's own ``AllocationError`` (a
    netlist with nothing to size) becomes a note."""
    import repro_torch.explore.engine as engine_mod
    import repro_torch.hwsim.allocate as alloc_mod
    import repro_torch.kernels.cyclesim as cyc_pkg
    design, hand = flow

    def broken(*a, **k):
        raise RuntimeError("CUDA kernel 'cyclesim' failed")

    evaluate = engine_mod._evaluate

    def hand_broken(d, depth_sets, options):
        # the sweep evaluates its 3 candidates at once, the hand point alone
        if len(depth_sets) == 1:
            broken()
        return evaluate(d, depth_sets, options)

    for where, obj, name in (("everywhere", cyc_pkg, "cycle_sim"),
                             ("allocator", alloc_mod, "simulate"),
                             ("hand point", engine_mod, "_evaluate")):
        with monkeypatch.context() as m:
            m.setattr(obj, name,
                      hand_broken if where == "hand point" else broken)
            for engine in ("population", "vector"):
                with pytest.raises(RuntimeError, match="cyclesim"):
                    explore_design(design, _opts(engine, n=3), hand=hand)

    def nothing_to_size(*a, **k):
        raise alloc_mod.AllocationError("baseline simulation deadlocked")

    monkeypatch.setattr(alloc_mod, "allocate_fifos", nothing_to_size)
    res = explore_design(design, _opts(n=3), hand=hand)
    assert any("sim-proven allocation failed" in n for n in res.notes)
    assert res.n_evaluated == 3 and res.hand is not None


def test_cli_check_passes_on_the_cpu(capsys):
    assert explore_main(["--app", "flow", "--max-points", "3",
                         "--device", "cpu", "--check", "--json"]) == 0
    out = capsys.readouterr().out
    blob = json.loads(out[:out.rindex("}") + 1])
    assert blob["flow"]["points_evaluated"] == 3
    assert "explore check passed for flow" in out


# ---- against the reference (last: its subprocess runs meanwhile) ----


@pytest.mark.parametrize("sweep", sorted(SWEEPS))
def test_explore_points_match_reference(flow, reference, sweep):
    design, hand = flow
    opts = dict(SWEEPS[sweep], device="cpu")
    res = explore_design(design, ExploreOptions(**opts), hand=hand)
    ref = reference()[sweep]
    for p in ref["points"]:
        p.pop("cycles_skipped")
    assert _points(res) == ref["points"]
    assert res.hand.as_dict() == ref["hand"]
    assert [p.label for p in res.front.points] == ref["front"]
    assert res.best_area_ratio() == ref["ratio"]
    assert res.notes == ref["notes"]
