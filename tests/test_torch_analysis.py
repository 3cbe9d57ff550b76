"""The port's static verifier (``repro_torch.analysis``: ranges,
handshake, ``verify_design``, ``HWDesign.verify``) against the
reference's, on the CPU.

- Each ``SIM_CASES`` app under ``fifo_solver`` "z3" and "sim": every
  ``NodeRange`` field and ``decided``; every ``EdgeCheck`` field with the
  verdict, errors and notes; ``cross_check`` on the scalar engine (the
  port's ``device="cpu"``): its marks, bounds and violations; the
  proven widths (``module_proven_bits``, ``narrowed_token_bits``), ``ok``
  and the report, line for line.  Uids differ between the two processes,
  so nodes are compared in schedule order and ``%uid`` tags in the report
  are replaced by that order.
- The reference's own unit cases (``tests/test_analysis.py``), held for
  the port: range hulls contain the executor's values, the conv chain is
  proven, a wrap witness on an unwidened Add, ``input_ranges`` tighten
  the proofs, a hypothesis soundness property, an under-depth FIFO is
  caught; and the CLI ``--all-apps --check --device cpu``.
- No quiet fallback: without a card, ``verify``'s cross-check raises.

The reference's ``verify_design`` checks its rewrites on its lowering,
which needs ``jax.experimental.enable_x64`` (gone from this jax); its
numbers come from one subprocess that aliases it, as in
``tests/test_torch_hw.py``, and uses the scalar engine.
"""
import inspect
import json
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import CompileOptions, SimOptions, compile_pipeline  # noqa
from repro_torch.analysis import (CrossCheckResult, analyze,  # noqa: E402
                                  certify, module_proven_bits,
                                  narrowed_token_bits, verify_design)
from repro_torch.analysis.handshake import CAPACITY_SLOP_TOKENS  # noqa: E402
from repro_torch.apps import SIM_CASES  # noqa: E402
from repro_torch.core import (Abs, AbsDiff, Add, AddAsync,  # noqa: E402
                              AddMSBs, Array2d, Const, Input, Map, Max, Min,
                              Mul, Reduce, RemoveMSBs, Rshift, Stencil, Sub,
                              UInt)
from repro_torch.core.executor import evaluate  # noqa: E402
from repro_torch.core.hwimg import toposort  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
APPS = sorted(SIM_CASES)
SOLVERS = ("z3", "sim")
CASES = [f"{app}-{solver}" for app in APPS for solver in SOLVERS]


def _summary(res, mpb, ntb):
    """One VerifyResult (plus the design's proven widths) as plain JSON,
    nodes in schedule order and uids replaced by their place in it."""
    import re as _re
    order = res.ranges.order
    idx = {u: i for i, u in enumerate(order)}

    def node(nr):
        return {"i": idx[nr.uid], "op": nr.op, "detail": nr.detail,
                "status": nr.status, "declared": repr(nr.declared),
                "math": [nr.math_lo, nr.math_hi], "value": [nr.lo, nr.hi],
                "proven_bits": nr.proven_bits,
                "component_bits": (None if nr.component_bits is None
                                   else list(nr.component_bits))}

    def edge(e):
        return {"key": list(e.key), "names": list(e.names), "tpf": e.tpf,
                "need_total": e.need_total, "raw_need": e.raw_need,
                "prod_px": e.prod_px, "cons_px": e.cons_px,
                "installed_depth": e.installed_depth,
                "static_lower": e.static_lower,
                "static_upper": e.static_upper, "klass": e.klass,
                "model_backlog": e.model_backlog, "residue": e.residue,
                "starved": e.starved, "shortfall": e.shortfall,
                "modeled": e.modeled, "certified": e.certified,
                "rate_balanced": e.rate_balanced}

    def keyed(d):
        return sorted([a, b, int(v)] for (a, b), v in d.items())

    def uidless(line):
        return _re.sub(r"%(\d+)=",
                       lambda m: f"%{idx.get(int(m.group(1)), '?')}=", line)

    h, c = res.handshake, res.cross
    return {
        "ranges": [node(res.ranges.nodes[u]) for u in order],
        "decided": res.ranges.decided, "wrap_free": res.ranges.wrap_free,
        "edges": [edge(e) for e in h.edges], "verdict": h.verdict,
        "errors": list(h.errors), "notes": list(h.notes),
        "certified_fraction": h.certified_edge_fraction,
        "lower_bounds": keyed(h.lower_bounds),
        "upper_bounds": keyed(h.upper_bounds),
        "cross": {"hwm": keyed(c.hwm), "lower": keyed(c.lower),
                  "upper": keyed(c.upper), "violations": list(c.violations),
                  "completed": c.completed, "ok": c.ok, "engine": c.engine},
        "module_proven_bits": list(mpb), "narrowed": keyed(ntb),
        "ok": res.ok, "ir_violations": list(res.ir_violations),
        "declared_fifo_bits": res.declared_fifo_bits,
        "narrowed_fifo_bits": res.narrowed_fifo_bits,
        "report": [uidless(ln) for ln in res.report_lines(verbose=True)],
    }


_REF_SCRIPT = textwrap.dedent('''
    import json, sys
    import jax, jax.experimental
    jax.experimental.enable_x64 = jax.enable_x64   # this process only
    from repro.apps import SIM_CASES
    from repro.core import CompileOptions, compile_pipeline
    from repro.analysis import (module_proven_bits, narrowed_token_bits,
                                verify_design)
    import repro.hwsim.allocate as allocate

    _sim = allocate.simulate
    # the scalar engine everywhere, fifo_solver="sim" included
    allocate.simulate = lambda *a, **k: _sim(*a, **dict(k, engine="scalar"))
''') + inspect.getsource(_summary) + textwrap.dedent('''

    out = {}
    for case in json.load(open(sys.argv[1])):
        app, solver = case.split("-")
        uf, T, _ = SIM_CASES[app]()
        d = compile_pipeline(uf, T=T,
                             options=CompileOptions(fifo_solver=solver))
        res = verify_design(d, sim=True, engine="scalar", backend="jax")
        out[case] = _summary(res, module_proven_bits(d, res.ranges),
                             narrowed_token_bits(d, res.ranges))
    json.dump(out, open(sys.argv[2], "w"))
''')


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's summaries, from a subprocess started with the
    module (the port's own tests run meanwhile)."""
    tmp = tmp_path_factory.mktemp("ref_analysis")
    (tmp / "cases.json").write_text(json.dumps(CASES))
    (tmp / "ref.py").write_text(_REF_SCRIPT)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen(
        [sys.executable, str(tmp / "ref.py"), str(tmp / "cases.json"),
         str(tmp / "out.json")], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    data = {}

    def get():
        if not data:
            try:
                _, err = proc.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.communicate()
                raise
            assert proc.returncode == 0, err[-4000:]
            data.update(json.loads((tmp / "out.json").read_text()))
        return data

    yield get
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


_PORT = {}


def _port(case):
    """The port's summary of one case, through ``HWDesign.verify`` on the
    CPU (the scalar engine), computed once per process."""
    if case not in _PORT:
        app, solver = case.split("-")
        uf, T, _ = SIM_CASES[app]()
        d = compile_pipeline(uf, T=T, options=CompileOptions(
            fifo_solver=solver, device="cpu"))
        res = d.verify(backend="torch", options=SimOptions(device="cpu"))
        _PORT[case] = (d, res, json.loads(json.dumps(_summary(
            res, module_proven_bits(d, res.ranges),
            narrowed_token_bits(d, res.ranges)))))
    return _PORT[case]


ASPECTS = {
    "ranges": ("ranges", "decided", "wrap_free"),
    "handshake": ("edges", "verdict", "errors", "notes",
                  "certified_fraction", "lower_bounds", "upper_bounds"),
    "cross_check": ("cross",),
    "widths_and_report": ("module_proven_bits", "narrowed", "ok",
                          "ir_violations", "declared_fifo_bits",
                          "narrowed_fifo_bits", "report"),
}


@pytest.mark.parametrize("aspect", sorted(ASPECTS))
@pytest.mark.parametrize("case", CASES)
def test_verify_equals_reference(case, aspect, reference):
    """Field for field, the port's verify against the reference's."""
    _d, res, got = _port(case)
    want = reference()[case]
    for key in ASPECTS[aspect]:
        assert got[key] == want[key], (case, key)
    assert res.ok and got["cross"]["engine"] == "scalar"


@pytest.mark.parametrize("case", CASES)
def test_verify_surface_and_report(case):
    """``HWDesign.verify`` keeps its result for ``report()``, and
    ``verify_design`` with ``sim=False`` gives the same static passes."""
    d, res, got = _port(case)
    assert d._verify == [res]
    report = d.report()
    assert " -- verify --" in report
    assert "rewrite fixpoint structurally clean" in report
    static = verify_design(d, sim=False, backend="kernels")
    assert static.cross is None and static.ok
    assert [ln for ln in static.report_lines(verbose=True)
            if not ln.startswith(" cross-check")] == \
        [ln for ln in res.report_lines(verbose=True)
         if not ln.startswith(" cross-check")]


# ---- the reference's unit cases, held for the port ----

def _conv_chain(acc_widen=6, w=24, h=16):
    """The convolution skeleton (Stencil->Mul->widen->Reduce->shift)."""
    rng = np.random.RandomState(5)
    inp = Input(Array2d(UInt(8), w, h), "x")
    k = rng.randint(128, 256, (8, 8)).astype(np.int64)
    st = Stencil(-7, 0, -7, 0)(inp)
    prod = Map(Mul)(st, Const(Array2d(UInt(8), 8, 8), k))
    s = Reduce(AddAsync)(Map(AddMSBs(acc_widen))(prod))
    out = Map(RemoveMSBs(8 + acc_widen))(Map(Rshift(3))(s))
    x = rng.randint(0, 256, (h, w)).astype(np.int64)
    return out, x


def test_range_hulls_contain_executor_values():
    out, x = _conv_chain()
    report = analyze(out)
    assert report.decided
    for v in toposort(out):
        nr = report.nodes[v.uid]
        if nr.lo is None:
            continue
        vals = np.asarray(evaluate(v, {"x": x}))
        assert nr.lo <= int(vals.min()), (nr.line(), vals.min())
        assert int(vals.max()) <= nr.hi, (nr.line(), vals.max())


def test_conv_chain_proven_wrap_free():
    rng = np.random.RandomState(5)
    inp = Input(Array2d(UInt(8), 24, 16), "x")
    k = rng.randint(128, 256, (8, 8)).astype(np.int64)
    prod = Map(Mul)(Stencil(-7, 0, -7, 0)(inp),
                    Const(Array2d(UInt(8), 8, 8), k))
    s = Reduce(AddAsync)(Map(AddMSBs(6))(prod))
    out = Map(RemoveMSBs(14))(Map(Rshift(14))(s))
    report = analyze(out)
    assert report.wrap_free
    assert report.nodes[out.uid].status == "proven"
    red = next(v for v in toposort(out) if v.op == "Reduce")
    nr = report.nodes[red.uid]
    assert nr.status == "proven"
    assert nr.proven_bits is not None and nr.proven_bits <= 22


def test_wrap_witness_on_unwidened_add():
    a = Input(Array2d(UInt(8), 4, 4), "a")
    b = Input(Array2d(UInt(8), 4, 4), "b")
    out = Map(Add)(a, b)
    report = analyze(out)
    nr = report.nodes[out.uid]
    assert nr.status == "wraps"
    assert (nr.math_lo, nr.math_hi) == (0, 510)
    assert (nr.lo, nr.hi) == (0, 255)
    assert report.decided and not report.wrap_free
    assert any("wraps" in ln for ln in report.report_lines())
    hi = np.full((4, 4), 255, dtype=np.int64)
    vals = np.asarray(evaluate(out, {"a": hi, "b": hi}))
    assert vals.min() >= 0 and vals.max() <= 255


def test_input_ranges_tighten_proofs():
    a = Input(Array2d(UInt(8), 4, 4), "a")
    b = Input(Array2d(UInt(8), 4, 4), "b")
    out = Map(Add)(a, b)
    report = analyze(out, input_ranges={"a": (0, 100), "b": (0, 100)})
    nr = report.nodes[out.uid]
    assert nr.status == "proven"
    assert nr.math_hi == 200 and nr.proven_bits == 8


def test_hypothesis_random_pointop_soundness():
    """On random point-op DAGs the executor never leaves the analysis
    hulls (wraps included)."""
    hyp = pytest.importorskip("hypothesis")
    st_mod = pytest.importorskip("hypothesis.strategies")
    w, h = 6, 5

    @hyp.settings(max_examples=25, deadline=None)
    @hyp.given(data=st_mod.data())
    def run(data):
        rng = np.random.RandomState(data.draw(st_mod.integers(0, 2**31 - 1)))
        vals = [Input(Array2d(UInt(8), w, h), "x")]
        binops = [Add, Sub, Max, Min, AbsDiff]
        for _ in range(data.draw(st_mod.integers(1, 6))):
            kind = data.draw(st_mod.integers(0, 6))
            a = vals[data.draw(st_mod.integers(0, len(vals) - 1))]
            if kind <= 4:
                b = vals[data.draw(st_mod.integers(0, len(vals) - 1))]
                vals.append(Map(binops[kind])(a, b))
            elif kind == 5:
                vals.append(Map(Abs)(a))
            else:
                vals.append(Map(Rshift(data.draw(
                    st_mod.integers(1, 4))))(a))
        out = vals[-1]
        x = rng.randint(0, 256, (h, w)).astype(np.int64)
        report = analyze(out)
        assert report.decided
        for v in toposort(out):
            nr = report.nodes[v.uid]
            if nr.lo is None:
                continue
            arr = np.asarray(evaluate(v, {"x": x}))
            assert nr.lo <= int(arr.min()) and int(arr.max()) <= nr.hi, \
                nr.line()

    run()


def test_under_depth_fifo_is_caught():
    """Zeroing a FIFO the trace model needs flips the verdict to at-risk
    with a named under-depth error."""
    sizes = {"stereo": dict(w=32, h=12, nd=8),
             "convolution": dict(w=48, h=20)}
    for name in ("stereo", "convolution"):
        uf, T, _ = SIM_CASES[name](**sizes[name])
        design = compile_pipeline(uf, T=T)
        base = certify(design)
        assert base.verdict == "certified" and not base.errors
        cand = [e for e in base.edges
                if e.modeled and e.model_backlog > 1 + CAPACITY_SLOP_TOKENS]
        if cand:
            break
    assert cand, "no modeled edge with backlog beyond zero-depth capacity"
    key = cand[0].key
    mutated = certify(design, depths={key: 0})
    assert mutated.verdict == "at-risk"
    assert any(f"under-depth FIFO on {key}" in err
               for err in mutated.errors), mutated.errors


def test_cli_all_apps_check_on_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--all-apps",
         "--check", "--device", "cpu", "--json"],
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    summary = json.loads(proc.stdout)
    assert sorted(summary) == APPS
    assert all(v["ok"] and v["cross_ok"] for s in summary.values()
               for v in s.values())


def test_cross_check_raises_without_a_card(monkeypatch):
    """The oracle's default device is the card: without one it raises
    rather than taking the scalar engine quietly; ``sim=False`` needs no
    device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    uf, T, _ = SIM_CASES["pyramid"]()
    design = compile_pipeline(uf, T=T)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        design.verify()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        verify_design(design, device="cuda")
    assert design.verify(sim=False).ok
    res = design.verify(options=SimOptions(device="cpu"))
    assert isinstance(res.cross, CrossCheckResult) and res.cross.ok
    assert re.search(r"engine=scalar", "\n".join(res.report_lines()))
