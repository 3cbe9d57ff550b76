"""The port's compile-and-run flow (repro_torch.compile_pipeline -> lower ->
run / run_batch) against the reference on all five apps (CONVOLUTION,
STEREO, FLOW, DESCRIPTOR, PYRAMID) at bench and odd sizes, for both port
backends on the CPU, bit-exact: against the numpy executor
(``repro.core.executor.evaluate``), the golden models, and the JAX
``pallas`` backend; and the plans (segments, nodes, megakernels, box-sum
chains) against the pallas backend's.  ``External`` runs as a host call
on both backends, against both executors, once per frame.

The JAX lowering engine needs ``jax.experimental.enable_x64``, which this
jax no longer has.  The pallas plan and its outputs therefore come from one
subprocess that aliases it to ``jax.enable_x64`` before importing
``repro``; the alias never exists in this test process, so the JAX
package's own tests behave here as they do everywhere else.
"""
import json
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.apps import Convolution as JaxConvolution  # noqa: E402
from repro.apps import PIPELINES as JAX_PIPELINES  # noqa: E402
from repro.apps import separable_kernel as jax_separable_kernel  # noqa: E402
from repro.core.executor import evaluate  # noqa: E402
import repro.core as jax_core  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
from repro_torch import CompileOptions, compile_pipeline  # noqa: E402
from repro_torch.apps import (from_reference, golden_convolution,  # noqa: E402
                              golden_descriptor, golden_flow, golden_pyramid,
                              golden_stereo, separable_kernel)
from repro_torch.core.lowering import (RULES, Chain, Dispatch,  # noqa: E402
                                       Leaf, Many, OpPat, RewriteRule,
                                       register_rule)
from repro_torch.core.lowering.engine import CompiledPipeline  # noqa: E402
from repro_torch.kernels.util import shift2d  # noqa: E402
from repro_torch.kernels.megakernel.check import (  # noqa: E402
    external_pipelines, point_fn_probes)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 3
SEEDED_KERNEL = np.random.RandomState(11).randint(0, 256, (8, 8))

# name -> (reference app, parameters carried across)
CASES = {
    "conv_96x40": ("convolution", {"w": 96, "h": 40}),
    "conv_50x21": ("convolution", {"w": 50, "h": 21}),
    "conv_seeded": ("convolution", {"w": 50, "h": 21,
                                    "kernel": SEEDED_KERNEL}),
    "conv_separable": ("convolution", {"w": 96, "h": 40,
                                       "kernel": separable_kernel()}),
    "stereo_64x24": ("stereo", {"w": 64, "h": 24, "nd": 8}),
    "stereo_37x13": ("stereo", {"w": 37, "h": 13, "nd": 5}),
    "flow_48x24": ("flow", {"w": 48, "h": 24}),
    "flow_37x13": ("flow", {"w": 37, "h": 13}),
    "descriptor_64x48": ("descriptor", {"w": 64, "h": 48, "n_features": 32}),
    "descriptor_45x19": ("descriptor", {"w": 45, "h": 19, "n_features": 16}),
    "pyramid_96x64": ("pyramid", {"w": 96, "h": 64}),
    "pyramid_36x20": ("pyramid", {"w": 36, "h": 20}),
}
MK_CASES = sorted(c for c, (app, _) in CASES.items()
                  if app in ("flow", "descriptor", "pyramid"))


def _jax_app(app, params):
    return JAX_PIPELINES[app](**params)


def _inputs(case):
    app, params = CASES[case]
    rng = np.random.RandomState(sum(map(ord, case)))
    shape = (FRAMES, params["h"], params["w"])
    x = rng.randint(0, 256, shape).astype(np.int64)
    if app == "stereo":
        return {"stereo.in": (x, np.roll(x, 3, axis=-1))}
    if app == "flow":
        x[0, :2] = 0                    # flat rows: det == 0 -> u = v = 0
        return {"flow.in": (x, np.roll(x, 1, axis=-1))}
    return {f"{app}.in": x}


def _leaves(r):
    """The image leaves of an app output (tuples flattened)."""
    if isinstance(r, tuple):
        return [x for e in r for x in _leaves(e)]
    return [np.asarray(r)]


def _stack(per_frame):
    """Per-frame outputs -> one leaf list with a leading frame axis."""
    return [np.stack(ls) for ls in zip(*[_leaves(r) for r in per_frame])]


def _equal(a, b):
    a, b = _leaves(a), _leaves(b)
    return len(a) == len(b) and all(
        x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(a, b))


def _frame(inputs, f):
    return {k: tuple(e[f] for e in v) if isinstance(v, tuple) else v[f]
            for k, v in inputs.items()}


_JAX_SCRIPT = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax, jax.experimental
    jax.experimental.enable_x64 = jax.enable_x64   # this process only
    from repro.apps import PIPELINES
    from repro.core import CompileOptions, compile_pipeline

    def leaves(r):
        if isinstance(r, tuple):
            return [x for e in r for x in leaves(e)]
        return [np.asarray(r)]

    spec = json.load(open(sys.argv[1]))
    out = {}
    for case, (app, params) in spec.items():
        data = np.load(sys.argv[2] + "/" + case + ".in.npz")
        if "kernel" in params:
            params["kernel"] = np.asarray(params["kernel"])
        uf = PIPELINES[app](**params)
        d = compile_pipeline(uf, options=CompileOptions(backend="pallas"))
        name = app + ".in"
        if "x" in data:
            batch, one = {name: data["x"]}, {name: data["x"][0]}
        else:
            batch = {name: (data["l"], data["r"])}
            one = {name: (data["l"][0], data["r"][0])}
        arrays = {}
        for what, r in (("run", d.run(one)), ("batch", d.run_batch(batch))):
            for i, leaf in enumerate(leaves(r)):
                arrays[f"{what}_{i}"] = leaf
        np.savez(sys.argv[2] + "/" + case + ".out.npz", **arrays)
        out[case] = d.lowering_report()
    json.dump(out, open(sys.argv[2] + "/reports.json", "w"))
""")


@pytest.fixture(scope="module")
def jax_pallas(tmp_path_factory):
    """{case: (run leaves, run_batch leaves, lowering report)} from the JAX
    pallas backend, computed in one subprocess."""
    d = tmp_path_factory.mktemp("jax_pallas")
    spec = {}
    for case, (app, params) in CASES.items():
        (inp,) = _inputs(case).values()
        if isinstance(inp, tuple):
            np.savez(d / f"{case}.in.npz", l=inp[0], r=inp[1])
        else:
            np.savez(d / f"{case}.in.npz", x=inp)
        spec[case] = [app, {k: (v.tolist() if isinstance(v, np.ndarray)
                                else v) for k, v in params.items()}]
    (d / "spec.json").write_text(json.dumps(spec))
    (d / "run.py").write_text(_JAX_SCRIPT)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, str(d / "run.py"),
                           str(d / "spec.json"), str(d)], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    reports = json.loads((d / "reports.json").read_text())
    out = {}
    for case in CASES:
        z = np.load(d / f"{case}.out.npz")
        n = sum(1 for k in z.files if k.startswith("run_"))
        out[case] = ([z[f"run_{i}"] for i in range(n)],
                     [z[f"batch_{i}"] for i in range(n)], reports[case])
    return out


def _executor(case, inputs):
    """The executor's leaves, stacked over the frames."""
    app, params = CASES[case]
    out = _jax_app(app, params).build()[1]
    return _stack([evaluate(out, _frame(inputs, f)) for f in range(FRAMES)])


def _golden(case, inputs):
    """The golden model's leaves, stacked over the frames."""
    app, params = CASES[case]
    frames = [_frame(inputs, f) for f in range(FRAMES)]
    if app == "convolution":
        return _stack([golden_convolution(x["convolution.in"],
                                          params.get("kernel"))
                       for x in frames])
    if app == "stereo":
        return _stack([golden_stereo(*x["stereo.in"], nd=params["nd"])
                       for x in frames])
    if app == "flow":
        return _stack([golden_flow(*x["flow.in"]) for x in frames])
    if app == "descriptor":
        return _stack([golden_descriptor(x["descriptor.in"],
                                         n_features=params["n_features"])
                       for x in frames])
    return _stack([golden_pyramid(x["pyramid.in"]) for x in frames])


@pytest.mark.parametrize("backend", ["torch", "kernels"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_port_matches_executor_and_golden(case, backend):
    app, params = CASES[case]
    inputs = _inputs(case)
    design = compile_pipeline(from_reference(app, params),
                              options=CompileOptions(backend=backend,
                                                     device="cpu"))
    want = _executor(case, inputs)
    gold = _golden(case, inputs)        # DESCRIPTOR's golden rows drop an axis
    assert _equal(tuple(want), tuple(g.reshape(w.shape)
                                     for g, w in zip(gold, want)))
    one = _leaves(design.run(_frame(inputs, 0)))
    assert _equal(tuple(one), tuple(w[0] for w in want))
    assert _equal(design.run_batch(inputs), tuple(want))


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernels_backend_matches_jax_pallas(case, jax_pallas):
    app, params = CASES[case]
    inputs = _inputs(case)
    design = compile_pipeline(from_reference(app, params))
    jax_run, jax_batch, _ = jax_pallas[case]
    assert _equal(design.run(_frame(inputs, 0), backend="kernels",
                             device="cpu"), tuple(jax_run))
    assert _equal(design.run_batch(inputs, backend="kernels", device="cpu"),
                  tuple(jax_batch))


_PLAN = re.compile(r"(\d+) fused dispatch\(es\).*?(\d+) program segment\(s\) "
                   r"over (\d+) nodes")


@pytest.mark.parametrize("case", ["conv_96x40", "stereo_64x24"])
def test_plans_agree_with_jax_pallas(case, jax_pallas):
    """Both lowerings fuse the whole app into one dispatch in one segment."""
    app, params = CASES[case]
    design = compile_pipeline(from_reference(app, params))
    design.lower("kernels", device="cpu")
    port = _PLAN.search(design.lowering_report()).groups()
    ref = _PLAN.search(jax_pallas[case][2]).groups()
    assert port == ref == ("1", "1", "3")
    kernel = "conv2d" if app == "convolution" else "sad"
    assert f"=> kernels/{kernel}" in design.lowering_report()
    assert f"=> kernels/{kernel}" in jax_pallas[case][2]


_SEGMENTS = re.compile(r"(\d+) program segment\(s\) over (\d+) nodes"
                       r"(?:, (\d+) megakernel\(s\))?")
_FUSED = re.compile(r"mk\d+: (\d+) fused nodes.*?(?:(\d+) box-sum chain|$)",
                    re.MULTILINE)
# (segments, nodes, megakernels) and (fused nodes, box-sum chains) per
# megakernel on the pallas backend
_MK_PLANS = {"flow": (("1", "47", "1"), [("45", "5")]),
             "descriptor": (("2", "42", "1"), [("35", "3")]),
             "pyramid": (("1", "3", "1"), [("3", None)])}


@pytest.mark.parametrize("case", MK_CASES)
def test_megakernel_plans_agree_with_jax_pallas(case, jax_pallas):
    """FLOW, DESCRIPTOR and PYRAMID fuse the same spans into one kernel."""
    app, params = CASES[case]
    design = compile_pipeline(from_reference(app, params))
    design.lower("kernels", device="cpu")
    port, ref = design.lowering_report(), jax_pallas[case][2]
    assert _SEGMENTS.search(port).groups() == _SEGMENTS.search(ref).groups() \
        == _MK_PLANS[app][0]
    assert _FUSED.findall(port) == _FUSED.findall(ref) == [
        tuple(x or "" for x in t) for t in _MK_PLANS[app][1]]
    if app == "pyramid":
        assert "2 graph rewrite(s)" in port and "2 graph rewrite(s)" in ref


def test_from_reference_carries_a_seeded_kernel():
    ref_uf = JaxConvolution(w=50, h=21, kernel=SEEDED_KERNEL)
    uf = from_reference("convolution", {"w": ref_uf.w, "h": ref_uf.h,
                                        "kernel": ref_uf.kernel})
    assert np.array_equal(uf.kernel, SEEDED_KERNEL)
    with pytest.raises(ValueError, match="unknown parameter"):
        from_reference("stereo", {"w": 8, "kernel": SEEDED_KERNEL})
    with pytest.raises(ValueError, match="unknown app"):
        from_reference("harris", {})


def test_separable_kernel_fires_in_convolution_pipeline(jax_pallas):
    """Convolution(kernel=separable_kernel()) takes the separable split on
    the torch backend and the conv2d dispatch on kernels, as the
    reference's does on jax and pallas (tests/test_lowering.py), and both
    equal the reference's pallas outputs (``conv_separable`` in CASES
    holds them to the executor and the golden model)."""
    assert np.array_equal(separable_kernel(), jax_separable_kernel())
    app, params = CASES["conv_separable"]
    design = compile_pipeline(from_reference(app, params))
    fused = {b: [d.kernel for d in design.lower(b, device="cpu")
                 .fusions.values()] for b in ("torch", "kernels")}
    assert fused == {"torch": ["separable_conv"], "kernels": ["conv2d"]}
    assert "=> kernels/conv2d" in jax_pallas["conv_separable"][2]
    inputs = _inputs("conv_separable")
    jax_run, jax_batch, _ = jax_pallas["conv_separable"]
    for b in ("torch", "kernels"):
        assert _equal(design.run(_frame(inputs, 0), backend=b, device="cpu"),
                      tuple(jax_run))
        assert _equal(design.run_batch(inputs, backend=b, device="cpu"),
                      tuple(jax_batch))


def _window_max(c):
    """A 4x4 window maximum over a u8 image, built from either package's
    core (``c``): the README's ``window_max`` pattern."""
    class WindowMax(c.UserFunction):
        def __init__(self):
            super().__init__("wmax", c.Array2d(c.UInt(8), 24, 16))

        def define(self, x):
            st = c.Stencil(-3, 0, -3, 0)(x)
            return c.Reduce(c.Max)(c.Map(c.AddMSBs(8))(st))

    return WindowMax()


@pytest.mark.parametrize("backend", ["torch", "kernels"])
def test_register_rule_window_max_fires_and_matches_executor(backend):
    """The README's ``register_rule`` example on the port: a window-max
    rule whose Dispatch applies a torch function fires on either backend
    (a user rule is not one the megakernel emitter subsumes), and run and
    run_batch equal the numpy executor bit for bit."""
    pat = OpPat("Reduce", fn="Max", bind="acc", ins=(
        Chain(Many(OpPat("Map", fn="AddMSBs")),
              OpPat("Stencil", bind="st", ins=(Leaf("x"),))),))

    def build(m):
        p = m["st"].params
        sh, sw = abs(p["t"] - p["b"]) + 1, abs(p["r"] - p["l"]) + 1

        def window_max(xv):
            xi = xv.to(torch.int64)
            h, w = xi.shape[1:3]
            return torch.stack([shift2d(xi, p["b"] + dy, p["l"] + dx, h, w)
                                for dy in range(sh) for dx in range(sw)]
                               ).amax(dim=0)

        return Dispatch("window_max", (m["x"].uid,), window_max,
                        "fused window max")

    rule = RewriteRule("window_max", pat, build)
    rng = np.random.RandomState(21)
    x = rng.randint(0, 256, (FRAMES, 16, 24)).astype(np.int64)
    register_rule(rule)
    try:
        assert RULES[-1] is rule
        design = compile_pipeline(_window_max(port_core),
                                  options=CompileOptions(backend=backend,
                                                         device="cpu"))
        lp = design.lower()
        assert [d.kernel for d in lp.fusions.values()] == ["window_max"]
        assert not lp.megakernels
        ref_out = _window_max(jax_core).build()[1]
        want = [evaluate(ref_out, {"wmax.in": x[f]}) for f in range(FRAMES)]
        batch = np.asarray(design.run_batch({"wmax.in": x}))
        for f in range(FRAMES):
            one = np.asarray(design.run({"wmax.in": x[f]}))
            port_exec = np.asarray(design.run({"wmax.in": x[f]},
                                              backend="numpy"))
            assert want[f].dtype == one.dtype == batch.dtype
            assert want[f].tobytes() == one.tobytes() == \
                batch[f].tobytes() == port_exec.tobytes()
    finally:
        RULES.remove(rule)
    assert rule not in RULES


def _sink(c):
    """A pipeline over every generic lowerer this slice ports, built from
    either package's core (``c``): wrap masks, broadcasts, resampling,
    tuples, floats and sparse values."""
    class Sink(c.UserFunction):
        def __init__(self):
            super().__init__("sink", c.Array2d(c.UInt(8), 12, 8))

        def define(self, x):
            a, b = c.FanOut(2)(x)[0], c.FanIn(x)
            d = c.Map(c.Sub)(c.Map(c.Rshift(1))(a), b)             # Int(9)
            e = c.Map(c.Max)(c.Map(c.Abs)(d), c.Map(c.Min)(a, b))
            big = c.Map(c.Gt)(a, c.Const(c.UInt(8), 100))
            both = c.Map(c.And)(big, c.Map(c.Gt)(b, c.Const(c.UInt(8), 30)))
            up = c.Upsample(2, 2)(c.Downsample(2, 2)(a))
            s = c.Reduce(c.Add)(c.Stack(a, up))                     # u8 wrap
            m = c.Map(c.RemoveMSBs(12))(c.Map(c.Mul)(
                c.Map(c.AddMSBs(12))(d), c.Const(c.Int(4), -3)))    # Int(9)
            f = c.Map(c.ToFloat)(d)
            g = c.Map(c.FloatDiv)(f, c.Map(c.ToFloat)(c.Map(c.Sub)(a, up)))
            h = c.Map(c.FloatSqrt)(c.Map(c.FloatSub)(
                c.Map(c.FloatAdd)(f, c.Map(c.FloatMul)(g, f)),
                c.Const(c.Float(), np.float32(2.5))))
            p = c.Crop(2, 1, 0, 3)(c.Pad(1, 2, 3, 0, value=5)(e))
            take = c.SparseTake(c.Filter(s, both), 20)
            return c.Concat(s, m, g, h, p, take)

    return Sink()


def _flat(r):
    if isinstance(r, tuple):
        return [x for e in r for x in _flat(e)]
    return [np.asarray(r)]


def test_generic_lowerers_match_executor():
    rng = np.random.RandomState(5)
    x = rng.randint(0, 256, (FRAMES, 8, 12)).astype(np.int64)
    x[0, :2] = 0                                  # exercise FloatDiv by 0
    ref_out = _sink(jax_core).build()[1]
    # lowered directly: compile_pipeline's rate solve refuses this
    # pipeline's Concat of unequal rates, as the reference's does
    lp = CompiledPipeline(_sink(port_core).build()[1], backend="torch",
                          device="cpu")
    batch = _flat(lp.run_batch({"sink.in": x}))
    for f in range(FRAMES):
        want = _flat(evaluate(ref_out, {"sink.in": x[f]}))
        one = _flat(lp({"sink.in": x[f]}))
        assert len(want) == len(one) == len(batch)
        for w_, o, bt in zip(want, one, batch):
            assert np.array_equal(w_, o) and np.array_equal(w_, bt[f])
            assert w_.dtype == o.dtype


def test_float_sqrt_is_correctly_rounded():
    """FloatSqrt equals numpy's IEEE float32 sqrt bit for bit (torch's CPU
    float32 sqrt misses it for about 0.7 % of inputs, e.g. 1263734.0, a
    DESCRIPTOR trace value)."""
    from repro_torch.core.lowering.lowerers import torch_point_fn
    rng = np.random.RandomState(8)
    a = (rng.rand(1 << 16) * 10.0 ** rng.randint(-6, 12, 1 << 16)).astype(
        np.float32)
    a[:4] = [1263734.0, 0.0, -0.0, -3.5]
    got = torch_point_fn(port_core.FloatSqrt)(torch.from_numpy(a)).numpy()
    want = port_core.FloatSqrt.np_fn(a)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("backend", ["torch", "kernels"])
@pytest.mark.parametrize("probe", sorted(point_fn_probes(port_core)))
def test_point_fn_probes_match_executor(probe, backend):
    """FloatSqrt and FloatDiv on UInt(32) values above 2**24 (numpy works
    from the integers in float64, never through float32) and Sub and Abs
    with a Bool operand (numpy promotes it; torch refuses bool - and abs):
    run and run_batch give the executor's values and types bit for bit."""
    juf, x = point_fn_probes(jax_core)[probe]
    uf = point_fn_probes(port_core)[probe][0]
    key = f"{uf.name}.in"
    design = compile_pipeline(uf, options=CompileOptions(backend=backend,
                                                         device="cpu"))
    batch = np.asarray(design.run_batch({key: x}))
    for f in range(len(x)):
        want = evaluate(juf.build()[1], {key: x[f]})
        one = np.asarray(design.run({key: x[f]}))
        assert want.dtype == one.dtype == batch.dtype
        assert want.tobytes() == one.tobytes() == batch[f].tobytes()


def test_node_values_end_at_the_run_output():
    uf = from_reference("stereo", {"w": 37, "h": 13, "nd": 5})
    design = compile_pipeline(uf, options=CompileOptions(device="cpu"))
    one = _frame(_inputs("stereo_37x13"), 0)
    lp = design.lower()
    vals = lp.node_values(one)
    assert np.array_equal(vals[lp.ir.root], design.run(one))


def test_run_batch_device_keeps_tensors_and_takes_tensors():
    uf = from_reference("convolution", {"w": 50, "h": 21})
    design = compile_pipeline(uf, options=CompileOptions(device="cpu"))
    inputs = _inputs("conv_50x21")
    out = design.run_batch_device(
        {"convolution.in": torch.from_numpy(inputs["convolution.in"])})
    assert isinstance(out, torch.Tensor) and out.dtype == torch.int64
    assert np.array_equal(out.numpy(), design.run_batch(inputs))


def _ext_frames(case):
    rng = np.random.RandomState(sum(map(ord, case)))
    return rng.randint(0, 256, (FRAMES, 8, 12)).astype(np.int64)


@pytest.mark.parametrize("backend", ["torch", "kernels"])
@pytest.mark.parametrize("case", ["clip", "tuple", "wide"])
def test_external_runs_bit_exact_against_both_executors(case, backend):
    """External lowers as a host call: run and run_batch give the port's
    executor's values and types and the reference's executor's, a tuple
    output and a 48-bit output included, and the numpy model runs once per
    frame, in frame order."""
    log = []
    uf = external_pipelines(port_core, log=log)[case]
    ref_out = external_pipelines(jax_core)[case].build()[1]
    key, x = f"{uf.name}.in", _ext_frames(case)
    design = compile_pipeline(uf, options=CompileOptions(backend=backend,
                                                         device="cpu"))
    want = []
    for f in range(FRAMES):
        got_ref = _flat(evaluate(ref_out, {key: x[f]}))
        log.clear()
        got = _flat(design.run({key: x[f]}, backend="numpy"))
        assert len(log) == 1
        assert len(got) == len(got_ref) and all(
            a.dtype == b.dtype and np.array_equal(a, b)
            for a, b in zip(got, got_ref))
        want.append((got, log[0]))
    log.clear()
    batch = _flat(design.run_batch({key: x}))
    assert log == [calls for _, calls in want]
    for f, (w_, _) in enumerate(want):
        log.clear()
        one = _flat(design.run({key: x[f]}))
        assert len(log) == 1
        for a, b, bt in zip(w_, one, batch):
            assert a.dtype == b.dtype == bt.dtype
            assert np.array_equal(a, b) and np.array_equal(a, bt[f])


def test_external_ends_a_segment_between_two_megakernels():
    """A box sum, the External, then a point-op chain: on the kernels
    backend each side is one generated segment and the External runs
    alone in a generic segment between them."""
    uf = external_pipelines(port_core)["clip"]
    design = compile_pipeline(uf, options=CompileOptions(device="cpu"))
    lp = design.lower("kernels")
    assert len(lp.megakernels) == 2
    assert not any(n.op == "External" for mk in lp.megakernels
                   for n in mk.nodes)
    ops = [[n.op for n in t.nodes] for t in lp._plan]
    assert ops[1] == ["External"] and len(ops) == 3
