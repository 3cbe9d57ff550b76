"""The port's frame server (``repro_torch.serve``, ``HWDesign.serve``)
on the CPU, every wait bounded.

- The control plane's policy objects (``MicroBatcher``,
  ``AdmissionController``, ``HealthMonitor``) against the reference's, on
  the same scripted event sequences with an explicit ``now``; a
  ``ServeTrace`` saved by either package loads in the other and gives the
  same ``replay_ingest`` prediction.  The reference's ``serve`` package
  imports ``jax.experimental.enable_x64`` (gone from this jax), so its
  side runs in a subprocess that aliases it, as in
  ``tests/test_torch_hw.py``.
- The stack/pad/split round trip, the frame-axis split, and the CPU
  staging path.
- Live servers on ``device="cpu"``: every app's served frames equal to
  the port's ``run_batch`` of the same frames and to the reference's
  executor bit for bit (integer and float apps alike: on the CPU the
  kernels' plain versions are exact); ``devices=["cpu", "cpu"]`` equal to
  one device; low priority shed with a typed ``Overloaded``; warmup runs
  every bucket before traffic; the ingest prediction; ``HWDesign.serve``,
  its ``report()`` section and the numpy-backend swap note; ``close()``
  bounded; no quiet fallback without a card.
"""
import concurrent.futures
import inspect
import json
import os
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.apps import BENCH_CASES as REF_BENCH_CASES  # noqa: E402
from repro.core.executor import evaluate as ref_evaluate  # noqa: E402
from repro_torch import CompileOptions, compile_pipeline  # noqa: E402
from repro_torch.apps import BENCH_CASES  # noqa: E402
from repro_torch.hwsim import replay_ingest  # noqa: E402
from repro_torch.serve import (LOW, AdmissionController,  # noqa: E402
                               FrameRequest, FrameServer, HealthMonitor,
                               InflightBatch, MicroBatcher, Overloaded,
                               PinnedRing, QoSPolicy, ServeConfig,
                               ServeTrace, device_put_batch, frame_sharding,
                               frame_signature, pad_frames, serve_design,
                               shard_frames, split_frames, stack_frames)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
APPS = sorted(BENCH_CASES)
WAIT_S = 120                      # every future and join in this file


# ---- the control plane against the reference ----

def _policy_log(batcher_cls, request_cls, admission_cls, policy_cls,
                overloaded_cls, health_cls, seed):
    """Scripted, seeded event sequences through one package's policy
    objects, logged as plain JSON: what every call returned and the
    counters after it."""
    import random
    rng = random.Random(seed)
    log = {"batcher": [], "admission": [], "health": None}

    b = batcher_cls(max_batch=4, max_delay_s=0.5, pad_pow2=True)
    now, rid = 0.0, 0
    for _ in range(300):
        now += rng.choice([0.0, 0.001, 0.05, 0.2, 0.7])
        op = rng.random()
        if op < 0.55:
            req = request_cls(rng.choice("abc"), {"id": rid},
                              rng.choice(["s1", "s2"]), now,
                              priority=rng.randint(0, 2))
            rid += 1
            if rng.random() < 0.5:
                got = [[r.inputs["id"] for r in bat]
                       for bat in b.add(req, now)]
            else:
                b.put(req, now)
                got = None
        elif op < 0.85:
            bat = b.take(now, allow_partial=rng.random() < 0.5,
                         partial_hold_s=rng.choice([0.0, 0.002, 0.3]))
            got = None if bat is None else [r.inputs["id"] for r in bat]
        else:
            got = [[r.inputs["id"] for r in bat] for bat in b.due(now)]
        log["batcher"].append([
            got, b.pending, b.pending_hw, b.size_flushes,
            b.deadline_flushes, b.topup_flushes, b.next_deadline(),
            b.next_topup_ready(0.002), b.pad_target(rng.randint(1, 4))])
    log["batcher"].append([[r.inputs["id"] for r in bat]
                           for bat in b.flush_all()])

    adm = admission_cls(max_queue=20)
    adm.set_policy("capped", policy_cls(priority="low", rate_fps=50.0,
                                        burst=3))
    adm.set_policy("vip", policy_cls(priority="high"))
    now = 0.0
    for _ in range(200):
        now += rng.choice([0.0, 0.005, 0.02, 0.1])
        app = rng.choice(["capped", "vip", "plain"])
        pri = rng.choice([None, 0, 1, 2])
        depth = rng.randint(0, 22)
        try:
            got = ["admit", adm.admit(app, depth, now, priority=pri)]
        except overloaded_cls as e:
            got = ["shed", e.app, e.reason, e.priority, e.depth,
                   e.capacity, str(e)]
        log["admission"].append(got)
    log["admission_report"] = adm.report_lines()
    log["admission_shed"] = adm.total_shed()

    h = health_cls(adm)
    h.set_live(True)
    for i in range(40):
        app = rng.choice(["capped", "vip", "plain"])
        h.app(app).frames_in += 1
        h.record_batch(app, rng.randint(1, 4), float(i))
        h.record_done(app, rng.choice([0.001, 0.004, 0.25, 0.0125]))
    h.set_ready(True)
    h.app("vip").backend = "kernels"
    log["health"] = [h.snapshot(), h.report_lines()]
    h.set_live(False, crash="RuntimeError('boom')")
    log["health_crashed"] = [h.live, h.ready, h.report_lines()[0]]
    return log


def _replay_summary(t, replay):
    """One trace and its replay through the ingest model, as JSON."""
    from fractions import Fraction as F
    res = replay(t.arrival_cycles(64.0), F(1, 48), capacity=8)
    return {"events": [[e.t, e.app, e.priority] for e in t.events],
            "gap": t.mean_gap_s(), "hwm": res.hwm, "cycles": res.cycles,
            "rho": res.utilization, "source": res.source,
            "scaled": [e.t for e in t.scaled(4).events]}


def _trace_log(trace_cls, replay, path_in, path_out):
    """Record and save a trace, load the other package's, and replay
    both."""
    tr = trace_cls()
    for i, (app, pri) in enumerate([("a", 0), ("b", 2), ("a", 1),
                                    ("c", 1), ("a", 0), ("b", 2)]):
        tr.record(0.013 * i * i, app, pri)
    tr.save(path_out)
    return {"own": _replay_summary(tr, replay),
            "other": _replay_summary(trace_cls.load(path_in), replay)}


_REF_SCRIPT = textwrap.dedent('''
    import json, sys
    import jax, jax.experimental
    jax.experimental.enable_x64 = jax.enable_x64   # this process only
    from repro.serve.admission import (AdmissionController, Overloaded,
                                       QoSPolicy)
    from repro.serve.batcher import FrameRequest, MicroBatcher
    from repro.serve.health import HealthMonitor, ServeTrace
    from repro.hwsim import replay_ingest
''') + "".join(inspect.getsource(f) for f in (
    _policy_log, _replay_summary, _trace_log)) + textwrap.dedent('''

    seeds, port_trace, ref_trace, out = json.loads(sys.argv[1]), *sys.argv[2:]
    log = {str(s): _policy_log(MicroBatcher, FrameRequest,
                               AdmissionController, QoSPolicy, Overloaded,
                               HealthMonitor, s) for s in seeds}
    log["trace"] = _trace_log(ServeTrace, replay_ingest, port_trace,
                              ref_trace)
    json.dump(log, open(out, "w"))
''')

SEEDS = (0, 1, 2)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ref_serve")
    port_trace = tmp / "port_trace.json"
    tr = ServeTrace()
    for i, (app, pri) in enumerate([("x", 2), ("y", 0), ("x", 1)]):
        tr.record(0.25 * i + 0.01 * i * i, app, pri)
    tr.save(str(port_trace))
    (tmp / "ref.py").write_text(_REF_SCRIPT)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, str(tmp / "ref.py"), json.dumps(SEEDS),
         str(port_trace), str(tmp / "ref_trace.json"),
         str(tmp / "out.json")], env=env, cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return tmp, json.loads((tmp / "out.json").read_text())


@pytest.mark.parametrize("part", ["batcher", "admission", "health"])
@pytest.mark.parametrize("seed", SEEDS)
def test_policy_objects_equal_reference(seed, part, reference):
    _, ref = reference
    got = json.loads(json.dumps(_policy_log(
        MicroBatcher, FrameRequest, AdmissionController, QoSPolicy,
        Overloaded, HealthMonitor, seed)))
    want = ref[str(seed)]
    keys = {"batcher": ("batcher",),
            "admission": ("admission", "admission_report", "admission_shed"),
            "health": ("health", "health_crashed")}[part]
    for key in keys:
        assert got[key] == want[key], key
    if part == "batcher":     # the script exercises every flush tier
        assert all(got["batcher"][-2][3:6])


def test_serve_trace_loads_across_packages(reference):
    tmp, ref = reference
    want = ref["trace"]

    def here(path):
        return json.loads(json.dumps(_replay_summary(
            ServeTrace.load(str(path)), replay_ingest)))

    # the reference's trace, loaded here, replays as it did there
    assert here(tmp / "ref_trace.json") == want["own"]
    # the port's trace, loaded there, replayed as it does here
    assert here(tmp / "port_trace.json") == want["other"]
    # the same recording gives the same file and replay in both
    got = _trace_log(ServeTrace, replay_ingest, str(tmp / "ref_trace.json"),
                     str(tmp / "port_trace_again.json"))
    assert json.loads(json.dumps(got)) == {"own": want["own"],
                                           "other": want["own"]}
    assert (tmp / "port_trace_again.json").read_text() == \
        (tmp / "ref_trace.json").read_text()
    assert want["own"]["source"] == "trace" and want["own"]["hwm"] >= 1


# ---- batching, staging and the frame-axis split ----

def _req(app, inputs, t=0.0):
    return FrameRequest(app, inputs, frame_signature(inputs), t)


def _frame(shape=(8, 6), dtype=np.int64, seed=0):
    return {"in": np.random.RandomState(seed).randint(
        0, 100, shape).astype(dtype)}


def test_signature_buckets_and_stack_pad_split_roundtrip():
    b = MicroBatcher(max_batch=4, max_delay_s=10.0)
    variants = [("a", (8, 6), np.int64), ("a", (4, 4), np.int64),
                ("a", (8, 6), np.int32), ("b", (8, 6), np.int64)]
    batches = []
    for i in range(40):
        app, shape, dt = variants[i % 4]
        batches += b.add(_req(app, _frame(shape, dt, seed=i)), now=0.0)
    batches += b.flush_all()
    assert sum(len(r) for r in batches) == 40
    for reqs in batches:
        assert len({(r.app, r.signature) for r in reqs}) == 1
    reqs = [_req("a", _frame(seed=i)) for i in range(3)]
    batch, n = stack_frames(reqs, pad_to=4)
    assert n == 3 and batch["in"].shape == (4, 8, 6)
    assert np.array_equal(batch["in"][3], batch["in"][2])
    outs = split_frames(batch["in"], n)
    assert all(np.array_equal(o, r.inputs["in"]) for o, r in zip(outs, reqs))
    with pytest.raises(AssertionError):
        stack_frames([_req("a", _frame((8, 6))), _req("a", _frame((4, 4)))])


def test_frame_axis_split_and_cpu_staging():
    assert frame_sharding(None) is None
    assert frame_sharding(["cpu"]) is None
    assert frame_sharding(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="device"):
        frame_sharding(["meta", "cpu"])
    batch = {"in": np.arange(15, dtype=np.int64).reshape(5, 3),
             "pair": (np.ones((5, 2), np.uint8), np.zeros((5, 2), np.int32))}
    padded, n = pad_frames(batch, 4)
    assert n == 5 and padded["in"].shape[0] == 8
    assert np.array_equal(padded["in"][7], batch["in"][4])
    shards, n = shard_frames(batch, 2)
    assert n == 5 and [s["in"].shape[0] for s in shards] == [3, 3]
    assert np.array_equal(np.concatenate([s["in"] for s in shards])[:5],
                          batch["in"])
    assert np.array_equal(shards[1]["pair"][0][2], batch["pair"][0][4])
    dev = device_put_batch(batch, "cpu")
    assert dev["in"].device.type == "cpu" and dev["in"].dtype == torch.int64
    assert dev["pair"][0].dtype == torch.uint8     # leaves keep their dtype
    assert np.array_equal(dev["in"].numpy(), batch["in"])
    ring = PinnedRing(2)
    with pytest.raises(RuntimeError, match="before begin"):
        ring.seal(None)


# ---- live servers on the CPU ----

@pytest.fixture(scope="module")
def designs():
    """app -> (port design on the CPU, inputs_fn, the reference's output
    Val for the same app)."""
    out = {}
    for app in APPS:
        uf, inputs_fn = BENCH_CASES[app]()
        d = compile_pipeline(uf, options=CompileOptions(device="cpu"))
        ref_uf, _ = REF_BENCH_CASES[app]()
        out[app] = (d, inputs_fn, ref_uf.build()[1])
    return out


def _leaves(r):
    if isinstance(r, tuple):
        return [x for e in r for x in _leaves(e)]
    return [np.asarray(r)]


def _same(a, b):
    a, b = _leaves(a), _leaves(b)
    return len(a) == len(b) and all(
        x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(a, b))


def _frames(inputs_fn, n, base=0):
    return [inputs_fn(np.random.RandomState(base + i)) for i in range(n)]


def _stack_inputs(frames):
    def st(vals):
        if isinstance(vals[0], tuple):
            return tuple(st([v[i] for v in vals])
                         for i in range(len(vals[0])))
        return np.stack(vals)
    return {k: st([f[k] for f in frames]) for k in frames[0]}


def _batch_frame(out, i):
    return tuple(_batch_frame(e, i) for e in out) \
        if isinstance(out, tuple) else out[i]


def _check_served(d, ref_out, frames, outs):
    """Served frames equal the port's run_batch of the same frames and the
    reference's executor, bit for bit."""
    batch = d.run_batch(_stack_inputs(frames), backend="kernels")
    for i, (fr, out) in enumerate(zip(frames, outs)):
        assert _same(out, _batch_frame(batch, i))
        assert _same(out, ref_evaluate(ref_out, fr))


def test_server_round_trip_every_app_bit_exact(designs):
    """Mixed traffic over all five apps through one live server (an
    odd count a bucket, so deadline and top-up flushes both happen)."""
    sent = []
    srv = FrameServer(ServeConfig(max_batch=4, max_delay_ms=20.0))
    try:
        for app in APPS:
            d, inputs_fn, _ = designs[app]
            srv.register(d, name=app, device="cpu",
                         warm_inputs=_frames(inputs_fn, 1, 99))
        srv.start()
        for i in range(7):
            for j, app in enumerate(APPS):
                fr = designs[app][1](np.random.RandomState(10 * i + j))
                pri = ("high", "normal", "low")[(i + j) % 3]
                sent.append((app, fr, srv.submit(fr, app=app,
                                                 priority=pri)))
        outs = [(app, fr, f.result(timeout=WAIT_S)) for app, fr, f in sent]
    finally:
        srv.close(timeout=WAIT_S)
    for app in APPS:
        d, _, ref_out = designs[app]
        mine = [(fr, out) for a, fr, out in outs if a == app]
        _check_served(d, ref_out, [fr for fr, _ in mine],
                      [out for _, out in mine])
    st = srv.stats
    assert st.frames_in == st.frames_out == 35 and st.shed == 0
    assert st.batches >= 10 and st.inflight_hw >= 1
    assert st.warmup_done == st.warmup_total == 5 * 3
    assert any("fifo occupancy" in ln for ln in st.report_lines())
    assert all(d.lower("kernels", device="cpu").signatures
               for d, _, _ in designs.values())


def test_two_cpu_devices_equal_one(designs):
    d, inputs_fn, ref_out = designs["flow"]
    frames = _frames(inputs_fn, 11)
    results = []
    for devices in (None, ["cpu", "cpu"]):
        cfg = ServeConfig(max_batch=8, max_delay_ms=20.0, devices=devices)
        srv = FrameServer(cfg)
        try:
            srv.register(d, name="flow",
                         device="cpu" if devices is None else None)
            srv.start(warmup=False)
            futs = srv.submit_many(frames)
            results.append([f.result(timeout=WAIT_S) for f in futs])
        finally:
            srv.close(timeout=WAIT_S)
        assert srv.stats.devices == (1 if devices is None else 2)
        assert len(srv._apps["flow"].dispatcher.compiled) == \
            srv.stats.devices
    assert all(_same(a, b) for a, b in zip(*results))
    _check_served(d, ref_out, frames, results[1])
    with pytest.raises(ValueError, match="not both"):
        FrameServer(ServeConfig(devices=["cpu"])).register(d, device="cpu")


def test_low_priority_shed_with_typed_overloaded(designs):
    d, inputs_fn, ref_out = designs["convolution"]
    frames = _frames(inputs_fn, 6)
    srv = FrameServer(ServeConfig(max_batch=4, max_delay_ms=10.0))
    srv.register(d, name="conv", device="cpu", warm_inputs=[frames[0]],
                 policy=QoSPolicy(priority="low", rate_fps=1e-3, burst=2))
    futs, shed = [], []
    with srv:
        for inp in frames:
            try:
                futs.append((inp, srv.submit(inp, app="conv")))
            except Overloaded as e:
                shed.append(e)
        outs = [(inp, f.result(timeout=WAIT_S)) for inp, f in futs]
    assert len(futs) == 2 and len(shed) == 4
    assert all(e.app == "conv" and e.reason == "rate" and e.priority == LOW
               for e in shed)
    _check_served(d, ref_out, [i for i, _ in outs], [o for _, o in outs])
    assert srv.stats.shed == 4
    assert any("shed=4" in ln for ln in srv.health.report_lines())


def test_warmup_runs_every_bucket_before_traffic(designs):
    d, inputs_fn, _ = designs["stereo"]
    srv = FrameServer(ServeConfig(max_batch=4))
    srv.register(d, name="stereo", device="cpu",
                 warm_inputs=_frames(inputs_fn, 1))
    assert srv.stats.warmup_done == 0
    lp = srv._apps["stereo"].compiled[0]
    before_start = {k for k in lp.signatures if k[0] == "serve"}
    srv.start()
    try:
        assert srv.stats.warmup_total == srv.stats.warmup_done == 3
        assert srv.stats.warmup_s > 0 and srv.health.ready
        warmed = {k for k in lp.signatures if k[0] == "serve"}
        assert warmed and warmed >= before_start
        assert {k[1] for k in warmed} >= {
            lp.frame_signature(device_put_batch(
                _stack_inputs(_frames(inputs_fn, s)), "cpu"))
            for s in (1, 2, 4)}
        for f in srv.submit_many(_frames(inputs_fn, 7, 5)):
            f.result(timeout=WAIT_S)
        assert {k for k in lp.signatures if k[0] == "serve"} == warmed
        assert any("warmup: 3/3" in ln for ln in srv.stats.report_lines())
    finally:
        srv.close(timeout=WAIT_S)
    srv = FrameServer(ServeConfig(warmup=False))
    srv.register(d, name="stereo", device="cpu",
                 warm_inputs=_frames(inputs_fn, 1))
    with srv:
        assert srv.stats.warmup_done == 0 and srv.stats.warmup_total == 0


def test_ingest_prediction_from_a_live_server(designs):
    d, inputs_fn, _ = designs["convolution"]
    srv = serve_design(d, device="cpu",
                       config=ServeConfig(max_batch=4, max_delay_ms=5.0))
    try:
        for f in srv.submit_many(_frames(inputs_fn, 8)):
            f.result(timeout=WAIT_S)
        assert len(srv.trace) == 8
        res = srv.simulate_ingest(frames=256, seed=1)
        assert res.completed and srv.stats.predicted_queue_hw == res.hwm
        r1 = srv.simulate_ingest(frames=256, seed=1, arrival_fps=200.0,
                                 service_fps=400.0)
        r2 = srv.simulate_ingest(frames=256, seed=1, arrival_fps=200.0,
                                 service_fps=400.0)
        assert (r1.hwm, r1.cycles) == (r2.hwm, r2.cycles)
        res = srv.replay_trace_ingest(service_fps=400.0)
        assert res.source == "trace" and res.completed
        assert srv.stats.predicted_queue_hw == res.hwm
        rep = "\n".join(srv.stats.report_lines())
        assert "predicted" in rep and "rho=" in rep
    finally:
        srv.close(timeout=WAIT_S)
    with pytest.raises(ValueError):
        FrameServer(ServeConfig()).replay_trace_ingest(trace=ServeTrace())


def test_design_serve_report_and_numpy_swap_note():
    uf, inputs_fn = BENCH_CASES["descriptor"]()
    design = compile_pipeline(uf, options=CompileOptions(
        backend="numpy", device="cpu"))
    frames = _frames(inputs_fn, 5)
    with design.serve(config=ServeConfig(max_batch=4, max_delay_ms=10.0),
                      device="cpu") as srv:
        outs = [f.result(timeout=WAIT_S) for f in srv.submit_many(frames)]
        assert srv.stats.backend == "kernels"
    for fr, out in zip(frames, outs):
        assert isinstance(out, tuple)
        assert _same(out, design.run(fr, backend="numpy"))
    note = [n for n in design.notes if "swapped to 'kernels'" in n]
    assert len(note) == 1
    report = design.report()
    assert " -- serve --" in report and "backend=kernels" in report
    assert any("latency p50" in ln for ln in report.splitlines())
    with design.serve(config=ServeConfig(max_batch=2), device="cpu"):
        pass
    assert design.notes.count(note[0]) == 1
    with pytest.raises(TypeError):
        design.serve(max_batch=2)            # no loose config keywords
    with pytest.raises(TypeError):
        ServeConfig(donate=True)             # the engine has no donation


def test_close_is_bounded_and_raises_when_the_loop_hangs(designs,
                                                         monkeypatch):
    d, inputs_fn, _ = designs["pyramid"]
    gate = threading.Event()
    wait = InflightBatch.wait

    def held(self):
        gate.wait(WAIT_S)
        return wait(self)

    monkeypatch.setattr(InflightBatch, "wait", held)
    srv = FrameServer(ServeConfig(max_batch=1, warmup=False))
    srv.register(d, device="cpu")
    srv.start()
    fut = srv.submit(inputs_fn(np.random.RandomState(0)))
    try:
        with pytest.raises(RuntimeError, match="did not stop"):
            srv.close(timeout=0.5)
    finally:
        gate.set()
    fut.result(timeout=WAIT_S)
    srv._thread.join(WAIT_S)
    assert not srv._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(inputs_fn(np.random.RandomState(1)))


def test_submit_errors_and_config_validation(designs):
    d, _, _ = designs["pyramid"]
    with FrameServer(ServeConfig(max_batch=2)) as srv:
        srv.register(d, device="cpu")
        with pytest.raises(KeyError):
            srv.submit({"x": np.zeros((2, 2))}, app="nope")
    with pytest.raises(RuntimeError):
        srv.submit({"x": np.zeros((2, 2))})
    with pytest.raises(RuntimeError, match="not started"):
        FrameServer().submit({"x": np.zeros((2, 2))})
    for bad in (dict(depth=0), dict(max_batch=0), dict(max_queue=0),
                dict(max_delay_ms=0), dict(topup_hold_ms=-1)):
        with pytest.raises(ValueError):
            ServeConfig(**bad)


def test_continuous_batching_drains_partials_without_deadline(designs):
    d, inputs_fn, ref_out = designs["convolution"]
    frames = _frames(inputs_fn, 5)
    cfg = ServeConfig(max_batch=4, max_delay_ms=3600 * 1e3, continuous=True)
    with serve_design(d, device="cpu", config=cfg) as srv:
        futs = srv.submit_many(frames)
        done, pending = concurrent.futures.wait(futs, timeout=WAIT_S)
        assert not pending
        outs = [f.result() for f in futs]
        assert srv.stats.topup_flushes > 0
    _check_served(d, ref_out, frames, outs)


def test_a_bad_frame_fails_its_batch_only(designs):
    d, inputs_fn, _ = designs["convolution"]
    with serve_design(d, device="cpu", config=ServeConfig(
            max_batch=2, warmup=False)) as srv:
        bad = srv.submit({"nope": np.zeros((3, 3), np.int64)})
        with pytest.raises(KeyError):
            bad.result(timeout=WAIT_S)
        good = srv.submit(inputs_fn(np.random.RandomState(0)))
        assert good.result(timeout=WAIT_S).shape == (40, 96)
        assert srv.health.live


def test_register_and_serve_raise_without_a_card(designs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    uf, _ = BENCH_CASES["convolution"]()
    design = compile_pipeline(uf)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FrameServer().register(design)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        design.serve()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FrameServer(ServeConfig(devices=["cuda", "cpu"])).register(design)


def test_status_cli_on_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.serve", "--status", "--device",
         "cpu", "--frames", "6", "--json"],
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    snap = json.loads(proc.stdout[:proc.stdout.rindex("}") + 1])
    assert snap["live"] and snap["ready"]
    assert {a: s["frames_out"] for a, s in snap["apps"].items()} == \
        {"convolution": 6, "stereo": 6}
    assert "serve-status: OK" in proc.stdout
