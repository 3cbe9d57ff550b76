"""The port stands alone and runs on the card by default.

- It imports neither ``jax`` nor anything of ``repro``: checked in a fresh
  process that lowers and runs every app, compiles, simulates and sizes
  the FIFOs of one through the hardware half (the packed-state engine, a
  population, the explorer and the ingest model included), verifies it
  and serves a few of its frames, serves a reduced model, and takes a
  reduced train step, a checkpoint round trip and a data batch; and by a
  scan of its sources.
- Compiling loads neither the lowering nor torch.
- Its entry points never fall back quietly to the CPU: without a card and
  without ``device="cpu"`` they raise.
"""
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import CompileOptions, compile_pipeline  # noqa: E402
from repro_torch.apps import BENCH_CASES  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FORBIDDEN = re.compile(r"^\s*(from|import)\s+(jax|repro)\b(?!_torch)",
                        re.MULTILINE)


def test_port_runs_without_importing_jax_or_repro():
    code = textwrap.dedent("""
        import sys
        import numpy as np
        from repro_torch import compile_pipeline
        from repro_torch.apps import BENCH_CASES
        for name, case in BENCH_CASES.items():
            uf, inputs = case()
            d = compile_pipeline(uf)
            rng = np.random.RandomState(0)
            for backend in ("torch", "kernels"):
                d.run(inputs(rng), backend=backend, device="cpu")
                d.run_batch(inputs(rng, frames=2), backend=backend,
                            device="cpu")
        from repro_torch import CompileOptions, SimOptions
        from repro_torch.apps import SIM_CASES
        uf, T, hand = SIM_CASES["pyramid"]()
        d = compile_pipeline(uf, T=T, options=CompileOptions(
            fifo_solver="sim", manual_fifo_overrides=hand, device="cpu"))
        d.simulate(options=SimOptions(frames=2, engine="vector",
                                      device="cpu"))
        assert d.check_schedule() and d.fifo_sim_proven
        from repro_torch import ExploreOptions
        from repro_torch.hwsim import PopulationSim, simulate_ingest
        PopulationSim(d.modules, d.edges, [dict(d.fifo.depth)] * 2,
                      device="cpu").run()
        d.explore(ExploreOptions(max_points=2, device="cpu"))
        simulate_ingest(32, 8.0, 1, 4)
        d.run_batch(inputs(rng, frames=2), backend="numpy")
        assert d.verify(options=SimOptions(device="cpu")).ok
        from repro_torch.serve import ServeConfig
        frames = [{"pyramid.in": np.random.RandomState(i).randint(
            0, 256, (uf.h, uf.w))} for i in range(3)]
        with d.serve(config=ServeConfig(max_batch=2), device="cpu",
                     warm_inputs=frames[:1]) as srv:
            for f in srv.submit_many(frames):
                f.result(timeout=120)
        assert " -- verify --" in d.report() and " -- serve --" in d.report()
        from repro_torch.launch.serve import main
        main(["--arch", "gemma3-1b", "--smoke", "--batch", "2",
              "--prompt-len", "3", "--gen", "2", "--device", "cpu"])
        import tempfile
        import torch
        from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
        from repro_torch.configs import ARCHS, reduced
        from repro_torch.data import DataConfig, make_dataset
        from repro_torch.models import init_params
        from repro_torch.optim import adamw_init
        from repro_torch.train import build_train_step
        cfg = reduced(ARCHS["gemma3-1b"])
        batch = next(make_dataset(DataConfig(8, 2, cfg.vocab), device="cpu"))
        params = init_params(cfg, 0, "cpu")
        params, opt, m = build_train_step(cfg)(params, adamw_init(params),
                                               batch)
        assert torch.isfinite(m["loss"])
        with tempfile.TemporaryDirectory() as d:
            save_checkpoint(d, 1, (params, opt))
            back = restore_checkpoint(d, 1, (params, opt))
        assert torch.equal(back[0]["embed"], params["embed"])
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        print("LOADED", bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(d, n) for n in names
                  if n.endswith((".py", ".cu", ".cuh"))]
    return files


def test_port_sources_import_nothing_of_jax_or_repro():
    files = _port_files()
    assert len(files) > 20
    # the training half is scanned too
    for part in ("optim", "checkpoint", "data", "train"):
        assert any(os.sep + part + os.sep in f for f in files), part
    assert any(f.endswith(os.path.join("launch", "train.py")) for f in files)
    bad = [f for f in files if _FORBIDDEN.search(Path(f).read_text())]
    assert not bad


def test_distributed_layer_imports_nothing_of_jax_or_repro():
    """The distributed layer (parallel/, launch/{mesh,dryrun,sweep},
    models/moe_a2a) is scanned, and in a fresh process it plans a pipeline,
    maps every arch's parameters on both production meshes and dry-runs a
    reduced train step on a fake 2x4 mesh without loading jax or repro."""
    files = _port_files()
    for part in (("parallel", "__init__.py"), ("parallel", "mapper.py"),
                 ("parallel", "pipeline.py"), ("parallel", "comm.py"),
                 ("parallel", "spmd.py"), ("launch", "mesh.py"),
                 ("launch", "dryrun.py"), ("launch", "sweep.py"),
                 ("models", "moe_a2a.py")):
        assert any(f.endswith(os.path.join(*part)) for f in files), part
    code = textwrap.dedent("""
        import sys
        from repro_torch.configs import ARCHS, reduced
        from repro_torch.launch import sweep  # noqa: F401
        from repro_torch.launch.dryrun import fake_mesh, lower_cell
        from repro_torch.launch.mesh import production_shape
        from repro_torch.models.moe_a2a import moe_ffn_a2a  # noqa: F401
        from repro_torch.parallel import param_shardings
        from repro_torch.parallel.pipeline import plan_1f1b
        assert plan_1f1b(4, 8).stash_per_stage == [4, 3, 2, 1]
        for multi in (False, True):
            for cfg in ARCHS.values():
                param_shardings(cfg, production_shape(multi_pod=multi))
        cfg = reduced(ARCHS["granite-moe-3b-a800m"]).replace(
            attn_impl="blocked", moe_impl="a2a", dist_norm=True)
        art = lower_cell(cfg, "reduced", False, shape=(16, 4, "train"),
                         mesh=fake_mesh((2, 4), ("data", "model")))
        assert art["collectives"]["all-to-all"] > 0
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        print("LOADED", bad)
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout


def test_compiling_loads_no_lowering_torch_jax_or_repro():
    """The hardware half alone (compile, simulate, size the FIFOs, report)
    in a fresh process loads neither ``repro_torch.core.lowering`` nor the
    kernels nor torch, and nothing of jax or ``repro``."""
    code = textwrap.dedent("""
        import sys
        from repro_torch import SimOptions, compile_pipeline
        from repro_torch.apps import SIM_CASES
        uf, T, _ = SIM_CASES["pyramid"]()
        d = compile_pipeline(uf, T=T)
        opts = SimOptions(device="cpu")    # the scalar engine
        d.simulate(options=opts); d.optimize_fifos(options=opts); d.report()
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro", "torch")
                     or m.startswith(("repro_torch.core.lowering",
                                      "repro_torch.kernels")))
        print("LOADED", bad)
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout


def test_source_scan_catches_a_reference_import():
    assert _FORBIDDEN.search("x = 1\nfrom repro.core import hwimg\n")
    assert _FORBIDDEN.search("import jax.numpy as jnp\n")
    assert not _FORBIDDEN.search("from repro_torch.core import hwimg\n")


@pytest.mark.parametrize("entry", ["lower", "run", "run_batch",
                                   "run_batch_device"])
def test_entry_points_raise_without_a_card(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    uf, inputs = BENCH_CASES["convolution"]()
    rng = np.random.RandomState(0)
    design = compile_pipeline(uf, options=CompileOptions(backend="kernels"))
    args = {"lower": (), "run": (inputs(rng),),
            "run_batch": (inputs(rng, frames=2),),
            "run_batch_device": (inputs(rng, frames=2),)}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(design, entry)(*args)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(design, entry)(*args, device="cuda")
    assert getattr(design, entry)(*args, device="cpu") is not None


def test_training_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    """launch.train and make_dataset want the card unless given the CPU."""
    from repro_torch.data import DataConfig, make_dataset
    from repro_torch.launch import train as launch_train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "gemma3-1b", "--smoke", "--steps", "1",
                           "--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(make_dataset(DataConfig(8, 2, 50)))
    assert next(make_dataset(DataConfig(8, 2, 50), device="cpu"))[
        "tokens"].device.type == "cpu"
    res = launch_train.main(["--arch", "gemma3-1b", "--smoke", "--steps", "1",
                             "--batch", "2", "--seq", "8", "--ckpt-dir",
                             str(tmp_path), "--device", "cpu"])
    assert res.end_step == 1


def test_unknown_backend_and_device_are_refused():
    with pytest.raises(ValueError, match="backend"):
        CompileOptions(backend="pallas")
    uf, inputs = BENCH_CASES["stereo"]()
    design = compile_pipeline(uf)
    with pytest.raises(ValueError, match="device"):
        design.lower(device="meta")
