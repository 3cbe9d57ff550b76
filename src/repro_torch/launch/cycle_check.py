"""Hold the cycle engines against each other on one app's netlist, at the
paper's size or at the app's ``sim_case``.

``simulate()`` on the card runs the cycle kernel (``csrc/cyclesim.cu``).
This script runs it beside the scalar engine (``hwsim/sim.py``, on the
host, one worker process per app, all at once) on the same compiled
netlist, one frame over the analytic FIFO depths, and requires every
``SimResult`` field the two share to be equal (the scalar engine skips no
cycles, so ``cycles_skipped`` and ``cycles_saved`` are left out).  It
prints one JSON line per app (cycles, the analytic ``cycles_per_frame()``
and their ratio, the kernel's device and wall seconds, the scalar
engine's seconds and microseconds a cycle), then the card's name and
power limit; it exits nonzero if any app disagrees.

    PYTHONPATH=src python -m repro_torch.launch.cycle_check \\
        [--apps stereo,descriptor] [--size paper|sim_case] [--device cpu]

``--device cpu`` runs the kernel's plain version in its place (per-cycle
torch operations: ``sim_case`` sizes only).  ``chip_smoke.py``'s ``cycle``
phase runs its cases through ``run_case`` in worker processes too.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from typing import Optional, Tuple

SIZES = ("paper", "sim_case")
_DESIGNS = {}


def design(app: str, size: str = "sim_case"):
    """An app compiled once per process: at the paper's size (its
    pipeline's defaults) or its ``sim_case``."""
    if (app, size) not in _DESIGNS:
        from .. import compile_pipeline
        from ..apps import PIPELINES, SIM_CASES
        if size == "paper":
            uf = PIPELINES[app]()
            d = compile_pipeline(uf)
        elif size == "sim_case":
            uf, T, _hand = SIM_CASES[app]()
            d = compile_pipeline(uf, T=T)
        else:
            raise ValueError(f"size must be one of {SIZES}, got {size!r}")
        _DESIGNS[app, size] = (uf, d)
    return _DESIGNS[app, size][1]


def summary(res) -> dict:
    """Every SimResult field but the engine's name."""
    d = dataclasses.asdict(res)
    d.pop("engine")
    return d


def scalar_view(s: dict) -> dict:
    """The fields the scalar engine shares with the packed-state engines
    (it skips no cycles)."""
    return {k: v for k, v in s.items()
            if k not in ("cycles_skipped", "cycles_saved")}


def summary_err(a: dict, b: dict) -> int:
    """Largest absolute difference over two summaries' cycle counts and
    per-edge numbers (0 when they agree)."""
    pairs = [(a["cycles"], b["cycles"]), (a["sink_tokens"], b["sink_tokens"])]
    for ea, eb in zip(a["occupancy"]["per_edge"], b["occupancy"]["per_edge"]):
        pairs += [(ea[k], eb[k]) for k in ("hwm", "hwm_cycle", "hwm_frame",
                                           "pushed", "popped")]
    return max(abs(int(x) - int(y)) for x, y in pairs)


def worker_init() -> None:
    """A worker process's set-up: one torch thread, so that several
    workers running the plain version do not crowd each other's cores."""
    import torch
    torch.set_num_threads(1)


def run_case(case: dict, engine: str, device: Optional[str] = None
             ) -> Tuple[dict, float]:
    """One case (``app``, ``size`` (default ``"sim_case"``), ``frames``,
    ``unbounded``, ``jump``, optional ``max_cycles`` and ``zero``: edges
    set to depth 0) on ``engine``: ``"vector"`` (the kernel on ``device``
    "cuda", its plain version on "cpu") or ``"scalar"``.  Returns the
    result's summary and the seconds of its ``run()``."""
    from ..hwsim import VectorSim, build_sim
    d = design(case["app"], case.get("size", "sim_case"))
    depths = dict(d.fifo.depth)
    depths.update({tuple(k): 0 for k in case.get("zero", ())})
    if engine == "scalar":
        sim = build_sim(d.modules, d.edges, depths,
                        unbounded=case["unbounded"], frames=case["frames"])
        t0 = time.perf_counter()
        res = sim.run(max_cycles=case.get("max_cycles"))
    else:
        sim = VectorSim(d.modules, d.edges, depths,
                        unbounded=case["unbounded"], frames=case["frames"],
                        device=device)
        t0 = time.perf_counter()
        res = sim.run(max_cycles=case.get("max_cycles"),
                      event_jump=case["jump"])
    return summary(res), time.perf_counter() - t0


def _simulate(app: str, size: str, device: str) -> Tuple[dict, dict]:
    """``simulate()`` through the design's entry point: its summary and
    its times (wall, and on the card the kernel's device time)."""
    from .. import SimOptions
    d = design(app, size)
    opts = SimOptions(engine="vector", device=device)
    box = []
    t0 = time.perf_counter()
    if device == "cpu":
        box.append(d.simulate(options=opts))
        times = {}
    else:
        from ..kernels.timing import device_events
        _tot, names = device_events(
            lambda: box.append(d.simulate(options=opts)), 1, warmup=0)
        times = {"kernel_s": sum(v for n, v in names.items()
                                 if "cyclesim" in n) / 1e3}
    times["wall_s"] = time.perf_counter() - t0
    return summary(box[0]), times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--apps", default="stereo,descriptor")
    ap.add_argument("--size", default="paper", choices=SIZES)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    apps = [a for a in args.apps.split(",") if a]
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("cycle_check: needs a CUDA card "
                             "(or --device cpu)")
    case = dict(size=args.size, frames=1, unbounded=False, jump=True)
    bad = 0
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(len(apps), mp_context=ctx,
                             initializer=worker_init) as pool:
        scalar = {app: pool.submit(run_case, dict(case, app=app), "scalar")
                  for app in apps}
        for app in apps:
            got, times = _simulate(app, args.size, args.device)
            want, scalar_s = scalar[app].result()
            uf, d = _DESIGNS[app, args.size]
            cpf = d.cycles_per_frame()
            equal = scalar_view(got) == scalar_view(want)
            bad += not equal
            print(json.dumps({
                "app": app, "size": args.size, "shape": [uf.h, uf.w],
                "T": str(d.T),
                "modules": len(d.modules), "edges": len(d.edges),
                "device": args.device, "cycles": got["cycles"],
                "cycles_per_frame": cpf, "over_analytic": got["cycles"] / cpf,
                "deadlock": got["deadlock"], "skipped":
                got["cycles_skipped"], "scalar_cycles": want["cycles"],
                "equal": equal, "max_abs_err": summary_err(got, want),
                **times, "scalar_s": scalar_s,
                "scalar_us_per_cycle": scalar_s * 1e6 / want["cycles"]}),
                flush=True)
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0], flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
