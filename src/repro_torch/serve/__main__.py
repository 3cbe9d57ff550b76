"""Serving-tier status CLI: ``python -m repro_torch.serve --status``.

Boots a frame server over one or more registered apps (small bench-case
sizes), runs warmup, optionally pushes a burst of synthetic traffic, and
prints the control plane's health surface — liveness/readiness, per-app
latency quantiles, shed counters, batch-occupancy histograms, and the
warmup progress — as the human report or a JSON snapshot (``--json``).

    PYTHONPATH=src python -m repro_torch.serve --status            # card
    PYTHONPATH=src python -m repro_torch.serve --status --device cpu
    PYTHONPATH=src python -m repro_torch.serve --status --app convolution \\
        --frames 32 --json

Frames run on the card unless ``--device cpu`` is given (without a card
that is required).  Exit status is 0 only when the server reports
live+ready and every submitted frame completed.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

# the longest a submitted frame may take before the probe reports it failed
FRAME_TIMEOUT_S = 600


def main(argv: Optional[List[str]] = None) -> int:
    import numpy as np

    from ..apps import BENCH_CASES
    from ..core import CompileOptions, compile_pipeline
    from . import FrameServer, ServeConfig

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serve",
        description="frame-serving control plane status probe")
    ap.add_argument("--status", action="store_true",
                    help="boot, warm up, push traffic, report health")
    ap.add_argument("--app", action="append", default=[],
                    choices=sorted(BENCH_CASES),
                    help="app(s) to register (default: convolution, stereo)")
    ap.add_argument("--frames", type=int, default=16,
                    help="synthetic frames to push per app (0 = none)")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--backend", default="kernels",
                    choices=("torch", "kernels"))
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="where the frames run (default cuda)")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the warmup-before-traffic path")
    ap.add_argument("--json", action="store_true",
                    help="print the machine-readable health snapshot")
    args = ap.parse_args(argv)
    if not args.status:
        ap.error("nothing to do (pass --status)")

    apps = args.app or ["convolution", "stereo"]
    cfg = ServeConfig(max_batch=args.max_batch,
                      warmup=not args.no_warmup)
    srv = FrameServer(config=cfg)
    inputs_fns = {}
    for name in apps:
        uf, inputs_fn = BENCH_CASES[name]()
        design = compile_pipeline(
            uf, options=CompileOptions(backend=args.backend,
                                       device=args.device))
        srv.register(design, name=name, backend=args.backend,
                     device=args.device,
                     warm_inputs=[inputs_fn(np.random.RandomState(0))])
        inputs_fns[name] = inputs_fn
    ok = True
    with srv:
        futs = []
        for name, fn in inputs_fns.items():
            for i in range(args.frames):
                futs.append(srv.submit(fn(np.random.RandomState(i)),
                                       app=name))
        for f in futs:
            try:
                f.result(timeout=FRAME_TIMEOUT_S)
            except Exception as e:       # noqa: B902 - report, keep probing
                print(f"frame failed: {e!r}", file=sys.stderr)
                ok = False
        # snapshot while the server is up: live+ready must both hold
        snap = srv.health.snapshot()
        lines = srv.stats.report_lines()
    if args.json:
        print(json.dumps(snap, indent=2))
    else:
        for ln in lines:
            print(ln)
    healthy = ok and snap["live"] and snap["ready"]
    print(f"serve-status: {'OK' if healthy else 'FAILED'} "
          f"(apps={','.join(apps)}, frames={args.frames}/app, "
          f"device={args.device or 'cuda'})")
    return 0 if healthy else 1


if __name__ == "__main__":
    sys.exit(main())
