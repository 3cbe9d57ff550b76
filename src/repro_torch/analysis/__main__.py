"""CLI for the static verifier: ``python -m repro_torch.analysis``.

Runs the three passes (value ranges, IR rewrite invariants, handshake
linting + the three-way differential oracle) over registered apps::

    python -m repro_torch.analysis --app convolution
    python -m repro_torch.analysis --all-apps --check   # the verify gate
    python -m repro_torch.analysis --all-apps --json    # a summary
    python -m repro_torch.analysis --all-apps --check --device cpu

``--check`` exits nonzero unless, for every selected app under BOTH fifo
solvers (analytic z3 and simulation-guided "sim"): every integer node is
proven wrap-free or carries a wrap witness, the rewrite fixpoint is
structurally clean, the netlist is certified (or sim-proven) deadlock-free,
and ``static_lower <= simulated hwm <= static_upper`` holds per FIFO.
``--json`` prints per-(app, solver) verdicts and the certified edge
fraction.  ``--device`` is where the simulations run (``fifo_solver="sim"``
and the oracle): the cycle kernel on "cuda" (the default, which raises
without a card), the scalar engine on "cpu".
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from . import VerifyResult, verify_design

# apps the cycle simulator supports end-to-end; ``--all-apps`` walks these.
# Every (app, solver) pair runs the full oracle — including pyramid's
# analytic depths, which the cross-arm broadcast provisioning
# (analysis/traces.py -> core/buffers.py extra_slots) made deadlock-free.
HWSIM_APPS = ("convolution", "descriptor", "flow", "stereo", "pyramid")


def _run_one(name: str, solver: str, engine: str, sim: bool,
             device: Optional[str]) -> VerifyResult:
    from ..apps import SIM_CASES
    from ..core import CompileOptions, compile_pipeline
    uf, T, _hand = SIM_CASES[name]()
    design = compile_pipeline(uf, T=T, options=CompileOptions(
        fifo_solver=solver, device=device))
    res = verify_design(design, sim=sim, engine=engine, device=device)
    res.name = f"{name}[{solver}]"
    return res


def main(argv: Optional[List[str]] = None) -> int:
    from ..apps import SIM_CASES
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static verification over registered apps")
    ap.add_argument("--app", action="append", default=[],
                    choices=sorted(SIM_CASES),
                    help="verify one app (repeatable)")
    ap.add_argument("--all-apps", action="store_true",
                    help="verify every hwsim-supported app "
                         f"({', '.join(HWSIM_APPS)})")
    ap.add_argument("--solver", choices=("z3", "sim", "both"),
                    default="both", help="fifo solver(s) to verify under")
    ap.add_argument("--engine", default="auto",
                    help="hwsim engine for the differential oracle")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="where the simulations run (default cuda)")
    ap.add_argument("--no-sim", action="store_true",
                    help="skip the simulation cross-check (static only)")
    ap.add_argument("--check", action="store_true",
                    help="exit nonzero on any verification failure")
    ap.add_argument("--json", action="store_true",
                    help="emit a machine-readable summary (per app/solver: "
                         "verdict, certified_edge_fraction, oracle outcome)")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="per-node / per-edge detail")
    args = ap.parse_args(argv)

    names = list(HWSIM_APPS) if args.all_apps or not args.app else args.app
    solvers = ("z3", "sim") if args.solver == "both" else (args.solver,)
    failures: List[str] = []
    summary: dict = {}
    for name in names:
        for solver in solvers:
            try:
                res = _run_one(name, solver, args.engine,
                               sim=not args.no_sim, device=args.device)
            except Exception as exc:           # compile/verify blew up
                print(f"verify {name}[{solver}]: ERROR: {exc!r}",
                      file=sys.stderr if args.json else sys.stdout)
                failures.append(f"{name}[{solver}]")
                continue
            if not args.json:
                print("\n".join(res.report_lines(verbose=args.verbose)))
            summary.setdefault(name, {})[solver] = {
                "ok": res.ok,
                "verdict": res.handshake.verdict,
                "edges": len(res.handshake.edges),
                "certified_edge_fraction":
                    res.handshake.certified_edge_fraction,
                "cross_ok": None if res.cross is None else res.cross.ok,
            }
            if not res.ok:
                failures.append(res.name)
    if args.json:
        import json
        print(json.dumps(summary, indent=2, sort_keys=True))
    if failures:
        if not args.json:
            print(f"\nFAILED: {', '.join(failures)}")
        return 1 if args.check else 0
    if not args.json:
        print(f"\nall {len(names) * len(solvers)} verification runs ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
