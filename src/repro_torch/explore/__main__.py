"""CLI for the design-space explorer.

    python -m repro_torch.explore --app flow --budget 60
    python -m repro_torch.explore --all-apps --max-points 24 --check
    python -m repro_torch.explore --app flow --device cpu --engine scalar

``--check`` turns the run into a CI gate: a non-empty Pareto front per
app, the hand-annotated design matched-or-dominated (cheapest auto point
at the hand design's throughput within 10% of the hand area, or the hand
point strictly dominated), and the wall clock within the budget plus a
fixed compile grace.  ``--device`` places the cycle engines: "cuda" (the
default; it raises without a card) or "cpu" (their plain versions).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List

from ..core.compile import ExploreOptions
from .engine import ExploreResult, explore_app

# --check: auto must come within this factor of the hand design's area
# at the hand design's throughput ("matched or dominated")
CHECK_AREA_RATIO = 1.10
# --check: compile+trace time outside the evaluation budget that still
# counts as "within budget" (first batch always runs; the kernel's first
# build is real)
CHECK_GRACE_S = 90.0


def _check(res: ExploreResult, budget: float | None) -> List[str]:
    failures = []
    if not res.front.points:
        failures.append(f"{res.app}: empty Pareto front")
        return failures
    if res.hand is not None:
        ratio = res.best_area_ratio()
        dominated = res.front.dominated(res.hand)
        if not dominated and (ratio is None or ratio > CHECK_AREA_RATIO):
            failures.append(
                f"{res.app}: hand design neither dominated nor matched "
                f"(best_area_ratio={ratio})")
    if budget is not None and res.wall_seconds > budget + CHECK_GRACE_S:
        failures.append(
            f"{res.app}: wall clock {res.wall_seconds:.1f}s exceeded "
            f"budget {budget:.0f}s (+{CHECK_GRACE_S:.0f}s grace)")
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.explore",
        description="Pareto design-space exploration over the cycle "
                    "simulator")
    ap.add_argument("--app", action="append", default=[],
                    help="app to sweep (repeatable; see "
                         "repro_torch.apps.SIM_CASES)")
    ap.add_argument("--all-apps", action="store_true",
                    help="sweep every registered app")
    ap.add_argument("--budget", type=float, default=None, metavar="S",
                    help="wall-clock budget per app in seconds")
    ap.add_argument("--max-points", type=int, default=None,
                    help="deterministic cap on candidates per app")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--population", type=int, default=16,
                    help="designs per batched simulator kernel")
    ap.add_argument("--engine", default="population",
                    choices=("population", "vector", "scalar"))
    ap.add_argument("--device", default=None,
                    help="device of the cycle engines: cuda (default) or "
                         "cpu")
    ap.add_argument("--check", action="store_true",
                    help="CI gate: non-empty front, hand matched-or-"
                         "dominated, wall clock within budget")
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON object keyed by app")
    args = ap.parse_args(argv)

    if args.all_apps:
        from ..apps import SIM_CASES
        apps = sorted(SIM_CASES)
    else:
        apps = args.app or ["flow"]
    options = ExploreOptions(
        budget_s=args.budget, max_points=args.max_points, seed=args.seed,
        frames=args.frames, population=args.population, engine=args.engine,
        device=args.device)

    failures: List[str] = []
    blob = {}
    for app in apps:
        res = explore_app(app, options)
        if args.json:
            blob[app] = res.as_dict()
        else:
            print("\n".join(res.report_lines()))
            print()
        if args.check:
            failures.extend(_check(res, args.budget))
    if args.json:
        print(json.dumps(blob, indent=2, sort_keys=True))
    if failures:
        for f in failures:
            print(f"CHECK FAILED: {f}", file=sys.stderr)
        return 1
    if args.check:
        print(f"explore check passed for {', '.join(apps)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
