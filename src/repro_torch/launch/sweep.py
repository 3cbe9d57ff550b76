"""Run the full dry-run sweep: every runnable (arch x shape) cell on both
meshes, one subprocess per cell (each its own fake process group and
memory); the counterpart of ``repro.launch.sweep``.

  PYTHONPATH=src python -m repro_torch.launch.sweep [--out artifacts] \\
      [--mesh both]

A cell that fails is reported with the tail of its error, never retried
another way.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="artifacts")
    ap.add_argument("--mesh", default="both", choices=["pod", "multipod",
                                                       "both"])
    ap.add_argument("--only-arch", default=None)
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    from ..configs import cells

    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]
    todo = []
    for arch, shape in cells():
        if args.only_arch and arch != args.only_arch:
            continue
        for mp in meshes:
            tag = "multipod" if mp else "pod"
            path = os.path.join(args.out,
                                f"{arch}__{shape}__{tag}__baseline.json")
            if args.skip_existing and os.path.exists(path):
                continue
            todo.append((arch, shape, mp))

    print(f"sweep: {len(todo)} cells")
    t0 = time.time()
    failures = []
    for i, (arch, shape, mp) in enumerate(todo):
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--out", args.out]
        if mp:
            cmd.append("--multipod")
        t1 = time.time()
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=3000)
        dt = time.time() - t1
        status = "ok" if r.returncode == 0 else "FAIL"
        print(f"[{i+1}/{len(todo)}] {arch} x {shape} x "
              f"{'multipod' if mp else 'pod'}: {status} ({dt:.0f}s, "
              f"total {(time.time()-t0)/60:.1f}m)", flush=True)
        if r.returncode != 0:
            failures.append((arch, shape, mp))
            tail = (r.stderr or r.stdout).splitlines()[-15:]
            print("    " + "\n    ".join(tail), flush=True)
    print(f"done: {len(todo) - len(failures)}/{len(todo)} ok, "
          f"{len(failures)} failures: {failures}")
    return failures


if __name__ == "__main__":
    main()
