"""Run a command and print each line of its standard output with the
seconds since the start in front of it, so that the phases of a script
that prints one line a phase (``chip_smoke.py``) can be timed, two
revisions in one call:

  python3 src/repro_torch/launch/line_times.py -- python3 chip_smoke.py

Standard error passes through.  Exits with the command's code.
"""
from __future__ import annotations

import subprocess
import sys
import time


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--"]:
        argv = argv[1:]
    t0 = time.perf_counter()
    with subprocess.Popen(argv, stdout=subprocess.PIPE, text=True,
                          bufsize=1) as proc:
        for line in proc.stdout:
            print(f"{time.perf_counter() - t0:.3f} {line}", end="",
                  flush=True)
    return proc.returncode


if __name__ == "__main__":
    sys.exit(main())
