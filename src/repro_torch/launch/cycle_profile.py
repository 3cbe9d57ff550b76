"""Profile the cycle kernel (``csrc/cyclesim.cu``) on the card: where a
simulated cycle's time goes, and the latencies that bound it.

    PYTHONPATH=src python -m repro_torch.launch.cycle_profile \\
        [--cases flow_1080p_40k,...] [--iters 3] [--out FILE]

It builds ``cyclesim.cu`` a second time with ``-DCYCLESIM_PROFILE`` (the
path's build never carries the define; see ``csrc/cyc_profile.cuh``), under
a library of its own, and prints one JSON line each:

- ``probe``: the card's latencies, each from one dependent chain timed
  with ``clock64()`` in ``cyc_profile.cuh``: a shared-memory pointer chase,
  a shared store then load, ``__ballot_sync``, ``__any_sync``,
  ``__reduce_or_sync``, ``__reduce_min_sync``, ``__syncthreads`` and
  ``__syncthreads_or`` over 96 threads, an emulated 64-bit remainder, a
  global pointer chase through L2, and a ``clock64()`` read; clocks and ns
  a step, and the SM clock they imply;
- per case (a netlist at the paper's size or its ``sim_case``, cut at a
  horizon): the path build's device time (the profiler's kernel events)
  and ns a simulated cycle, then the profiling build's clocks per loop
  iteration in each phase (``STAMPS``, thread 0's view, barrier waits
  included) and the chain bound (``chain_bound_ms``).

Run by its path with an older revision's ``src`` first on ``PYTHONPATH``,
it profiles that revision's kernel through that revision's wrapper: this
is how the earlier block-per-design kernel's split in PERF.md is taken
again.  That source has no stamps; it gets them at its phase boundaries
from ``stamp_block_source`` (the anchors are its barrier lines, and a
missing anchor raises), and its wrapper, which takes no launcher, has its
launcher lookup routed to the profiling build.  The last line is the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

HEADER_DIR = Path(__file__).resolve().parents[1] / "csrc"
# thread 0's clock counters, in the order of the CYC_STAMP indices
STAMPS = ("stop", "modules_push", "edges_pop", "modules_launch",
          "advance_vote", "jump", "frame_ends")
N_COUNTERS = 8 + 1          # CYC_NSTAMP counters, then the loop count
# (app, size, frames, horizon or None for the whole run)
CASES = {
    "flow_1080p_40k": ("flow", "paper", 1, 40_000),
    "descriptor_1080p_40k": ("descriptor", "paper", 1, 40_000),
    "convolution_1080p_40k": ("convolution", "paper", 1, 40_000),
    "stereo_paper_40k": ("stereo", "paper", 1, 40_000),
    "pyramid_1080p_40k": ("pyramid", "paper", 1, 40_000),
    "flow_sim_2f": ("flow", "sim_case", 2, None),
}
# probe id -> (name, threads, steps)
PROBES = {0: ("smem_chase", 32, 100_000), 1: ("smem_store_load", 32, 100_000),
          2: ("ballot", 32, 100_000), 3: ("any", 32, 100_000),
          4: ("reduce_or", 32, 100_000), 5: ("reduce_min", 32, 100_000),
          6: ("syncthreads_96", 96, 100_000),
          7: ("syncthreads_or_96", 96, 100_000),
          8: ("i64_rem", 32, 20_000), 9: ("l2_chase", 32, 20_000),
          10: ("clock64", 32, 100_000)}
L2_CHASE_ENTRIES = 1 << 20          # 8 MB: past L1, inside L2

# (anchor, replacement) in the block-per-design kernel's source: stamp 0
# after the done vote, 1-3 after the barriers of phase A, the edge phase
# and phase B, 4 after the move vote, 5 after the event jump, 6 after the
# frame ends
_BLOCK_STAMPS = (
    ("  const i64 H = n.H;\n", "  const i64 H = n.H;\n  CYC_PROF_BEGIN;\n"),
    ("    if (!__syncthreads_or(notdone)) { code = kDone; break; }\n",
     "    if (!__syncthreads_or(notdone)) { code = kDone; break; }\n"
     "    CYC_STAMP(0); CYC_LOOP();\n"),
    ("    __syncthreads();\n    // edges: the push lands",
     "    __syncthreads();\n    CYC_STAMP(1);\n    // edges: the push lands"),
    ("    __syncthreads();\n    // phase B, modules",
     "    __syncthreads();\n    CYC_STAMP(2);\n    // phase B, modules"),
    ("    __syncthreads();\n    // edges: a launch advances",
     "    __syncthreads();\n    CYC_STAMP(3);\n"
     "    // edges: a launch advances"),
    ("    moved = __syncthreads_or(moved);\n",
     "    moved = __syncthreads_or(moved);\n    CYC_STAMP(4);\n"),
    ("    // frame ends: the sink",
     "    CYC_STAMP(5);\n    // frame ends: the sink"),
    ("    }\n  }\n\n  i64* st = state",
     "    }\n    CYC_STAMP(6);\n  }\n\n  CYC_PROF_END;\n  i64* st = state"),
)


def stamp_block_source(text: str) -> str:
    """The block-per-design kernel's source with the profiling header
    included and its phase stamps (``_BLOCK_STAMPS``) put in."""
    out = '#include "cyc_profile.cuh"\n' + text
    for anchor, replacement in _BLOCK_STAMPS:
        if out.count(anchor) != 1:
            raise ValueError(f"anchor {anchor!r} found {out.count(anchor)} "
                             "times in the kernel source, not once")
        out = out.replace(anchor, replacement)
    return out


def profile_library():
    """The profiling build of this tree's ``csrc/cyclesim.cu`` (stamped
    first if its source has no stamps), built or loaded from the cache."""
    from repro_torch.kernels import _build
    text = (_build.CSRC / "cyclesim.cu").read_text()
    if "CYC_STAMP" not in text:
        text = stamp_block_source(text)
    flags = _build.NVCC_FLAGS + ("-DCYCLESIM_PROFILE", "-I", str(HEADER_DIR))
    h = hashlib.sha256(" ".join(flags).encode() + text.encode())
    h.update((HEADER_DIR / "cyc_profile.cuh").read_bytes())
    digest = h.hexdigest()[:16]
    src = _build.BUILD_DIR / "profile" / f"cyclesim-{digest}.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(text)
    key = f"profile/cyclesim-{digest}"
    _build._load([(key, src, src.with_suffix(".so"), flags)])
    return _build._LIBS[key]


@contextlib.contextmanager
def _earlier_wrapper_build(built):
    """Route the earlier wrapper's launcher lookups of ``cyclesim`` to the
    profiling build for the duration (that wrapper takes no launcher)."""
    from repro_torch.kernels import _build
    orig = _build.function

    def function(name, symbol, argtypes):
        if name != "cyclesim":
            return orig(name, symbol, argtypes)
        return _build._bind(built.lib, symbol, argtypes)

    _build.function = function
    try:
        yield
    finally:
        _build.function = orig


def probes(built) -> dict:
    """Each probe's clocks and ns a dependent step, and the SM clock."""
    import numpy as np
    import torch
    fn = built.lib.cyc_probe_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    perm = np.random.RandomState(0).permutation(L2_CHASE_ENTRIES)
    nxt = np.empty(L2_CHASE_ENTRIES, np.int64)
    nxt[perm] = np.roll(perm, -1)         # one cycle through every entry
    buf = torch.from_numpy(nxt).cuda()
    out = torch.zeros(3, dtype=torch.int64, device="cuda")
    rows, clocks, ns = {}, 0, 0
    stream = torch.cuda.current_stream().cuda_stream
    for which, (name, threads, steps) in PROBES.items():
        err = fn(which, steps, threads, 1_000_000_007, buf.data_ptr(),
                 out.data_ptr(), stream)
        if err:
            raise RuntimeError(f"probe {name}: cudaError_t {err}")
        torch.cuda.synchronize()
        c, g, _ = (int(v) for v in out.cpu())
        rows[name] = {"clocks": c / steps, "ns": g / steps}
        if name == "smem_chase":
            clocks, ns = c, g
    return {"probe": rows, "sm_mhz": clocks / ns * 1e3}


# dependent steps on one simulated cycle's chain in each form of the
# kernel (csrc/cyclesim.cu): the warp form's four ballots (pushes, unmet
# needs, launches, the done flag; its ring loads are issued a phase ahead
# of their use); the block form's two barriers and the shared loads
# between them.  chain_bound_ms multiplies them by the probed latencies
CHAIN_STEPS = {
    "warp": {"ballot": 4},
    "block": {"syncthreads_96": 2, "smem_chase": 3},
}


def chain_bound_ms(form: str, executed_cycles: int, probe: dict) -> float:
    """Executed cycles times the form's dependent steps a cycle times each
    step's measured latency (ns), in ms."""
    per_cycle = sum(n * probe["probe"][step]["ns"]
                    for step, n in CHAIN_STEPS[form].items())
    return executed_cycles * per_cycle / 1e6


def _case_sim(case: str):
    from repro_torch.hwsim import VectorSim
    from repro_torch.launch import cycle_check as cc
    app, size, frames, horizon = CASES[case]
    d = cc.design(app, size)
    return VectorSim(d.modules, d.edges, dict(d.fifo.depth), frames=frames,
                     device="cuda"), horizon


def kernel_time(run, iters: int):
    """``run()``'s result and the device ms per call of its cycle kernel
    launches (the profiler's kernel events)."""
    from repro_torch.kernels.timing import device_events
    box = []
    _tot, names = device_events(lambda: box.append(run()), iters)
    return box[-1], sum(v for n, v in names.items() if "cyclesim" in n)


def split(sim, horizon, built) -> dict:
    """One run of ``sim`` on the profiling build: thread 0's clocks per
    loop iteration in each phase (``STAMPS``) and in all of them."""
    import numpy as np
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.cyclesim import ops
    if hasattr(ops, "run_kernel"):
        # the profiling build's launcher, as the host-build tests pass theirs
        caps = torch.from_numpy(sim.cap[None].copy()).cuda()
        ops.run_kernel(sim, caps, horizon or sim._default_horizon(),
                       sim._stall_limit(), launcher=_build._bind(
                           built.lib, "cyclesim_launch", ops._ARGTYPES))
    else:                              # the earlier block-per-design wrapper
        with _earlier_wrapper_build(built):
            sim.run(max_cycles=horizon)
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * N_COUNTERS)()
    err = built.lib.cyc_prof_read(buf, 1)
    if err:
        raise RuntimeError(f"cyc_prof_read: cudaError_t {err}")
    acc = np.array(buf[:N_COUNTERS - 1], np.float64)
    loops = max(int(buf[N_COUNTERS - 1]), 1)
    return {"loops": loops,
            "stamped_clocks_per_loop": float(acc.sum() / loops),
            "split_clocks_per_loop": {name: float(acc[i] / loops)
                                      for i, name in enumerate(STAMPS)}}


def profile_case(case: str, built, iters: int) -> dict:
    """The path build's device time of ``case`` and the profiling build's
    split of its loop iterations."""
    sim, horizon = _case_sim(case)
    res, kernel_ms = kernel_time(lambda: sim.run(max_cycles=horizon), iters)
    row = {"case": case, "modules": sim.M, "edges": sim.E,
           "cycles": res.cycles,
           "executed": res.cycles - res.cycles_skipped,
           "kernel_ms": kernel_ms,
           "ns_per_cycle": kernel_ms * 1e6 / res.cycles,
           **split(sim, horizon, built)}
    from repro_torch.kernels.cyclesim import ops
    if hasattr(ops, "layout"):
        row.update(ops.layout(sim))
    else:                              # the earlier block-per-design wrapper
        row["form"] = "earlier block per design"
    return row


# the forms' crossover: chains of n Maps (a third throttled to 1/2 or 2/3,
# latencies 0-6, depths 0-2, 48 tokens a frame, 2 frames) and FLOW's
# sim_case, in each form
CROSSOVER_CHAINS = (8, 32, 64, 96, 128)


def chain_sim(n: int):
    """A chain of ``n`` Maps on the card (as ``CROSSOVER_CHAINS``)."""
    from fractions import Fraction
    from repro_torch.core.buffers import Edge
    from repro_torch.core.dtypes import UInt
    from repro_torch.core.rigel import Interface, RModule, ScheduleType
    from repro_torch.hwsim import VectorSim
    st = ScheduleType(UInt(8), 48, 1)
    rates = (Fraction(1), Fraction(1, 2), Fraction(1), Fraction(2, 3))
    mods = [RModule(f"m{i}", "Map", Interface("Static", st),
                    Interface("Static", st), rates[i % 4], i % 7)
            for i in range(n)]
    edges = [Edge(i, i + 1, 8, i % 7, 0) for i in range(n - 1)]
    return VectorSim(mods, edges, {(i, i + 1): i % 3 for i in range(n - 1)},
                     frames=2, device="cuda")


def crossover(iters: int) -> list:
    """ns a simulated cycle in each form, per netlist, and whether the two
    forms' results are equal."""
    import torch
    from repro_torch.kernels.cyclesim import ops
    sims = [(f"chain_{n}", chain_sim(n)) for n in CROSSOVER_CHAINS]
    sims.append(("flow_sim_2f", _case_sim("flow_sim_2f")[0]))
    rows = []
    for label, sim in sims:
        caps = torch.from_numpy(sim.cap[None].copy()).cuda()
        horizon, stall = sim._default_horizon(), sim._stall_limit()
        row = {"netlist": label, "modules": sim.M, "edges": sim.E}
        outs = {}
        for form in ("warp", "block"):
            if form == "warp" and ops.warp_slots(sim.M, sim.E) is None:
                continue
            out, ms = kernel_time(lambda: ops.run_kernel(
                sim, caps, horizon, stall, True, form=form), iters)
            outs[form] = out
            row[f"{form}_ns_per_cycle"] = ms * 1e6 / out[0][0]["t"]
            row["cycles"] = out[0][0]["t"]
        if len(outs) == 2:
            a, b = outs["warp"][0], outs["block"][0]
            row["equal"] = a[1:] == b[1:] and all(
                (a[0][k] == b[0][k]).all() if hasattr(a[0][k], "all")
                else a[0][k] == b[0][k] for k in a[0])
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--crossover", action="store_true",
                    help="also time both forms on CROSSOVER_CHAINS")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("cycle_profile: needs a CUDA card")
    built = profile_library()
    lines = [{"build_s": built.seconds, **probes(built)}]
    probe = lines[0]
    print(json.dumps(lines[0]), flush=True)
    for case in [c for c in args.cases.split(",") if c]:
        row = profile_case(case, built, args.iters)
        if row["form"] in CHAIN_STEPS:
            row["chain_bound_ms"] = chain_bound_ms(
                row["form"], row["executed"], probe)
            row["share_of_chain_bound"] = \
                row["chain_bound_ms"] / row["kernel_ms"]
        lines.append(row)
        print(json.dumps(row), flush=True)
    if args.crossover:
        for row in crossover(args.iters):
            lines.append({"crossover": row})
            print(json.dumps(lines[-1]), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(
            "".join(json.dumps(x) + "\n" for x in lines) + card + "\n")
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
