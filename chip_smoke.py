#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a card and the CUDA toolkit:

    python3 chip_smoke.py

It imports nothing of JAX or of the reference package ``repro``.  Each
phase prints one JSON line:

  device   card name and count, torch and CUDA versions, SM count, the
           maximum SM clock, and ``nvidia-smi``'s name and power limit
           (also printed raw on a line of its own)
  build    nvcc wall time and the ptxas register/shared/spill lines of
           every kernel (csrc/*.cu, built from the checkout)
  kernel   per kernel: the CUDA kernel against its plain PyTorch version
           at the main path's shapes and at odd shapes, 3 frames each,
           which must agree exactly (max abs diff 0); then the kernel's
           time (CUDA events over many launches), the plain version's, the
           library yardstick's, and the bound (the larger of bytes over
           3.35 TB/s and the function's least int32 operations over
           SMs x 64 lanes x the maximum SM clock)
  path     CONVOLUTION 1920x1080 and STEREO 720x400 nd=64 through
           compile_pipeline(...).run and run_batch (4 frames) on the
           "kernels" backend, bit-exact against the golden models; the
           launch counters must rise by one per run and one per run_batch;
           run ms per frame (host clock, median of 10 warm calls) and
           run_batch frames/s; and run_batch_device on inputs already on
           the card (4 frames and 1 frame), the device-side share of a call
  profile  per app, the host-side operators of one warm run and one warm
           run_batch call (torch.profiler, CPU activity), by self time
  kernels  one line: every kernel with its launches on the main path (the
           counters are reset just before the path phase), its error
           against the plain version, and its times and bound

The last line is ``{"ok": true, "device": {...}}``.  Any mismatch, build
failure or launch error ends the script with a nonzero exit before it.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
INT32_LANES_PER_SM = 64
TPU_KERNELS = {"conv2d": "kernels/conv2d/kernel.py::_conv_kernel",
               "sad": "kernels/sad/kernel.py::_sad_kernel"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def ptxas_summary(log: str):
    """ptxas's registers / shared memory / spill lines of one build."""
    return [ln.split(" : ", 1)[-1].strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "smem" in ln]


def check_equal(what: str, got, want) -> int:
    """Exact agreement of two integer tensors; returns the max abs diff."""
    import torch
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {tuple(got.shape)} {got.dtype} vs "
                             f"{tuple(want.shape)} {want.dtype}")
    err = int((got.long() - want.long()).abs().max().item()) \
        if got.numel() else 0
    if err != 0 or not torch.equal(got, want):
        raise AssertionError(f"{what}: max abs diff {err}")
    return err


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of one call, from CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: int, int_ops: int, peak_int_ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = int_ops / peak_int_ops * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            t_bytes, t_ops)


def kernel_phase(torch, np, peak_int_ops):
    import torch.nn.functional as F
    from repro_torch.apps.convolution import SHIFT, default_kernel
    from repro_torch.kernels.conv2d.ops import conv2d_stencil
    from repro_torch.kernels.conv2d.ref import conv2d_ref
    from repro_torch.kernels.sad.ops import sad_disparity
    from repro_torch.kernels.sad.ref import sad_ref

    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    results = {}

    def u8(shape):
        return torch.from_numpy(rng.randint(0, 256, shape).astype(
            np.int32)).to(dev)

    # --- K1 conv2d: CONVOLUTION 1080p's site sees the padded 1088x1936
    # frame, so P is (1095, 1943) with the 8x8 bank, shift 11
    k_main = torch.from_numpy(default_kernel().astype(np.int32)).to(dev)
    cases = [("main", u8((3, 1095, 1943)), k_main, SHIFT)]
    k_odd = torch.from_numpy(rng.randint(0, 64, (3, 5)).astype(
        np.int32)).to(dev)
    cases += [(f"odd_shift{s}", u8((3, 13 + 2, 37 + 4)), k_odd, s)
              for s in (0, 11)]
    err = 0
    for name, p, k, s in cases:
        err = max(err, check_equal(f"conv2d {name}", conv2d_stencil(p, k, s),
                                   conv2d_ref(p, k, s)))
    p1 = cases[0][1][:1].contiguous()
    out1 = conv2d_stencil(p1, k_main, SHIFT)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # the yardstick's float inputs are made once, outside the timing: it
    # times cuDNN's conv2d, the cast back to int32, the shift and the mask
    p1_f, k_f = p1.float()[:, None], k_main.float()[None, None]

    def library():
        acc = F.conv2d(p1_f, k_f)
        return (acc[:, 0].to(torch.int32) >> SHIFT) & 0xFF

    check_equal("conv2d library yardstick", library(), out1)
    n, hp, wp = p1.shape
    kh, kw = k_main.shape
    nbytes = 4 * (p1.numel() + k_main.numel() + out1.numel())
    b_ms, b_by, t_bytes, t_ops = bound(nbytes, out1.numel() * kh * kw,
                                       peak_int_ops)
    results["conv2d"] = {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: conv2d_stencil(p1, k_main, SHIFT), 200),
        "plain_ms": cuda_ms(lambda: conv2d_ref(p1, k_main, SHIFT), 10),
        "library_ms": cuda_ms(library, 50),
        "bound_ms": b_ms, "bound_by": b_by,
        "bound_bytes_ms": t_bytes, "bound_ops_ms": t_ops,
        "shape": {"p": [n, hp, wp], "k": [kh, kw], "out": list(out1.shape)},
        "bytes": nbytes, "int_ops": out1.numel() * kh * kw,
    }
    emit({"phase": "kernel", "name": "conv2d", **results["conv2d"]})

    # --- K2 sad: STEREO 720x400, nd=64, 8x8 blocks -> L, R (407, 790)
    nd, bh, bw = 64, 8, 8
    l_main = u8((3, 400 + bh - 1, 720 + bw - 1 + nd - 1))
    r_main = torch.roll(l_main, 5, dims=2).contiguous()
    odd = (13, 37, 5, 3, 4)
    oh, ow, ond, obh, obw = odd
    l_odd = u8((3, oh + obh - 1, ow + obw - 1 + ond - 1))
    r_odd = u8(tuple(l_odd.shape))
    tie = torch.full((3, oh + obh - 1, ow + obw - 1 + ond - 1), 7,
                     dtype=torch.int32, device=dev)
    err = 0
    for name, l, r, prm in [("main", l_main, r_main, (nd, bh, bw)),
                            ("odd", l_odd, r_odd, (ond, obh, obw)),
                            ("all_tie", tie, tie.clone(), (ond, obh, obw))]:
        got = sad_disparity(l, r, nd=prm[0], bh=prm[1], bw=prm[2])
        err = max(err, check_equal(f"sad {name}", got,
                                   sad_ref(l, r, nd=prm[0], bh=prm[1],
                                           bw=prm[2])))
        if name == "all_tie" and bool(got.any()):
            raise AssertionError("sad all_tie: a disparity other than 0 won")
    l1, r1 = l_main[:1].contiguous(), r_main[:1].contiguous()
    out1 = sad_disparity(l1, r1, nd=nd, bh=bh, bw=bw)
    nbytes = 4 * (l1.numel() + r1.numel() + out1.numel())
    # The function's least work is a box filter per disparity: one |L-R|
    # per (padded pixel, d), counted as one operation; a sliding sum across
    # (add the new column, subtract the old) per (row-padded pixel, d) and
    # one down per (pixel, d); one compare per (pixel, d).  Integer sums are
    # exact and the compare order keeps the tie rule.
    _, h, w = out1.shape
    hp, wp = h + bh - 1, w + bw - 1
    int_ops = nd * (hp * wp + 2 * hp * w + 2 * h * w + h * w)
    # the kernel's own count: every block summed directly
    direct_ops = out1.numel() * nd * (bh * bw + 1)
    b_ms, b_by, t_bytes, t_ops = bound(nbytes, int_ops, peak_int_ops)
    results["sad"] = {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: sad_disparity(l1, r1, nd=nd, bh=bh, bw=bw),
                      50),
        "plain_ms": cuda_ms(lambda: sad_ref(l1, r1, nd=nd, bh=bh, bw=bw),
                            2, warmup=1),
        "library_ms": None,
        "bound_ms": b_ms, "bound_by": b_by,
        "bound_bytes_ms": t_bytes, "bound_ops_ms": t_ops,
        "shape": {"l": list(l1.shape), "nd": nd, "block": [bh, bw],
                  "out": list(out1.shape)},
        "bytes": nbytes, "int_ops": int_ops,
        "direct_int_ops": direct_ops,
        "direct_ops_ms": direct_ops / peak_int_ops * 1e3,
    }
    emit({"phase": "kernel", "name": "sad", **results["sad"]})
    return results


def _host_ms(fn, calls: int, warm: int = 2):
    import torch
    for _ in range(warm):
        fn()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


def _host_ops(torch, fn, top: int = 8):
    """One warm call of ``fn`` under torch.profiler (CPU activity): its
    host wall ms and its ``top`` operators by self CPU time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return {"wall_ms": wall, "ops": [
        {"op": e.key, "calls": e.count,
         "self_ms": e.self_cpu_time_total / 1e3,
         "total_ms": e.cpu_time_total / 1e3} for e in ops[:top]]}


def path_phase(torch, np):
    """Both apps at the paper's sizes through the entry points a user
    calls, on the kernels backend."""
    from repro_torch import CompileOptions, compile_pipeline
    from repro_torch.apps import (Convolution, Stereo, golden_convolution,
                                  golden_stereo)
    from repro_torch.kernels import registry

    rng = np.random.RandomState(1)
    results = {}
    for app, kernel in (("convolution", "conv2d"), ("stereo", "sad")):
        entry = registry.get_kernel(kernel)
        if app == "convolution":
            uf = Convolution()
            x = rng.randint(0, 256, (5, uf.h, uf.w)).astype(np.int64)
            frames = [{"convolution.in": x[i]} for i in range(5)]
            batch = {"convolution.in": x[1:]}
            golden = [golden_convolution(x[i]) for i in range(5)]
        else:
            uf = Stereo()
            left = rng.randint(0, 256, (5, uf.h, uf.w)).astype(np.int64)
            right = np.roll(left, -9, axis=-1)
            frames = [{"stereo.in": (left[i], right[i])} for i in range(5)]
            batch = {"stereo.in": (left[1:], right[1:])}
            golden = [golden_stereo(left[i], right[i], nd=uf.nd)
                      for i in range(5)]
        design = compile_pipeline(uf, options=CompileOptions(
            backend="kernels"))
        before = entry.launches()
        one = design.run(frames[0], backend="kernels")
        if entry.launches() != before + 1:
            raise AssertionError(f"{app}: run launched {kernel} "
                                 f"{entry.launches() - before} times")
        if not np.array_equal(one, golden[0]):
            raise AssertionError(f"{app}: run differs from the golden model")
        many = design.run_batch(batch, backend="kernels")
        if entry.launches() != before + 2:
            raise AssertionError(f"{app}: run_batch launched {kernel} "
                                 f"{entry.launches() - before - 1} times")
        if not np.array_equal(many, np.stack(golden[1:])):
            raise AssertionError(f"{app}: run_batch differs from the golden "
                                 f"model")
        run_ms, run_all = _host_ms(
            lambda: design.run(frames[0], backend="kernels"), 10)
        batch_ms, _ = _host_ms(
            lambda: design.run_batch(batch, backend="kernels"), 5)
        # the same batch with inputs already on the card and results kept
        # there: the device-side share of a run_batch call
        dev_batch = {k: tuple(torch.from_numpy(e).cuda() for e in v)
                     if isinstance(v, tuple) else torch.from_numpy(v).cuda()
                     for k, v in batch.items()}
        dev_ms, _ = _host_ms(
            lambda: design.run_batch_device(dev_batch, backend="kernels"), 5)
        dev_one = {k: tuple(e[:1] for e in v) if isinstance(v, tuple)
                   else v[:1] for k, v in dev_batch.items()}
        dev_one_ms, _ = _host_ms(
            lambda: design.run_batch_device(dev_one, backend="kernels"), 10)
        report = design.lowering_report()
        results[app] = {
            "shape": [uf.h, uf.w] + ([uf.nd] if app == "stereo" else []),
            "bit_exact": True,
            "run_ms": run_ms, "run_ms_all": run_all,
            "run_batch_frames": 4, "run_batch_ms": batch_ms,
            "run_batch_fps": 4e3 / batch_ms,
            "run_batch_device_ms": dev_ms,
            "run_device_ms": dev_one_ms,
            "plan": [ln.strip() for ln in report.splitlines()
                     if "dispatch" in ln or "=>" in ln],
        }
        emit({"phase": "path", "app": app, **results[app]})
        emit({"phase": "profile", "app": app,
              "run": _host_ops(torch, lambda: design.run(
                  frames[0], backend="kernels")),
              "run_batch": _host_ops(torch, lambda: design.run_batch(
                  batch, backend="kernels"))})
    return results


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: no card",
              file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch.kernels import _build, registry

    name_power = smi("name,power.limit")
    max_clock_mhz = float(smi("clocks.max.sm").split()[0])
    props = torch.cuda.get_device_properties(0)
    peak_int_ops = props.multi_processor_count * INT32_LANES_PER_SM \
        * max_clock_mhz * 1e6
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    emit({"phase": "device", **device, "torch": torch.__version__,
          "cuda": torch.version.cuda, "sms": props.multi_processor_count,
          "max_sm_clock_mhz": max_clock_mhz,
          "peak_int32_ops_per_s": peak_int_ops, "nvidia_smi": name_power})
    print(name_power, flush=True)

    t0 = time.perf_counter()
    built = _build.build_all()
    emit({"phase": "build", "wall_s": time.perf_counter() - t0,
          "kernels": {n: {"nvcc_s": b.seconds, "ptxas": ptxas_summary(b.log)}
                      for n, b in built.items()}})

    kern = kernel_phase(torch, np, peak_int_ops)
    registry.reset_launch_counts()          # the main path's launches only
    path = path_phase(torch, np)
    launches = {n: e.launches() for n, e in registry.KERNELS.items()}
    for n, count in launches.items():
        if count == 0:
            raise AssertionError(f"kernel {n} was not launched on the path")

    emit({"kernels": [
        {"name": n, "route": "cuda", "source": e.source,
         "replaces": e.replaces, "tpu": TPU_KERNELS[n],
         "launches": launches[n], "equal": kern[n]["max_abs_err"] == 0,
         "max_abs_err": kern[n]["max_abs_err"], "ms": kern[n]["ms"],
         "plain_ms": kern[n]["plain_ms"], "bound_ms": kern[n]["bound_ms"],
         "bound_by": kern[n]["bound_by"],
         "library_ms": kern[n]["library_ms"]}
        for n, e in registry.KERNELS.items()]})
    emit({"ok": True, "device": device})
    return 0


if __name__ == "__main__":
    sys.exit(main())
