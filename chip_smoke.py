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
           every kernel: csrc/*.cu, and the CUDA C++ that the megakernel
           emitter writes for each fused segment (FLOW, DESCRIPTOR and
           PYRAMID at 1920x1080 and at odd sizes, and a synthetic pipeline
           over every streamable op), all built from the checkout in one
           parallel batch, with each segment's tile and shared bytes
  kernel   per kernel: the CUDA kernel against its plain PyTorch version
           at the main path's shapes and at odd shapes, 3 frames each,
           which must agree exactly (max abs diff 0); for K3, each app's
           segment at 1920x1080 with 1 frame and with 3, each app at an odd
           size and the synthetic pipeline, where integer leaves must agree
           exactly, float leaves within FLOAT_ULP_BOUND ULPs and DESCRIPTOR's
           exactly; then the kernel's time (CUDA events over many launches),
           the plain version's, the library yardstick's, and the bound (the
           larger of bytes over 3.35 TB/s and the function's least
           operations over the SMs' lane rate at the maximum SM clock:
           integer ops on 64 lanes per SM, integer and f32 ops together on
           128; a box sum counts as a sliding sum)
  path     CONVOLUTION 1920x1080, STEREO 720x400 nd=64, and FLOW,
           DESCRIPTOR and PYRAMID 1920x1080 through
           compile_pipeline(...).run and run_batch (4 frames) on the
           "kernels" backend, bit-exact against the golden models; the
           launch counters must rise by one per run and one per run_batch;
           run ms per frame (host clock, median of warm calls) and
           run_batch frames/s; and run_batch_device on inputs already on
           the card (4 frames and 1 frame), the device-side share of a call
  profile  per app, the host-side operators of one warm run and one warm
           run_batch call (torch.profiler, CPU activity), by self time
  kernels  one line: every kernel (K3 once per app segment) with its
           launches on the main path (the counters are reset just before
           the path phase), its error against the plain version, and its
           times and bound

The last line is ``{"ok": true, "device": {...}}``.  Any mismatch, build
failure or launch error ends the script with a nonzero exit before it.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
INT32_LANES_PER_SM = 64
F32_LANES_PER_SM = 128
TPU_KERNELS = {"conv2d": "kernels/conv2d/kernel.py::_conv_kernel",
               "sad": "kernels/sad/kernel.py::_sad_kernel",
               "megakernel": "core/lowering/megakernel.py::emit_megakernel"}
MK_APPS = ("flow", "descriptor", "pyramid")
# odd sizes that no tile divides (PYRAMID's strides must divide its frame)
MK_ODD = {"flow": (37, 13), "descriptor": (45, 19), "pyramid": (36, 20)}


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


def app_inputs(np, app: str, uf, rng, frames: int):
    """A batch of ``frames`` random frames for one app (FLOW's second
    image is the first shifted right)."""
    shape = (frames, uf.h, uf.w)
    x = rng.randint(0, 256, shape).astype(np.int64)
    if app == "stereo":
        return {"stereo.in": (x, np.roll(x, -9, axis=-1))}
    if app == "flow":
        return {"flow.in": (x, np.roll(x, 2, axis=-1))}
    return {f"{uf.name}.in": x}


def golden(np, app: str, uf, frame):
    """The golden model's output for one frame, as a list of arrays."""
    from repro_torch import apps
    (x,) = frame.values()
    if app == "convolution":
        return [apps.golden_convolution(x)]
    if app == "stereo":
        return [apps.golden_stereo(*x, nd=uf.nd)]
    if app == "flow":
        return list(apps.golden_flow(*x))
    if app == "descriptor":
        return list(apps.golden_descriptor(x, n_features=uf.n_features))
    return [apps.golden_pyramid(x, levels=uf.levels)]


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


def bound(nbytes: int, int_ops: int, peak_int_ops: float, f32_ops: int = 0):
    """The least time for the work: the larger of the bytes over the
    memory rate and the operations over the SMs' lane rate, where integer
    ops run on 64 INT32 lanes per SM and all ops together on at most 128
    (the FP32 lanes)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    peak_all = peak_int_ops * F32_LANES_PER_SM / INT32_LANES_PER_SM
    t_ops = max(int_ops / peak_int_ops, (int_ops + f32_ops) / peak_all) * 1e3
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


def mk_designs():
    """Every design whose fused segment K3 runs here: each app at
    1920x1080 (the main path) and at its odd size, and the all-ops
    pipeline, on the kernels backend."""
    from repro_torch import CompileOptions, compile_pipeline, core
    from repro_torch.apps import PIPELINES
    from repro_torch.kernels.megakernel.check import all_ops_pipeline
    opts = CompileOptions(backend="kernels")
    ufs = {}
    for app in MK_APPS:
        w, h = MK_ODD[app]
        ufs[app] = PIPELINES[app]()
        ufs[f"{app}_{w}x{h}"] = PIPELINES[app](w=w, h=h)
    ufs["allops_37x13"] = all_ops_pipeline(core)
    return {label: (uf, compile_pipeline(uf, options=opts))
            for label, uf in ufs.items()}


def build_phase(designs):
    """csrc/*.cu and every design's generated segments, one nvcc each,
    all in one parallel batch.  The segments come from the CPU lowering,
    whose emitted text is the card's; the card's lowering then loads the
    cached builds."""
    from repro_torch.kernels import _build
    segments = {}
    for label, (_uf, design) in designs.items():
        lp = design.lower("kernels", device="cpu")
        if len(lp.megakernels) != 1:
            raise AssertionError(f"{label}: {len(lp.megakernels)} "
                                 f"megakernels, want 1: {lp.notes}")
        segments[label] = lp.megakernels[0]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:     # each waits on its nvcc runs
        csrc = pool.submit(_build.build_all)
        gen = pool.submit(_build.build_generated,
                          {k: mk.source for k, mk in segments.items()})
        built, gen = csrc.result(), gen.result()
    emit({"phase": "build", "wall_s": time.perf_counter() - t0,
          "kernels": {n: {"nvcc_s": b.seconds, "ptxas": ptxas_summary(b.log)}
                      for n, b in built.items()},
          "generated": {k: {"segment": mk.name, "nvcc_s": gen[k].seconds,
                            "ptxas": ptxas_summary(gen[k].log),
                            "tile": list(mk.tile), "smem_bytes": mk.smem_bytes,
                            "fused_nodes": mk.n_nodes,
                            "lines": mk.source.count("\n")}
                        for k, mk in segments.items()}})


def megakernel_phase(torch, np, designs, peak_int_ops):
    """K3 against its plain version on every design, then its times at
    1920x1080, one frame."""
    from repro_torch.kernels.megakernel.check import check_leaves
    from repro_torch.kernels.megakernel.ops import megakernel_segment
    from repro_torch.kernels.megakernel.ref import megakernel_ref

    rng = np.random.RandomState(3)
    results = {}
    for label, (uf, design) in designs.items():
        app = label.split("_")[0]
        lp = design.lower("kernels")
        mk = lp.megakernels[0]
        checks = {}
        for frames in (1, 3) if label == app else (3,):
            batch = app_inputs(np, app, uf, rng, frames)
            seg_in = lp.segment_inputs(mk, batch)
            got = megakernel_segment(mk, *seg_in)
            torch.cuda.synchronize()
            want = megakernel_ref(mk, *seg_in)
            checks[frames] = check_leaves(f"megakernel {label} x{frames}",
                                          got, want,
                                          exact=app == "descriptor")
        line = {"phase": "kernel", "name": "megakernel", "design": label,
                "segment": mk.name, "tile": list(mk.tile),
                "smem_bytes": mk.smem_bytes,
                "checks": {str(f): c for f, c in checks.items()}}
        if label == app:
            seg1 = lp.segment_inputs(mk, app_inputs(np, app, uf, rng, 1))
            one = cuda_ms(lambda: megakernel_segment(mk, *seg1), 1, warmup=1)
            iters = max(3, min(100, int(500 / max(one, 1e-3))))
            # the function's least work: each box-sum chain a sliding sum,
            # f32 ops at the FP32 lanes' rate; the reference's count
            # (``flops``: every box-sum output summed directly, all ops at
            # the int32 rate) is kept beside it
            roof = lp.megakernel_stats()["rooflines"][0]
            int_ops, f32_ops = mk.least_ops()
            b_ms, b_by, t_bytes, t_ops = bound(roof["io_bytes"], int_ops,
                                               peak_int_ops, f32_ops)
            line.update({
                "max_abs_err": max(c["max_abs_err"] for c in checks.values()),
                "max_ulp": max(c["max_ulp"] for c in checks.values()),
                "ms": cuda_ms(lambda: megakernel_segment(mk, *seg1), iters),
                "plain_ms": cuda_ms(lambda: megakernel_ref(mk, *seg1), 2,
                                    warmup=1),
                "library_ms": None,
                "bound_ms": b_ms, "bound_by": b_by,
                "bound_bytes_ms": t_bytes, "bound_ops_ms": t_ops,
                "bytes": roof["io_bytes"], "int_ops": int_ops,
                "f32_ops": f32_ops, "direct_ops": roof["flops"],
                "direct_ops_ms": roof["flops"] / peak_int_ops * 1e3,
                "shape": [uf.h, uf.w]})
            results[app] = line
        emit(line)
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


def path_phase(torch, np, designs):
    """Every app at the paper's sizes through the entry points a user
    calls, on the kernels backend: the launches of each app's kernel are
    read just before and just after its own calls."""
    from repro_torch import CompileOptions, compile_pipeline
    from repro_torch.apps import KERNEL_OF, Convolution, Stereo
    from repro_torch.kernels import registry
    from repro_torch.kernels.megakernel.check import leaves

    rng = np.random.RandomState(1)
    opts = CompileOptions(backend="kernels")
    runs = [("convolution", Convolution()), ("stereo", Stereo())]
    runs = [(app, uf, compile_pipeline(uf, options=opts)) for app, uf in runs]
    runs += [(app,) + designs[app] for app in MK_APPS]
    results = {}
    for app, uf, design in runs:
        entry = registry.get_kernel(KERNEL_OF[app])
        start = entry.launches()
        x = app_inputs(np, app, uf, rng, 5)
        frames = [{k: tuple(e[i] for e in v) if isinstance(v, tuple) else v[i]
                   for k, v in x.items()} for i in range(5)]
        batch = {k: tuple(e[1:] for e in v) if isinstance(v, tuple)
                 else v[1:] for k, v in x.items()}
        want = [golden(np, app, uf, f) for f in frames]

        def same(got, gold, what):
            got = leaves(got)
            if len(got) != len(gold) or any(
                    g.size != w.size or g.dtype != w.dtype
                    or not np.array_equal(g.reshape(w.shape), w)
                    for g, w in zip(got, gold)):
                raise AssertionError(f"{app}: {what} differs from the "
                                     f"golden model")

        one = design.run(frames[0], backend="kernels")
        if entry.launches() != start + 1:
            raise AssertionError(f"{app}: run launched {entry.name} "
                                 f"{entry.launches() - start} times")
        same(one, want[0], "run")
        many = design.run_batch(batch, backend="kernels")
        if entry.launches() != start + 2:
            raise AssertionError(f"{app}: run_batch launched {entry.name} "
                                 f"{entry.launches() - start - 1} times")
        for i in range(4):
            same([m[i] for m in leaves(many)], want[i + 1], f"run_batch[{i}]")
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
        lp = design.lower("kernels")
        results[app] = {
            "shape": [uf.h, uf.w] + ([uf.nd] if app == "stereo" else []),
            "kernel": entry.name, "bit_exact": True,
            "run_ms": run_ms, "run_ms_all": run_all,
            "run_batch_frames": 4, "run_batch_ms": batch_ms,
            "run_batch_fps": 4e3 / batch_ms,
            "run_batch_device_ms": dev_ms,
            "run_device_ms": dev_one_ms,
            "megakernels": len(lp.megakernels),
            "plan": [ln.strip() for ln in lp.notes],
        }
        emit({"phase": "path", "app": app, **results[app]})
        emit({"phase": "profile", "app": app,
              "run": _host_ops(torch, lambda: design.run(
                  frames[0], backend="kernels")),
              "run_batch": _host_ops(torch, lambda: design.run_batch(
                  batch, backend="kernels"))})
        results[app]["launches"] = entry.launches() - start
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

    designs = mk_designs()
    build_phase(designs)

    kern = kernel_phase(torch, np, peak_int_ops)
    kern_mk = megakernel_phase(torch, np, designs, peak_int_ops)
    registry.reset_launch_counts()          # the main path's launches only
    path = path_phase(torch, np, designs)
    launches = {n: e.launches() for n, e in registry.KERNELS.items()}
    for n, count in launches.items():
        if count == 0:
            raise AssertionError(f"kernel {n} was not launched on the path")
    for app in MK_APPS:
        if path[app]["megakernels"] != 1 or path[app]["launches"] == 0:
            raise AssertionError(f"{app}: no megakernel on the path "
                                 f"({path[app]['plan']})")

    def line(name, e, k, n_launch):
        return {"name": name, "route": "cuda", "source": e.source,
                "replaces": e.replaces, "tpu": TPU_KERNELS[e.name],
                "launches": n_launch, "equal": k["max_abs_err"] == 0,
                "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                "bound_by": k["bound_by"], "library_ms": k["library_ms"]}

    mk = registry.get_kernel("megakernel")
    emit({"kernels": [line(n, registry.get_kernel(n), kern[n], launches[n])
                      for n in ("conv2d", "sad")]
          + [dict(line(f"megakernel:{app}", mk, kern_mk[app],
                       path[app]["launches"]),
                  segment=kern_mk[app]["segment"],
                  max_ulp=kern_mk[app]["max_ulp"])
             for app in MK_APPS]})
    emit({"ok": True, "device": device})
    return 0


if __name__ == "__main__":
    sys.exit(main())
