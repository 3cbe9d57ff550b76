"""Device time of a call on the card, read from the card's own events.

CUDA events around back-to-back calls time the calls' throughput, which
a wrapper's host work bounds once a kernel runs for less time than its
launch takes to enqueue (tens of microseconds of Python per call).
``device_ms`` sums instead the device time of every kernel and copy that
``torch.profiler`` (CUPTI) records over the calls.  It leaves out the
gaps between a call's kernels and any kernel the profiler misses;
``graph_ms`` counts both: CUDA events around replays of one CUDA graph
of back-to-back calls, with no host work between them.  Card only.
``bound_ms`` is the least time the card could take for a call's work.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

# the rates a bound is taken against (an H100 SXM): device memory bytes/s
# and dense flop/s by operand type (bf16 on the tensor cores, f32 off them)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def bound_ms(nbytes: int, flops: int, dtype) -> Tuple[float, str, float,
                                                      float]:
    """The least ms for work that moves ``nbytes`` and does ``flops`` of
    ``dtype`` (a torch dtype or its name): (the larger of the two times,
    "bytes" or "operations", the bytes' ms, the operations' ms)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype).split(".")[-1]] * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, t_bytes, t_ops


def device_events(fn: Callable, iters: int, warmup: int = 2,
                  whole_calls: bool = False, min_kept: float = 0.5
                  ) -> Tuple[float, Dict[str, float]]:
    """Run ``fn`` ``iters`` times under the profiler (device activity
    alone: a model step at a long sequence runs tens of thousands of host
    operators) after ``warmup`` calls: (device ms per call, summed over
    every device event; device ms per call of each event name).  The
    profiler can lose records (on an H100 after a minute of bf16 matrix
    products at the power limit it kept 195 of 200 kernels; of calls of
    tens of milliseconds at S 32768 it has kept one in three), so the sum
    over ``iters`` under-reads.  With ``whole_calls`` (a call that
    launches each of its kernels the same number of times) a kernel's
    time a call is the mean of its recorded events times its launches a
    call, the recorded count over ``iters`` rounded, at least 1; a kernel
    recorded in fewer than ``min_kept`` of the calls raises.  A window
    with no device event at all is profiled again, twice at most, then
    raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # a profiled window now and then comes back with no device events at
    # all (seen once on an H100 in chip_smoke.py's External case, after a
    # run of CPU-only profiler sessions); such a window is profiled again
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0]
        if not events:
            continue
        by_name = {}
        for e in events:
            ms = e.self_device_time_total / 1e3
            if whole_calls:
                if e.count < min_kept * iters:
                    raise RuntimeError(f"the profiler recorded {e.key} "
                                       f"{e.count} times in {iters} calls")
                by_name[e.key] = ms / e.count * max(1, round(e.count
                                                             / iters))
            else:
                by_name[e.key] = ms / iters
        return sum(by_name.values()), by_name
    raise RuntimeError("the profiler recorded no device time")


def device_ms(fn: Callable, iters: int, warmup: int = 2,
              whole_calls: bool = False) -> float:
    """Device ms per call of ``fn`` (see ``device_events``)."""
    return device_events(fn, iters, warmup, whole_calls)[0]


def graph_ms(fn: Callable, calls: int = 20, replays: int = 10,
             warmup: int = 2) -> float:
    """Ms per call of ``fn`` from CUDA events around ``replays`` replays
    of one CUDA graph that captures ``calls`` back-to-back calls (after
    ``warmup`` calls on the capture's side stream): every kernel of a call
    and every gap between kernels, and no host work."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * calls)
