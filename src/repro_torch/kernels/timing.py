"""Device time of a call on the card, read from the card's own events.

CUDA events around back-to-back calls time the calls' throughput, which
a wrapper's host work bounds once a kernel runs for less time than its
launch takes to enqueue (tens of microseconds of Python per call).
``device_ms`` sums instead the device time of every kernel and copy that
``torch.profiler`` (CUPTI) records over the calls.  It leaves out the
gaps between a call's kernels and any kernel the profiler misses;
``graph_ms`` counts both: CUDA events around replays of one CUDA graph
of back-to-back calls, with no host work between them.  Card only.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple


def device_events(fn: Callable, iters: int, warmup: int = 2
                  ) -> Tuple[float, Dict[str, float]]:
    """Run ``fn`` ``iters`` times under the profiler after ``warmup``
    calls: (device ms per call, summed over every device event; device
    ms per call of each event name)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # a profiled window now and then comes back with no device events at
    # all (seen once on an H100 in chip_smoke.py's External case, after a
    # run of CPU-only profiler sessions); such a window is profiled again
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by_name = {e.key: e.self_device_time_total / 1e3 / iters
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0}
        total = sum(by_name.values())
        if total > 0:
            return total, by_name
    raise RuntimeError("the profiler recorded no device time")


def device_ms(fn: Callable, iters: int, warmup: int = 2) -> float:
    """Device ms per call of ``fn`` (see ``device_events``)."""
    return device_events(fn, iters, warmup)[0]


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
