"""Device time of a call on the card, read from the card's own events.

CUDA events around back-to-back calls time the calls' throughput, which
a wrapper's host work bounds once a kernel runs for less time than its
launch takes to enqueue (tens of microseconds of Python per call).
``device_ms`` sums instead the device time of every kernel and copy that
``torch.profiler`` (CUPTI) records over the calls.  Card only.
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
