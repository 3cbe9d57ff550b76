"""Serve-ingest FIFO sizing with the cycle engine (the serving mirror of
the paper's FIFO story), a copy of the reference's host code.

A frame server's request queue is a bounded FIFO between a bursty arrival
process and a batching service process: structurally the same object the
hardware pipeline's FIFOs are, so the same cycle engine sizes it.  The
netlist is three modules:

    clock ──(unbounded)──▶ arrivals ──(ingest FIFO, cap=max_queue)──▶ server

``clock`` emits one token per cycle; ``arrivals`` turns clock ticks into
frames via a *profiled* need trace built from the arrival process (need
of frame k = its arrival cycle + 1 — exactly the mechanism the hardware
sim uses for Pad/Crop consumption profiles); ``server`` drains the
ingest FIFO at the observed service rate through the rate-R token
bucket.  The ingest edge's simulated high-water mark is the predicted
steady-state queue occupancy.

Two arrival models share the engine:

- :func:`simulate_ingest` — a seeded Poisson profile (exponential gaps),
  the a-priori model;
- :func:`replay_ingest` — an explicit arrival-cycle array (e.g. a
  recorded trace of a server's submissions mapped onto the cycle axis),
  so FIFO sizing uses the *measured* arrival process (real burstiness)
  instead of the Poisson assumption.

Both run on the host, on the scalar ``CycleSim``: the netlist is three
modules.
"""
from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction
from typing import List, Optional

import numpy as np

from .sim import CycleSim, NeedSpec, _SimEdge, _SimMod


def poisson_arrival_cycles(n_frames: int, mean_gap_cycles: float,
                           seed: int = 0) -> np.ndarray:
    """Cumulative arrival cycles of ``n_frames`` frames from a Poisson
    process with exponential inter-arrival gaps of ``mean_gap_cycles``
    (rounded to whole cycles; coincident arrivals serialize through the
    one-token-per-cycle ingress, like two submit() calls racing)."""
    if n_frames < 1:
        raise ValueError("n_frames must be >= 1")
    rng = np.random.RandomState(seed)
    gaps = np.round(rng.exponential(mean_gap_cycles, n_frames)).astype(
        np.int64)
    return np.cumsum(gaps)


@dataclass
class IngestResult:
    """Predicted ingest-FIFO behavior for one arrival/service profile."""

    hwm: int                   # max frames resident in the ingest FIFO
    hwm_cycle: int
    capacity: int              # the FIFO bound (server max_queue)
    frames: int
    cycles: int
    deadlock: Optional[str]
    mean_gap_cycles: float
    service_rate: Fraction     # frames per cycle
    source: str = "poisson"    # arrival model: "poisson" | "trace"

    @property
    def completed(self) -> bool:
        return self.deadlock is None

    @property
    def utilization(self) -> float:
        """Arrival rate over service rate (>= 1 predicts sustained
        backpressure: submit() callers block)."""
        return 1.0 / (self.mean_gap_cycles * float(self.service_rate))

    def report_lines(self) -> List[str]:
        status = "ok" if self.completed else f"STALLED: {self.deadlock}"
        return [f"ingest fifo: predicted hwm={self.hwm}/{self.capacity} "
                f"(rho={self.utilization:.2f}, {self.frames} {self.source} "
                f"frames, {status})"]


def _run_ingest(arrivals: np.ndarray, service_rate: Fraction,
                capacity: int, source: str) -> IngestResult:
    """Push an explicit arrival-cycle profile through the bounded ingest
    FIFO drained at ``service_rate`` and return its high-water mark.

    Uses the scalar cycle engine directly: the netlist is three modules and
    the horizon is O(n_frames / min(rate)) cycles, far below where the
    vectorized engine's compile cost pays off."""
    if capacity < 1:
        raise ValueError("capacity must be >= 1")
    arrivals = np.asarray(arrivals, dtype=np.int64)
    n_frames = int(len(arrivals))
    if n_frames < 1:
        raise ValueError("need at least one arrival")
    if np.any(np.diff(arrivals) < 0):
        raise ValueError("arrival cycles must be non-decreasing")
    service_rate = Fraction(service_rate).limit_denominator(10 ** 6)
    if not 0 < service_rate <= 1:
        raise ValueError("service_rate must be in (0, 1] frames/cycle")
    mean_gap = (float(arrivals[-1] - arrivals[0]) / (n_frames - 1)
                if n_frames > 1 else float(arrivals[-1]) or 1.0)
    drain = int(n_frames * service_rate.denominator
                // service_rate.numerator)
    ticks = int(arrivals[-1]) + drain + capacity + 64
    if ticks > 20_000_000:
        # the scalar loop below runs ~5-10us/cycle: a pathological
        # rate/frames combination (e.g. a near-zero estimated service
        # rate) would hang the caller for hours — refuse instead
        raise ValueError(
            f"ingest simulation would span {ticks} cycles "
            f"(n_frames={n_frames}, service_rate={service_rate}); "
            "raise the service rate or lower n_frames")

    clock = _SimMod(0, "clock", "Source", Fraction(1), 0, ticks,
                    throttled=False)
    ingress = _SimMod(1, "arrivals", "Source", Fraction(1), 0, n_frames,
                      throttled=False)
    server = _SimMod(2, "server", "Sink", service_rate, 0, n_frames,
                     throttled=service_rate < 1)

    tick_edge = _SimEdge(0, (0, 1), cap=None, token_bits=1)
    # the ingest FIFO: capacity slots, mirroring the server's bounded
    # request queue (depth = capacity, +1 producer register like every
    # simulated edge)
    ingest_edge = _SimEdge(1, (1, 2), cap=capacity + 1, token_bits=1)

    # frame k exists only once arrival[k-1]+1 clock ticks were consumed —
    # the same profiled-need mechanism that drives Pad/Crop consumption
    spec = NeedSpec(tpf=ticks, out_total=n_frames,
                    profile=arrivals + 1, v_out=1, pxs_out=1, v_in=1,
                    pxs_in=1)
    clock.out_edges.append(tick_edge)
    ingress.in_edges.append((tick_edge, spec.need_fn()))
    ingress.consumed.append(0)
    ingress.out_edges.append(ingest_edge)
    server.in_edges.append(
        (ingest_edge, NeedSpec(tpf=n_frames, out_total=n_frames).need_fn()))
    server.consumed.append(0)

    res = CycleSim([clock, ingress, server], [tick_edge, ingest_edge]).run()
    occ = res.occupancy.per_edge[1]
    # the clock starves by design once all frames arrived; only report a
    # stall if the *server* failed to drain every frame
    deadlock = res.deadlock if res.sink_tokens < n_frames else None
    return IngestResult(hwm=occ.hwm, hwm_cycle=occ.hwm_cycle,
                        capacity=capacity, frames=n_frames,
                        cycles=res.cycles, deadlock=deadlock,
                        mean_gap_cycles=mean_gap,
                        service_rate=service_rate, source=source)


def simulate_ingest(n_frames: int, mean_gap_cycles: float,
                    service_rate: Fraction, capacity: int,
                    seed: int = 0) -> IngestResult:
    """Push ``n_frames`` Poisson arrivals through a bounded ingest FIFO
    drained at ``service_rate`` and return the FIFO's high-water mark."""
    arrivals = poisson_arrival_cycles(n_frames, mean_gap_cycles, seed=seed)
    res = _run_ingest(arrivals, service_rate, capacity, source="poisson")
    # report the *configured* mean gap, not the realized sample mean, so
    # utilization matches the requested Poisson profile exactly
    res.mean_gap_cycles = float(mean_gap_cycles)
    return res


def replay_ingest(arrival_cycles, service_rate: Fraction,
                  capacity: int) -> IngestResult:
    """Replay an explicit arrival-cycle profile (e.g. a recorded serve
    trace mapped onto the cycle axis via ``ServeTrace.arrival_cycles``)
    through the bounded ingest FIFO — measured burstiness instead of the
    Poisson assumption."""
    return _run_ingest(np.sort(np.asarray(arrival_cycles, dtype=np.int64)),
                       service_rate, capacity, source="trace")
