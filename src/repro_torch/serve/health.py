"""Health/stats surface and arrival-trace capture for the frame server.

Two observability layers the control plane exports:

- :class:`HealthMonitor` — per-app liveness/readiness plus rolling
  latency quantiles, shed counters, and batch-occupancy histograms.
  *Liveness* is "the scheduler loop is running and has not crashed";
  *readiness* is "warmup finished and the server accepts traffic".  The
  monitor renders into ``ServeStats.report_lines()`` and a JSON-able
  ``snapshot()`` consumed by ``python -m repro_torch.serve --status``.

- :class:`ServeTrace` — per-request arrival timestamps (seconds since
  server start, app, priority class).  A recorded trace replays through
  the cycle engine (``repro_torch.hwsim.ingest.replay_ingest``) so
  request-FIFO sizing uses the *measured* arrival process instead of the
  Poisson profile.  ``save``/``load`` keep the reference's JSON layout, so
  a trace that one package wrote loads in the other.
"""
from __future__ import annotations

import collections
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .admission import PRIORITY_NAMES, AdmissionController


def quantiles(xs, qs=(0.50, 0.99)) -> Dict[str, float]:
    """p-quantiles of a snapshot-copied reservoir (0.0 when empty)."""
    s = sorted(xs)
    if not s:
        return {f"p{int(q * 100)}": 0.0 for q in qs}
    return {f"p{int(q * 100)}": s[min(len(s) - 1, int(q * len(s)))]
            for q in qs}


@dataclass
class AppHealth:
    """Rolling per-app counters (updated on the loop thread; read from
    anywhere — deques are append-only and copied before iteration)."""
    name: str
    backend: str = ""
    warmed_buckets: int = 0
    frames_in: int = 0
    frames_out: int = 0
    batches: int = 0
    last_dispatch_t: float = 0.0
    # batch-occupancy histogram: real (unpadded) batch size -> count
    batch_occupancy: collections.Counter = field(
        default_factory=collections.Counter)
    latencies: collections.deque = field(
        default_factory=lambda: collections.deque(maxlen=4096))

    def latency_quantiles(self) -> Dict[str, float]:
        return quantiles(self.latencies.copy())

    def mean_batch(self) -> float:
        n = sum(self.batch_occupancy.values())
        return (sum(k * v for k, v in self.batch_occupancy.items()) / n
                if n else 0.0)


class HealthMonitor:
    """Liveness/readiness plus the per-app health roll-up."""

    def __init__(self, admission: AdmissionController):
        self.admission = admission
        self.apps: Dict[str, AppHealth] = {}
        self._live = False           # scheduler loop running, not crashed
        self._ready = False          # warmup done, accepting traffic
        self._crash: Optional[str] = None

    # ---- state transitions (server-driven) ----
    def app(self, name: str) -> AppHealth:
        return self.apps.setdefault(name, AppHealth(name))

    def set_live(self, live: bool, crash: Optional[str] = None) -> None:
        self._live = live
        if crash:
            self._crash = crash

    def set_ready(self, ready: bool) -> None:
        self._ready = ready

    @property
    def live(self) -> bool:
        return self._live and self._crash is None

    @property
    def ready(self) -> bool:
        return self.live and self._ready

    # ---- accounting hooks ----
    def record_batch(self, app: str, n_real: int, now: float) -> None:
        h = self.app(app)
        h.batches += 1
        h.batch_occupancy[n_real] += 1
        h.last_dispatch_t = now

    def record_done(self, app: str, latency_s: float) -> None:
        h = self.app(app)
        h.frames_out += 1
        h.latencies.append(latency_s)

    # ---- export ----
    def snapshot(self) -> Dict[str, Any]:
        """JSON-able health document (the --status CLI payload)."""
        apps = {}
        for name, h in sorted(self.apps.items()):
            st = self.admission.stats.get(name)
            q = h.latency_quantiles()
            apps[name] = {
                "backend": h.backend,
                "warmed_buckets": h.warmed_buckets,
                "frames_in": h.frames_in,
                "frames_out": h.frames_out,
                "batches": h.batches,
                "mean_batch": round(h.mean_batch(), 3),
                "batch_occupancy": {str(k): v for k, v in
                                    sorted(h.batch_occupancy.items())},
                "latency_p50_ms": round(q["p50"] * 1e3, 3),
                "latency_p99_ms": round(q["p99"] * 1e3, 3),
                "admitted": st.admitted if st else h.frames_in,
                "shed": st.shed if st else 0,
                "policy": self.admission.policy(name).priority,
            }
        return {"live": self.live, "ready": self.ready,
                "crash": self._crash, "apps": apps}

    def report_lines(self) -> List[str]:
        snap = self.snapshot()
        lines = [f"health: live={snap['live']} ready={snap['ready']}"
                 + (f" crash={snap['crash']}" if snap["crash"] else "")]
        for name, a in snap["apps"].items():
            occ = " ".join(f"{k}x{v}" for k, v in
                           a["batch_occupancy"].items())
            lines.append(
                f"app[{name}] backend={a['backend']} "
                f"class={a['policy']} in={a['frames_in']} "
                f"out={a['frames_out']} shed={a['shed']} "
                f"p50={a['latency_p50_ms']:.2f}ms "
                f"p99={a['latency_p99_ms']:.2f}ms "
                f"batches={a['batches']} occupancy[{occ}]")
        lines.extend(self.admission.report_lines())
        return lines


# ---- arrival-trace capture ----

@dataclass(frozen=True)
class TraceEvent:
    """One admitted request's arrival: seconds since server start."""
    t: float
    app: str
    priority: int


class ServeTrace:
    """Recorded arrival process of one serve session.

    Append-only and GIL-atomic per event, so ``submit`` records from any
    caller thread without a lock.  ``save``/``load`` round-trip through
    JSON; ``arrival_cycles`` maps wall-clock arrivals onto the cycle axis
    for ``repro_torch.hwsim.ingest.replay_ingest``.
    """

    def __init__(self, events: Optional[List[TraceEvent]] = None,
                 maxlen: int = 1 << 16):
        self.events: collections.deque = collections.deque(
            events or (), maxlen=maxlen)

    def record(self, t: float, app: str, priority: int) -> None:
        self.events.append(TraceEvent(t, app, priority))

    def __len__(self) -> int:
        return len(self.events)

    def arrival_times(self) -> List[float]:
        return [e.t for e in sorted(self.events, key=lambda e: e.t)]

    def mean_gap_s(self) -> float:
        ts = self.arrival_times()
        if len(ts) < 2:
            return 0.0
        return (ts[-1] - ts[0]) / (len(ts) - 1)

    def arrival_cycles(self, mean_gap_cycles: float = 64.0):
        """Integer arrival cycles with the mean inter-arrival gap scaled
        to ``mean_gap_cycles`` — the measured process on the cycle axis,
        shape preserved (bursts stay bursts, lulls stay lulls)."""
        import numpy as np
        ts = np.asarray(self.arrival_times(), dtype=np.float64)
        if len(ts) == 0:
            raise ValueError("empty trace")
        gap = self.mean_gap_s()
        scale = (mean_gap_cycles / gap) if gap > 0 else 1.0
        return np.round((ts - ts[0]) * scale).astype(np.int64)

    # ---- persistence ----
    def to_dict(self) -> Dict[str, Any]:
        return {"version": 1,
                "events": [{"t": e.t, "app": e.app,
                            "priority": PRIORITY_NAMES.get(
                                e.priority, str(e.priority))}
                           for e in self.events]}

    @classmethod
    def from_dict(cls, doc: Dict[str, Any]) -> "ServeTrace":
        from .admission import PRIORITIES
        evs = [TraceEvent(float(e["t"]), e["app"],
                          PRIORITIES.get(e["priority"], 1))
               for e in doc.get("events", [])]
        return cls(evs)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)

    @classmethod
    def load(cls, path: str) -> "ServeTrace":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def scaled(self, speedup: float) -> "ServeTrace":
        """The same arrival process compressed in time (``speedup=4`` =
        4x the offered load) — an overload knob for replayed traffic."""
        if speedup <= 0:
            raise ValueError("speedup must be > 0")
        return ServeTrace([TraceEvent(e.t / speedup, e.app, e.priority)
                           for e in self.events])
