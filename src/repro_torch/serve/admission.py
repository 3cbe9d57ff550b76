"""Admission control and load shedding for the frame server.

Backpressure alone (a full request FIFO blocking ``submit``) stalls every
app equally: one flooding client freezes the fleet.  Admission control
makes overload *differential* instead — each app carries a QoS policy
(priority class + optional token-bucket rate limit), and the controller
sheds work with a typed :class:`Overloaded` error before the queue is
allowed to pin at capacity:

- **priority watermarks**: a request is shed once the request FIFO's
  occupancy crosses its class's fraction of ``max_queue`` (low sheds at
  50%, normal at 85%, high only at 100%) — so under a low-priority flood
  the queue never grows past the low watermark and high-priority latency
  stays bounded by a short queue;
- **token buckets**: an app with ``rate_fps`` set is clamped to that
  sustained rate with ``burst`` frames of slack, independent of global
  load (per-client quotas).

The controller is clock-injected and lock-guarded: ``submit`` calls it
from arbitrary caller threads.  All shed/admit counters are kept per app
and surfaced through the health monitor (serve/health.py).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, Optional

# priority classes, ordered: lower value = more important.  Requests keep
# the integer; policies and errors speak the names.
HIGH, NORMAL, LOW = 0, 1, 2
PRIORITY_NAMES = {HIGH: "high", NORMAL: "normal", LOW: "low"}
PRIORITIES = {v: k for k, v in PRIORITY_NAMES.items()}

# queue-depth shed watermark per class, as a fraction of max_queue: the
# class is rejected once occupancy reaches its fraction.  High priority
# sheds only at a truly full queue (a typed error instead of an unbounded
# blocking stall).
SHED_WATERMARK = {HIGH: 1.0, NORMAL: 0.85, LOW: 0.5}


class Overloaded(RuntimeError):
    """Typed load-shed rejection: the request was NOT enqueued.

    Carries enough for a client to make a retry decision: which app, why
    (``"queue"`` depth watermark or ``"rate"`` token bucket), the
    request's priority class, and the queue occupancy at rejection time.
    """

    def __init__(self, app: str, reason: str, priority: int,
                 depth: int = 0, capacity: int = 0):
        self.app = app
        self.reason = reason
        self.priority = priority
        self.depth = depth
        self.capacity = capacity
        super().__init__(
            f"overloaded: app={app!r} shed ({reason}) at "
            f"priority={PRIORITY_NAMES.get(priority, priority)} "
            f"queue={depth}/{capacity}")


@dataclass(frozen=True)
class QoSPolicy:
    """Per-app QoS: priority class plus an optional sustained-rate cap."""
    priority: str = "normal"          # "high" | "normal" | "low"
    rate_fps: Optional[float] = None  # sustained frames/sec (None = uncapped)
    burst: int = 32                   # token-bucket depth (frames)

    def __post_init__(self):
        if self.priority not in PRIORITIES:
            raise ValueError(f"unknown priority {self.priority!r} "
                             f"(want one of {sorted(PRIORITIES)})")
        if self.rate_fps is not None and self.rate_fps <= 0:
            raise ValueError("rate_fps must be > 0 (or None)")
        if self.burst < 1:
            raise ValueError("burst must be >= 1")

    @property
    def priority_level(self) -> int:
        return PRIORITIES[self.priority]


class TokenBucket:
    """Classic token bucket, clock-injected (caller passes ``now``)."""

    def __init__(self, rate_per_s: float, burst: int):
        self.rate = float(rate_per_s)
        self.burst = float(burst)
        self.tokens = float(burst)
        self._t: Optional[float] = None

    def try_take(self, now: float) -> bool:
        if self._t is not None:
            self.tokens = min(self.burst,
                              self.tokens + (now - self._t) * self.rate)
        self._t = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


@dataclass
class AdmitStats:
    """Per-app admission counters (read by the health monitor)."""
    admitted: int = 0
    shed_queue: int = 0               # rejected at a depth watermark
    shed_rate: int = 0                # rejected by the token bucket
    shed_by_priority: Dict[int, int] = field(default_factory=dict)

    @property
    def shed(self) -> int:
        return self.shed_queue + self.shed_rate


class AdmissionController:
    """Priority/QoS admission over one server's request FIFO."""

    def __init__(self, max_queue: int):
        self.max_queue = max_queue
        self._policies: Dict[str, QoSPolicy] = {}
        self._buckets: Dict[str, TokenBucket] = {}
        self.stats: Dict[str, AdmitStats] = {}
        self._lock = threading.Lock()

    def set_policy(self, app: str, policy: QoSPolicy) -> None:
        with self._lock:
            self._policies[app] = policy
            if policy.rate_fps is not None:
                self._buckets[app] = TokenBucket(policy.rate_fps,
                                                 policy.burst)
            else:
                self._buckets.pop(app, None)

    def policy(self, app: str) -> QoSPolicy:
        return self._policies.get(app) or QoSPolicy()

    def admit(self, app: str, depth: int, now: float,
              priority: Optional[int] = None) -> int:
        """Admit or shed one request given the current queue ``depth``.

        Returns the request's priority level on admission; raises
        :class:`Overloaded` on shed.  ``priority`` overrides the app
        policy's class per request (e.g. a background backfill submitting
        low-priority frames to a high-priority app).
        """
        with self._lock:
            pol = self.policy(app)
            level = pol.priority_level if priority is None else priority
            st = self.stats.setdefault(app, AdmitStats())
            bucket = self._buckets.get(app)
            if bucket is not None and not bucket.try_take(now):
                st.shed_rate += 1
                st.shed_by_priority[level] = \
                    st.shed_by_priority.get(level, 0) + 1
                raise Overloaded(app, "rate", level, depth, self.max_queue)
            mark = SHED_WATERMARK.get(level, 1.0) * self.max_queue
            if depth >= mark:
                st.shed_queue += 1
                st.shed_by_priority[level] = \
                    st.shed_by_priority.get(level, 0) + 1
                raise Overloaded(app, "queue", level, depth, self.max_queue)
            st.admitted += 1
            return level

    # ---- roll-ups (health / ServeStats) ----
    def total_shed(self) -> int:
        with self._lock:
            return sum(s.shed for s in self.stats.values())

    def report_lines(self):
        with self._lock:
            lines = []
            for app in sorted(self.stats):
                s = self.stats[app]
                pol = self.policy(app)
                rate = (f" rate={pol.rate_fps:g}fps/b{pol.burst}"
                        if pol.rate_fps else "")
                lines.append(
                    f"admission[{app}]: class={pol.priority}{rate} "
                    f"admitted={s.admitted} shed={s.shed} "
                    f"(queue={s.shed_queue} rate={s.shed_rate})")
            return lines
