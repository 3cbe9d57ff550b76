"""The asyncio frame server and its control plane.

Request path::

    submit(frame, priority=...) ──▶ admission (QoS classes, token buckets,
        │ typed Overloaded shed)      queue-depth watermarks — admission.py
        ▼
    bounded request queue ──▶ scheduler ──▶ rolling (app, signature)
        (backpressure)          │            buckets (batcher.py)
                                ▼ pull: full / expired / top-up batch
                  BatchDispatcher.submit (pinned staging, copy and
                                │  kernels on the app's CUDA stream, an
                                │  event recorded; frame-axis shards)
                  bounded inflight FIFO (depth: double buffering)
                                ▼ readback thread: a read-back stream
                                  waits on the event, copies into pinned
                                  buffers; the thread waits for the copy
                  per-frame futures resolved, per-app health recorded

Continuous (rolling) batching: the scheduler *pulls* a batch whenever a
compute slot is free — a full bucket first, else a deadline-expired one,
else (rather than idle) the best partial bucket — and buckets keep
topping up while batches are in flight, so dispatch never stalls behind a
deadline timer the way flush-the-bucket batching does
(``ServeConfig(continuous=False)`` restores the old discipline for
comparison).

``start(warmup=True)`` runs every registered (app, signature, pow2-batch)
bucket once before the server accepts submissions, on the loop's thread:
the first-use ``nvcc`` builds of K1 and K2 (``kernels/_build.py``; the
generated K3 segments build when ``register`` lowers the design) happen
there, so no live frame pays a build; progress is surfaced in
``ServeStats``.  Per-app liveness/readiness, latency
quantiles, shed counters, and batch-occupancy histograms live in the
health monitor (health.py), and every admitted arrival is recorded into a
replayable :class:`~repro_torch.serve.health.ServeTrace` that feeds the cycle
engine's ingest model (``replay_trace_ingest``) with the *measured*
arrival process.

The server owns a background thread running the event loop, which
launches every batch, and ``depth`` readback threads, which only wait and
copy; synchronous callers (tests, request handlers) just call ``submit``
and get a ``concurrent.futures.Future``.  ``close(timeout=)`` bounds its
waits and raises if the loop thread does not stop.

Device rule: ``register`` runs an app on ``device`` ("cuda" unless the
caller or the design's ``CompileOptions.device`` names another; it raises
without a card), or on ``ServeConfig.devices``, whose frame axis splits
into one contiguous shard a device.  The reference's ``donate`` is not
carried over: the port's engine has no buffer-donation path.
"""
from __future__ import annotations

import asyncio
import collections
import concurrent.futures
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .admission import (NORMAL, PRIORITIES, AdmissionController, Overloaded,
                        QoSPolicy)
from .batcher import (FrameRequest, MicroBatcher, frame_signature,
                      next_pow2)
from .dispatch import BatchDispatcher
from .health import HealthMonitor, ServeTrace
from .sharding import frame_sharding


@dataclass
class ServeConfig:
    max_batch: int = 8            # size flush threshold per bucket
    max_delay_ms: float = 2.0     # deadline flush for partial buckets
    max_queue: int = 256          # request FIFO bound (admission + backpressure)
    depth: int = 2                # inflight batch FIFO bound (double buffer)
    pad_pow2: bool = True         # pad partial batches to warmed pow2 sizes
    devices: Optional[list] = None  # frame-axis shard targets (None: the
    #                                 device register() is given)
    continuous: bool = True       # rolling batching (False: flush-the-bucket)
    topup_hold_ms: float = 2.0    # batching window: a partial bucket is
    #                               top-up eligible only after this wait
    #                               (capped at max_delay_ms), so burst
    #                               arrivals fill buckets instead of being
    #                               shattered into singleton batches
    admission: bool = True        # QoS admission control + load shedding
    warmup: bool = True           # start(): run every registered bucket once
    record_trace: bool = True     # capture the arrival trace for replay

    def __post_init__(self):
        if self.max_batch < 1 or self.depth < 1 or self.max_queue < 1:
            raise ValueError("max_batch, depth, and max_queue must be >= 1")
        if self.max_delay_ms <= 0:
            raise ValueError("max_delay_ms must be > 0")
        if self.topup_hold_ms < 0:
            raise ValueError("topup_hold_ms must be >= 0")


@dataclass
class ServeStats:
    """Counters + latency reservoir for one server (updated on the loop
    thread; read from anywhere)."""
    frames_in: int = 0
    frames_out: int = 0
    shed: int = 0                 # admission rejections (typed Overloaded)
    batches: int = 0
    size_flushes: int = 0
    deadline_flushes: int = 0
    topup_flushes: int = 0        # partial batches pulled by a free slot
    padded_frames: int = 0
    queue_hw: int = 0             # request FIFO high-water
    bucket_hw: int = 0            # batcher bucket-occupancy high-water
    inflight_hw: int = 0          # compute FIFO high-water
    batch_frames: int = 0
    max_batch_seen: int = 0
    devices: int = 1
    backend: str = ""             # backend actually serving (post any swap)
    warmup_total: int = 0         # (app, signature, batch-size) buckets
    warmup_done: int = 0
    warmup_s: float = 0.0
    latencies: collections.deque = field(
        default_factory=lambda: collections.deque(maxlen=8192))
    # cycle-simulated ingest-FIFO prediction (FrameServer.simulate_ingest /
    # replay_trace_ingest): the hwsim engine replays the arrival process
    # (Poisson-profiled or trace-measured) and predicts the request
    # queue's high-water mark
    predicted_queue_hw: Optional[int] = None
    predicted_rho: Optional[float] = None
    health: Optional[HealthMonitor] = field(default=None, repr=False)

    def latency_quantiles(self) -> Dict[str, float]:
        """p50/p99 end-to-end frame latency in seconds (0.0 if idle)."""
        # deque.copy() is a single C call (GIL-atomic), safe against the
        # loop thread appending concurrently; iterating directly is not
        from .health import quantiles
        return quantiles(self.latencies.copy())

    def report_lines(self) -> List[str]:
        q = self.latency_quantiles()
        mean_b = self.batch_frames / self.batches if self.batches else 0.0
        predicted = ""
        if self.predicted_queue_hw is not None:
            predicted = (f" (simulated ingest: predicted "
                         f"hwm={self.predicted_queue_hw}, "
                         f"rho={self.predicted_rho:.2f})")
        lines = [
            f"frames in={self.frames_in} out={self.frames_out} "
            f"shed={self.shed} devices={self.devices} "
            f"backend={self.backend or '-'}",
            f"batches={self.batches} (size={self.size_flushes} "
            f"deadline={self.deadline_flushes} topup={self.topup_flushes}) "
            f"mean_batch={mean_b:.2f} "
            f"max_batch={self.max_batch_seen} "
            f"padded_frames={self.padded_frames}",
            f"fifo occupancy: request hw={self.queue_hw}{predicted} "
            f"bucket hw={self.bucket_hw} inflight hw={self.inflight_hw}",
            f"latency p50={q['p50'] * 1e3:.2f}ms p99={q['p99'] * 1e3:.2f}ms",
        ]
        if self.warmup_total:
            lines.append(f"warmup: {self.warmup_done}/{self.warmup_total} "
                         f"buckets warmed in {self.warmup_s:.2f}s")
        if self.health is not None:
            lines.extend(self.health.report_lines())
        return lines


class _App:
    def __init__(self, design, compiled, dispatcher, warm_inputs=None):
        self.design = design
        self.compiled = compiled
        self.dispatcher = dispatcher
        self.warm_inputs = list(warm_inputs or [])


_STOP = object()


def _priority_level(priority) -> Optional[int]:
    """None passthrough; "high"/"normal"/"low" or an int level."""
    if priority is None:
        return None
    if isinstance(priority, str):
        if priority not in PRIORITIES:
            raise ValueError(f"unknown priority {priority!r} "
                             f"(want one of {sorted(PRIORITIES)})")
        return PRIORITIES[priority]
    return int(priority)


class FrameServer:
    """Batched streaming frame server over one or more compiled designs."""

    def __init__(self, config: Optional[ServeConfig] = None):
        self.config = config or ServeConfig()
        self.admission = AdmissionController(self.config.max_queue)
        self.health = HealthMonitor(self.admission)
        self.stats = ServeStats(health=self.health)
        self.trace = ServeTrace()
        self._apps: Dict[str, _App] = {}
        self._default_app: Optional[str] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._queue: Optional[asyncio.Queue] = None
        self._started = threading.Event()
        self._accepting = threading.Event()   # set once warmup completed
        self._closed = False
        self._resident = 0            # admitted frames not yet retired
        self._rlock = threading.Lock()
        self._get_task: Optional[asyncio.Task] = None
        self._readback_pool: Optional[concurrent.futures.Executor] = None

    # ---- setup ----
    def register(self, design, name: Optional[str] = None,
                 backend: str = "kernels", device=None, warm_inputs=None,
                 policy: Optional[QoSPolicy] = None) -> str:
        """Attach an HWDesign; frames for it are tagged with ``name``
        (default: the design's name).  The first registered app is the
        default target of ``submit``.  The app runs on ``device`` (the
        lowering's default: "cuda", which raises without a card), or on
        every device of ``ServeConfig.devices`` with the frame axis split
        over them (pass one or the other).  ``warm_inputs`` is a list of
        exemplar frame input dicts — one per signature the app expects —
        that ``start(warmup=True)`` runs at every pow2 batch size before
        traffic is accepted.  ``policy`` sets the app's QoS class and
        optional rate limit (admission.py)."""
        if device is not None and self.config.devices is not None:
            raise ValueError("pass register(device=...) or "
                             "ServeConfig(devices=[...]), not both")
        name = name or design.name
        devices = (frame_sharding(self.config.devices)
                   or list(self.config.devices or [device]))
        compiled = [design.lower(backend, device=d) for d in devices]
        self.stats.devices = len(devices)
        self._apps[name] = _App(design, compiled, BatchDispatcher(
            compiled, depth=self.config.depth), warm_inputs=warm_inputs)
        if self._default_app is None:
            self._default_app = name
        if policy is not None:
            self.admission.set_policy(name, policy)
        self.stats.backend = backend
        self.health.app(name).backend = backend
        return name

    def start(self, warmup: Optional[bool] = None) -> "FrameServer":
        """Boot the scheduler loop.  ``warmup`` (default: the config's
        ``warmup`` flag) runs every registered (app, signature, pow2-batch)
        bucket once on the loop's thread — before the first ``submit`` is
        accepted — so live traffic never pays a kernel build.  A failing
        warmup closes the server and raises."""
        if self._thread is not None:
            return self
        self._t0 = time.perf_counter()
        self._readback_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=self.config.depth,
            thread_name_prefix="frame-readback")
        self._thread = threading.Thread(target=self._loop_main,
                                        name="frame-server", daemon=True)
        self._thread.start()
        self._started.wait()
        self.health.set_live(True)
        do_warm = self.config.warmup if warmup is None else warmup
        if do_warm:
            try:
                self._on_loop(self._warmup_registered)
            except BaseException:
                self.close()
                raise
        self._accepting.set()
        self.health.set_ready(True)
        return self

    def _on_loop(self, fn, *args):
        """Run ``fn(*args)`` on the loop's thread and return its result
        (re-raising its exception); raises if the loop thread dies."""
        async def call():
            return fn(*args)

        cf = asyncio.run_coroutine_threadsafe(call(), self._loop)
        while True:
            try:
                return cf.result(timeout=0.5)
            except concurrent.futures.TimeoutError:
                if not self._thread.is_alive():
                    cf.cancel()
                    raise RuntimeError("frame server loop stopped") from None

    # ---- warmup ----
    def _warm_sizes(self) -> List[int]:
        if self.config.pad_pow2:
            return sorted({min(next_pow2(s), self.config.max_batch)
                           for s in range(1, self.config.max_batch + 1)})
        return [self.config.max_batch]

    def _warmup_registered(self) -> None:
        """Run every (app, warm-input signature, batch size) bucket once;
        progress lands in ``ServeStats.warmup_*``."""
        work = [(name, inputs) for name, a in self._apps.items()
                for inputs in a.warm_inputs]
        sizes = self._warm_sizes()
        self.stats.warmup_total += len(work) * len(sizes)
        t0 = time.perf_counter()
        for name, inputs in work:
            self._warm_signature(name, inputs, count=False)
        self.stats.warmup_s += time.perf_counter() - t0

    def _warm_signature(self, app: str, inputs: Dict[str, Any],
                        count: bool = True) -> None:
        a = self._apps[app]
        sizes = self._warm_sizes()
        if count:
            self.stats.warmup_total += len(sizes)
        sig = frame_signature(inputs)
        now = time.perf_counter()
        for s in sizes:
            reqs = [FrameRequest(app, inputs, sig, now) for _ in range(s)]
            a.dispatcher.submit(reqs, pad_to=s).wait()
            self.stats.warmup_done += 1
            self.health.app(app).warmed_buckets += 1

    def warmup(self, inputs: Dict[str, Any],
               app: Optional[str] = None) -> None:
        """Run this input signature at every batch size traffic can
        produce (the pow2 padding buckets up to ``max_batch``) through the
        dispatcher, on the loop's thread, synchronously — so live traffic
        never pays a kernel build.  Needs a started server."""
        if self._thread is None:
            raise RuntimeError("server not started")
        t0 = time.perf_counter()
        self._on_loop(self._warm_signature, app or self._default_app,
                      inputs)
        self.stats.warmup_s += time.perf_counter() - t0

    # ---- client surface ----
    def submit(self, inputs: Dict[str, Any], app: Optional[str] = None,
               priority=None) -> concurrent.futures.Future:
        """Enqueue one frame; returns a Future resolving to its output.

        ``priority`` ("high" | "normal" | "low", default: the app's QoS
        policy class) feeds admission control: under load the request may
        be shed with a typed :class:`Overloaded` error instead of
        enqueueing.  Blocks (backpressure) only while the request FIFO is
        genuinely full below every shed watermark."""
        if self._closed:
            raise RuntimeError("server closed")
        if self._thread is None:
            raise RuntimeError("server not started")
        self._accepting.wait()                # warmup-before-traffic gate
        name = app or self._default_app
        if name not in self._apps:
            raise KeyError(f"unknown app {name!r}")
        level = _priority_level(priority)
        now = time.perf_counter()
        if self.config.admission:
            with self._rlock:
                depth = self._resident
            # raises Overloaded on shed; resolves the app-policy default
            try:
                level = self.admission.admit(name, depth, now,
                                             priority=level)
            finally:
                self.stats.shed = self.admission.total_shed()
        elif level is None:
            level = NORMAL
        if self.config.record_trace:
            self.trace.record(now - self._t0, name, level)
        with self._rlock:
            self._resident += 1
        fut: concurrent.futures.Future = concurrent.futures.Future()
        req = FrameRequest(name, inputs, frame_signature(inputs),
                           now, fut, priority=level)
        cf = asyncio.run_coroutine_threadsafe(self._queue.put(req),
                                              self._loop)
        # the put blocks while the request FIFO is full (backpressure) —
        # poll rather than wait unconditionally, because a close() racing
        # this submit can stop the loop before the scheduled coroutine
        # runs, in which case cf would never resolve
        while True:
            try:
                cf.result(timeout=0.1)
                return fut
            except concurrent.futures.TimeoutError:
                if self._loop.is_closed():
                    cf.cancel()
                    self._retire(1)
                    raise RuntimeError("server closed") from None

    def submit_many(self, frames, app: Optional[str] = None,
                    priority=None) -> List[concurrent.futures.Future]:
        return [self.submit(f, app=app, priority=priority) for f in frames]

    def _retire(self, n: int) -> None:
        with self._rlock:
            self._resident -= n

    def simulate_ingest(self, service_fps: Optional[float] = None,
                        arrival_fps: Optional[float] = None,
                        frames: int = 512, seed: int = 0,
                        mean_gap_cycles: float = 64.0):
        """Predict the request FIFO's steady-state occupancy by replaying
        the observed arrival/service rates through the hwsim cycle engine
        (hwsim/ingest.py) with seeded Poisson arrivals.

        ``arrival_fps`` defaults to the observed ingest rate
        (frames_in / wall time since start); ``service_fps`` defaults to
        the observed egress rate — pass the measured batch throughput
        for a sharper service model. The
        service rate is floored at 1/1024 frames/cycle: below that the
        queue is pinned at capacity regardless (and the cycle loop would
        otherwise grind for minutes — e.g. calling this before any frame
        completed makes the observed egress rate collapse to ~0). The
        prediction lands in ``stats.predicted_queue_hw`` next to the
        observed ``queue_hw`` and is returned as an IngestResult."""
        from fractions import Fraction

        from ..hwsim.ingest import simulate_ingest as _sim
        elapsed = max(time.perf_counter() - getattr(self, "_t0", 0.0), 1e-9)
        arrival = arrival_fps or max(self.stats.frames_in / elapsed, 1e-9)
        service = service_fps or max(self.stats.frames_out / elapsed, 1e-9)
        rate = Fraction(service / arrival / mean_gap_cycles
                        ).limit_denominator(10 ** 6)
        rate = min(max(rate, Fraction(1, 1024)), Fraction(1))
        res = _sim(frames, mean_gap_cycles, rate,
                   capacity=self.config.max_queue, seed=seed)
        self.stats.predicted_queue_hw = res.hwm
        self.stats.predicted_rho = res.utilization
        return res

    def replay_trace_ingest(self, service_fps: Optional[float] = None,
                            mean_gap_cycles: float = 64.0,
                            trace: Optional[ServeTrace] = None):
        """Replay the *measured* arrival process (the recorded trace, or
        one loaded from disk) through the cycle engine's ingest model, so
        request-FIFO sizing reflects real burstiness instead of the
        Poisson profile.  ``service_fps`` defaults to the observed egress
        rate.  The prediction lands in ``stats.predicted_queue_hw`` next
        to the observed ``queue_hw``."""
        from fractions import Fraction

        from ..hwsim.ingest import replay_ingest
        tr = trace if trace is not None else self.trace
        if len(tr) < 2:
            raise ValueError("need a trace with >= 2 arrivals to replay")
        arrivals = tr.arrival_cycles(mean_gap_cycles)
        cycles_per_s = mean_gap_cycles / max(tr.mean_gap_s(), 1e-12)
        elapsed = max(time.perf_counter() - getattr(self, "_t0", 0.0), 1e-9)
        service = service_fps or max(self.stats.frames_out / elapsed, 1e-9)
        rate = Fraction(service / cycles_per_s).limit_denominator(10 ** 6)
        rate = min(max(rate, Fraction(1, 1024)), Fraction(1))
        res = replay_ingest(arrivals, rate,
                            capacity=self.config.max_queue)
        self.stats.predicted_queue_hw = res.hwm
        self.stats.predicted_rho = res.utilization
        return res

    def close(self, timeout: float = 60.0) -> None:
        """Flush pending buckets, drain inflight batches, stop the loop.
        Waits at most ``timeout`` seconds for the stop to be queued and as
        long again for the loop thread to end; raises ``RuntimeError`` if
        it does not."""
        if self._thread is None or self._closed:
            return
        self._closed = True
        self.health.set_ready(False)
        try:
            asyncio.run_coroutine_threadsafe(
                self._queue.put(_STOP), self._loop).result(timeout=timeout)
        except RuntimeError:
            pass                        # scheduler already crashed/stopped
        except concurrent.futures.TimeoutError:
            raise RuntimeError(f"frame server: the stop was not queued "
                               f"within {timeout} s") from None
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise RuntimeError(f"frame server: the loop thread did not "
                               f"stop within {timeout} s")
        self._thread = None
        self.health.set_live(False)

    def __enter__(self) -> "FrameServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # ---- loop internals ----
    def _loop_main(self) -> None:
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)
        self._queue = asyncio.Queue(maxsize=self.config.max_queue)
        self._started.set()
        try:
            self._loop.run_until_complete(self._scheduler())
        finally:
            self._loop.close()
            self._readback_pool.shutdown(wait=False)

    async def _scheduler(self) -> None:
        batcher = MicroBatcher(self.config.max_batch,
                               self.config.max_delay_ms / 1e3,
                               pad_pow2=self.config.pad_pow2)
        self._batcher = batcher
        self._wake = asyncio.Event()
        inflight: collections.deque = collections.deque()
        try:
            await self._schedule_loop(batcher, inflight)
        except Exception as e:
            # a scheduler crash must not strand clients: fail every
            # pending future, then let the loop wind down so close()
            # can join the thread
            self.health.set_live(False, crash=repr(e))
            stranded = [r for reqs in batcher.flush_all() for r in reqs]
            gt = self._get_task
            if gt is not None:
                if gt.done() and not gt.cancelled():
                    r = gt.result()
                    if r is not _STOP:
                        stranded.append(r)
                else:
                    gt.cancel()
            while not self._queue.empty():
                req = self._queue.get_nowait()
                if req is not _STOP:
                    stranded.append(req)
            for task, handle in inflight:
                task.cancel()
                stranded.extend(handle.reqs)
            self._retire(len(stranded))
            for r in stranded:
                if r.future is not None and not r.future.done():
                    r.future.set_exception(e)
            raise
        else:
            # clean shutdown: a submit() racing close() may have enqueued
            # after the _STOP sentinel — fail those futures rather than
            # leaving their callers blocked forever
            while not self._queue.empty():
                req = self._queue.get_nowait()
                if req is not _STOP and req.future is not None \
                        and not req.future.done():
                    self._retire(1)
                    req.future.set_exception(RuntimeError("server closed"))

    def _ingest(self, req, batcher: MicroBatcher) -> bool:
        """Route one dequeued item into its rolling bucket; True on
        the stop sentinel."""
        if req is _STOP:
            return True
        self.stats.frames_in += 1
        self.health.app(req.app).frames_in += 1
        batcher.put(req, time.perf_counter())
        self.stats.bucket_hw = batcher.pending_hw
        return False

    async def _schedule_loop(self, batcher: MicroBatcher,
                             inflight: collections.deque) -> None:
        stop = False
        while True:
            # reap finished readbacks from the head of the compute FIFO
            while inflight and inflight[0][0].done():
                inflight.popleft()[0].result()
            # pull-dispatch while a compute slot is free: full buckets,
            # expired buckets, then (continuous mode, or draining at
            # shutdown) top-up partial batches rather than idling.  A
            # partial is only pulled when NOTHING is in flight — a free
            # second slot with work still streaming in is not an idle
            # machine, and topping it up would shatter filling buckets
            # into singleton batches
            now = time.perf_counter()
            hold = min(self.config.topup_hold_ms,
                       self.config.max_delay_ms) / 1e3
            while len(inflight) < self.config.depth:
                allow = stop or (self.config.continuous and not inflight)
                reqs = batcher.take(now, allow_partial=allow,
                                    partial_hold_s=0.0 if stop else hold)
                if reqs is None:
                    break
                self._dispatch(reqs, batcher, inflight)
            if stop and not batcher.has_pending():
                break
            # wait for the next event: an arrival (unless the rolling
            # window is at capacity), a completed readback (frees a
            # slot), or the earliest bucket deadline (only actionable
            # when a slot is free to dispatch into)
            if (self._get_task is None and not stop
                    and batcher.pending < self.config.max_queue):
                self._get_task = asyncio.ensure_future(self._queue.get())
            self._wake.clear()
            wake_task = asyncio.ensure_future(self._wake.wait())
            waits = {wake_task}
            if self._get_task is not None:
                waits.add(self._get_task)
            timeout = None
            if len(inflight) < self.config.depth:
                nd = batcher.next_deadline()
                # an idle machine also wakes when the earliest partial
                # clears its batching window (top-up eligibility)
                if self.config.continuous and not inflight:
                    nt = batcher.next_topup_ready(hold)
                    nd = nt if nd is None else min(nd, nt or nd)
                if nd is not None:
                    timeout = max(0.0, nd - time.perf_counter())
            done, _ = await asyncio.wait(
                waits, timeout=timeout,
                return_when=asyncio.FIRST_COMPLETED)
            wake_task.cancel()
            if self._get_task is not None and self._get_task in done:
                req = self._get_task.result()
                self._get_task = None
                self.stats.queue_hw = max(self.stats.queue_hw,
                                          self._queue.qsize() + 1)
                stop = self._ingest(req, batcher) or stop
                # drain the burst that arrived with it, up to the rolling
                # window's capacity (past it, the queue holds the
                # backpressure the way it always did)
                while batcher.pending < self.config.max_queue:
                    try:
                        req = self._queue.get_nowait()
                    except asyncio.QueueEmpty:
                        break
                    stop = self._ingest(req, batcher) or stop
        if self._get_task is not None:
            self._get_task.cancel()
            self._get_task = None
        while inflight:
            await inflight.popleft()[0]

    def _dispatch(self, reqs: List[FrameRequest],
                  batcher: MicroBatcher,
                  inflight: collections.deque) -> None:
        app = self._apps[reqs[0].app]
        pad_to = batcher.pad_target(len(reqs))
        try:
            handle = app.dispatcher.submit(reqs, pad_to=pad_to)
        except Exception as e:                  # bad frame: fail the batch
            self._retire(len(reqs))
            for r in reqs:
                if r.future is not None and not r.future.done():
                    r.future.set_exception(e)
            return
        self.stats.batches += 1
        self.stats.batch_frames += len(reqs)
        self.stats.max_batch_seen = max(self.stats.max_batch_seen, len(reqs))
        if pad_to:
            self.stats.padded_frames += max(0, pad_to - len(reqs))
        self.stats.size_flushes = batcher.size_flushes
        self.stats.deadline_flushes = batcher.deadline_flushes
        self.stats.topup_flushes = batcher.topup_flushes
        self.health.record_batch(reqs[0].app, len(reqs),
                                 time.perf_counter())
        # the handle rides along so the crash path can fail its requests'
        # futures if the task is cancelled before _readback resolves them
        task = asyncio.ensure_future(self._readback(handle))
        inflight.append((task, handle))
        self.stats.inflight_hw = max(self.stats.inflight_hw, len(inflight))

    async def _readback(self, handle) -> None:
        loop = asyncio.get_running_loop()
        try:
            outs = await loop.run_in_executor(self._readback_pool,
                                              handle.wait)
        except Exception as e:
            self._retire(len(handle.reqs))
            for r in handle.reqs:
                if r.future is not None and not r.future.done():
                    r.future.set_exception(e)
            return
        finally:
            self._wake.set()          # a compute slot is (about to be) free
        now = time.perf_counter()
        for r, out in zip(handle.reqs, outs):
            if r.future is not None:
                r.future.set_result(out)
            self.stats.latencies.append(now - r.enqueue_t)
            self.health.record_done(r.app, now - r.enqueue_t)
        self.stats.frames_out += len(handle.reqs)
        self._retire(len(handle.reqs))


def serve_design(design, backend: str = "kernels",
                 config: Optional[ServeConfig] = None,
                 warm_inputs=None, policy: Optional[QoSPolicy] = None,
                 device=None) -> FrameServer:
    """One-liner: build, register, and start a server for one design."""
    srv = FrameServer(config=config)
    srv.register(design, backend=backend, device=device,
                 warm_inputs=warm_inputs, policy=policy)
    return srv.start()


# re-export for the package surface (admission is the canonical home)
__all__ = ["FrameServer", "ServeConfig", "ServeStats", "serve_design",
           "Overloaded", "QoSPolicy"]
