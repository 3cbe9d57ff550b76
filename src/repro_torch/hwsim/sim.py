"""Cycle-level streaming-dataflow simulator over the mapped RModule graph.

The value domain (executor.py / core/lowering) computes WHAT the pipeline
produces; this module computes WHEN: per-cycle valid/ready token handshakes
across the module netlist with finite FIFOs. It is the dynamic mirror of the
static solve in core/buffers.py — same rates R, latencies L and FIFO depths,
but tokens actually move, stall, and back-propagate pressure, so the
per-FIFO high-water marks it records *measure* the buffering the analytic
model only *bounds* (paper §4.2-4.3, §7.3).

Model, per cycle:
  - a module launches output token k only once every in-edge e has delivered
    ``need_e(k)`` tokens (at most one token per edge moves per cycle);
  - launches of rate-R modules are throttled by a depth-one token bucket
    (no catch-up bursts after stalls — the model trace's slope is R);
  - the bursty border ops (Pad / Crop / Downsample) are *not* throttled:
    their irregular production is driven by exact consumption->production
    profiles reconstructed from their schedule traces, so the simulation
    exercises the very bursts the analytic model pads FIFOs for;
  - a launched token matures L cycles later and is then pushed downstream,
    blocking on FIFO space (broadcast modules need space on every out-edge).

Token payloads are not modeled — only counts move, which is all FIFO sizing
needs. Deadlock/starvation is detected as a sustained absence of token
movement and reported with a per-module blocked/starved diagnosis.

Two engines implement the identical cycle semantics: this module's scalar
Python loop (``engine="scalar"``, on the host) and the packed-state engine
in ``hwsim.vector`` (``engine="vector"``): the cycle kernel on the card,
or its plain version on the CPU.  Both consume the same per-edge
``NeedSpec``s, so their high-water marks and cycle counts are
bit-identical.  ``"auto"`` takes the fastest exact engine of the device:
the kernel on the card, the scalar loop on the CPU.

Multi-frame runs (``frames=N``) launch N back-to-back frames through the
same netlist: every need function repeats per frame with a cumulative
offset, so FIFO residue left by one frame (e.g. a Crop's dropped trailing
border, never needed within its own frame) is drained by the next frame's
early consumption — the steady-state high-water marks this measures can
exceed the single-frame marks.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field
from fractions import Fraction
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..core import schedule as sched
from ..core.buffers import Edge
from ..core.rigel import RModule
from .occupancy import EdgeOccupancy, OccupancyTrace

EdgeKey = Tuple[int, int]

# module kinds whose production timing comes from an exact per-pixel profile
# rather than the smooth rate-R model (their burstiness is the point)
PROFILED = ("Pad", "Crop", "Downsample")

# module kinds whose burstiness is data-dependent and therefore NOT exercised
# by this deterministic simulation; the allocator keeps their annotated burst
# slots (paper §4.3 — e.g. the user-supplied Filter bound, External IP)
UNEXERCISED_BURSTY = ("Filter", "SparseTake", "External")


class _SimEdge:
    __slots__ = ("idx", "key", "cap", "occ", "hwm", "hwm_cycle", "hwm_frame",
                 "pushed", "popped", "token_bits")

    def __init__(self, idx: int, key: EdgeKey, cap: Optional[int],
                 token_bits: int):
        self.idx = idx
        self.key = key
        self.cap = cap          # None = unbounded
        self.occ = 0
        self.hwm = 0
        self.hwm_cycle = 0
        self.hwm_frame = 0
        self.pushed = 0
        self.popped = 0
        self.token_bits = token_bits


class _SimMod:
    __slots__ = ("idx", "name", "kind", "rnum", "rden", "latency",
                 "out_total", "throttled", "in_edges", "out_edges",
                 "consumed", "launched", "pushed", "inflight", "credit",
                 "_need_k", "_need_v")

    def __init__(self, idx: int, name: str, kind: str, rate: Fraction,
                 latency: int, out_total: int, throttled: bool):
        self.idx = idx
        self.name = name
        self.kind = kind
        self.rnum, self.rden = rate.numerator, rate.denominator
        self.latency = latency
        self.out_total = out_total
        self.throttled = throttled
        self.in_edges: List[Tuple[_SimEdge, Callable[[int], int]]] = []
        self.out_edges: List[_SimEdge] = []
        self.consumed: List[int] = []
        self.launched = 0
        self.pushed = 0
        self.inflight: deque = deque()
        self.credit = 0
        # None sentinel, NOT 0: launches happen to start at k=1 today, but a
        # 0 sentinel would silently return the stale empty list for a future
        # needs(0) call (regression-tested in tests/test_hwsim.py)
        self._need_k: Optional[int] = None
        self._need_v: List[int] = []

    def needs(self, k: int) -> List[int]:
        if self._need_k != k:
            self._need_k = k
            self._need_v = [need(k) for _, need in self.in_edges]
        return self._need_v


@dataclass
class SimResult:
    """One simulated run (``frames`` back-to-back frames): cycle count, sink
    throughput, per-FIFO occupancy high-water marks (steady-state marks when
    ``frames > 1``), and a deadlock diagnosis (None = completed).
    ``frame_ends[i]`` is the cycle during which the sink absorbed frame i's
    last token; ``engine`` names the engine that produced the result.
    ``cycles_skipped`` counts cycles the vector engine fast-forwarded over
    stall plateaus (event-jump batching) — they are included in ``cycles``
    and deliberately NOT part of ``edge_signature``, which must be identical
    whether or not the engine jumped.  ``cycles_saved`` counts cycles the
    deadlock early-abort skipped (a provably frozen state jumps straight
    to the patient path's return cycle) — also included in ``cycles``, so
    results are bit-identical with the abort on or off."""

    cycles: int
    sink_tokens: int
    deadlock: Optional[str]
    occupancy: OccupancyTrace
    frames: int = 1
    frame_ends: List[int] = field(default_factory=list)
    engine: str = "scalar"
    cycles_skipped: int = 0
    cycles_saved: int = 0

    @property
    def completed(self) -> bool:
        return self.deadlock is None

    @property
    def throughput(self) -> Fraction:
        """Sink tokens per cycle over the simulated run."""
        if self.cycles <= 0:
            return Fraction(0)
        return Fraction(self.sink_tokens, self.cycles)

    def hwm_by_key(self) -> Dict[EdgeKey, int]:
        return self.occupancy.hwm_by_key()

    def edge_signature(self) -> List[Tuple]:
        """Canonical per-edge comparison tuple for engine-equivalence
        checks — the single definition of "bit-identical" that both the
        test suite and the hwsim-smoke CI gate compare: high-water mark,
        its (cycle, frame) stamps, and push/pop totals per edge."""
        return sorted((e.key, e.hwm, e.hwm_cycle, e.hwm_frame, e.pushed,
                       e.popped) for e in self.occupancy.per_edge)

    def report_lines(self) -> List[str]:
        status = "ok" if self.completed else f"DEADLOCK: {self.deadlock}"
        lines = [f"cycles={self.cycles} sink_tokens={self.sink_tokens} "
                 f"frames={self.frames} engine={self.engine} "
                 f"throughput={float(self.throughput):.4g} tok/cyc  {status}"]
        lines.extend(self.occupancy.report_lines())
        return lines


# --------------------------------------------------------------------------
# consumption profiles


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class NeedSpec:
    """Per-edge consumption spec shared by both engines: how many producer
    tokens (cumulative, within one frame) the consumer must have received
    before it can launch its k-th within-frame output. ``profile`` is the
    consumer's cumulative pixel-need trace for the profiled border ops
    (None = smooth proportional consumption)."""

    tpf: int                 # producer tokens per frame on this edge
    out_total: int           # consumer output tokens per frame
    profile: Optional[np.ndarray] = None   # cumulative need_px, len = out px
    v_out: int = 1
    pxs_out: int = 1
    v_in: int = 1
    pxs_in: int = 1

    def need_frame(self, k: int) -> int:
        """Tokens needed before within-frame output k (1 <= k <= out_total)."""
        if self.profile is None:
            return min(self.tpf, _ceil_div(k * self.tpf, self.out_total))
        p = min(len(self.profile), _ceil_div(k * self.v_out, self.pxs_out))
        if p <= 0:
            return 0
        npx = int(self.profile[p - 1])
        return min(self.tpf, _ceil_div(npx * self.pxs_in, self.v_in))

    def need_fn(self, frames: int = 1) -> Callable[[int], int]:
        """The scalar engine's closure: per-frame needs repeat with a
        cumulative ``tpf`` offset, so frame f's first outputs require
        (and therefore drain) everything frames 0..f-1 produced —
        including residue the earlier frames never consumed."""
        if frames == 1:
            return self.need_frame

        ot, tpf = self.out_total, self.tpf

        def need(k: int) -> int:
            f, kf = divmod(k - 1, ot)
            return f * tpf + self.need_frame(kf + 1)

        return need

    def need_array(self) -> np.ndarray:
        """Within-frame needs for k = 1..out_total as one int64 vector (the
        vectorized engine's lookup table; multi-frame offsets are applied
        arithmetically in the kernel)."""
        k = np.arange(1, self.out_total + 1, dtype=np.int64)
        if self.profile is None:
            return np.minimum(self.tpf, -((-k * self.tpf) // self.out_total))
        p = np.minimum(len(self.profile),
                       -((-k * self.v_out) // self.pxs_out))
        npx = np.asarray(self.profile, dtype=np.int64)[p - 1]
        need = np.minimum(self.tpf, -((-npx * self.pxs_in) // self.v_in))
        return np.where(p <= 0, 0, need)


def need_spec(cons: RModule, prod: RModule, tpf_e: int) -> NeedSpec:
    """Build the edge's NeedSpec: an exact pixel-level profile for the
    bursty border ops (from their core/schedule.py traces), proportional
    consumption otherwise."""
    geom = cons.info.get("geom")
    out_total = cons.iface_out.sched.tokens_per_frame
    if cons.kind not in PROFILED or not geom:
        return NeedSpec(tpf_e, out_total)
    w, h = geom["in_w"], geom["in_h"]
    if cons.kind == "Pad":
        need_px = sched.pad_need_trace(w, h, geom["l"], geom["r"],
                                       geom["b"], geom["t"])
    elif cons.kind == "Crop":
        need_px = sched.invert_trace(
            sched.crop_trace(w, h, geom["l"], geom["r"],
                             geom["b"], geom["t"]))
    else:  # Downsample
        need_px = sched.invert_trace(
            sched.downsample_trace(w, h, geom["sx"], geom["sy"]))
    return NeedSpec(tpf_e, out_total, profile=need_px,
                    v_out=cons.iface_out.sched.v,
                    pxs_out=cons.iface_out.sched.px_scalars,
                    v_in=prod.iface_out.sched.v,
                    pxs_in=prod.iface_out.sched.px_scalars)


def _need_proportional(tpf_e: int, out_total: int) -> Callable[[int], int]:
    """Back-compat helper (hand-built test graphs): smooth proportional
    single-frame needs."""
    return NeedSpec(tpf_e, out_total).need_fn()


# --------------------------------------------------------------------------
# graph construction


def build_sim(modules: Sequence[RModule], edges: Sequence[Edge],
              depths: Mapping[EdgeKey, int],
              unbounded: bool = False, frames: int = 1) -> "CycleSim":
    """Build a CycleSim over a mapped module netlist. ``depths`` maps
    (src, dst) module indices to FIFO depths; simulated capacity is
    depth + 1 (the producer's output register counts as one slot).
    ``frames`` launches that many back-to-back frames (out_totals scale,
    needs repeat per frame with cumulative offsets)."""
    if frames < 1:
        raise ValueError("frames must be >= 1")
    mods: List[_SimMod] = []
    for i, m in enumerate(modules):
        out_total = m.iface_out.sched.tokens_per_frame
        throttled = (m.kind not in PROFILED
                     and 0 < Fraction(m.rate) < 1)
        rate = Fraction(m.rate) if m.rate > 0 else Fraction(1)
        mods.append(_SimMod(i, m.name, m.kind, rate, m.latency,
                            out_total * frames, throttled))
    sim_edges: List[_SimEdge] = []
    specs: List[NeedSpec] = []
    for ei, e in enumerate(edges):
        key = (e.src, e.dst)
        cap = None if unbounded else int(depths.get(key, 0)) + 1
        se = _SimEdge(ei, key, cap, e.token_bits)
        sim_edges.append(se)
        prod, cons = modules[e.src], modules[e.dst]
        tpf_e = prod.iface_out.sched.tokens_per_frame
        spec = need_spec(cons, prod, tpf_e)
        specs.append(spec)
        mods[e.dst].in_edges.append((se, spec.need_fn(frames)))
        mods[e.dst].consumed.append(0)
        mods[e.src].out_edges.append(se)
    return CycleSim(mods, sim_edges, frames=frames, specs=specs)


# --------------------------------------------------------------------------
# the cycle engine


class CycleSim:
    """Discrete time-step engine. Two phases per cycle: (A) matured tokens
    push into downstream FIFOs (broadcast blocks on any full out-edge);
    (B) modules consume from in-edges toward their next output's needs and
    launch it when needs + rate credit allow."""

    def __init__(self, mods: List[_SimMod], edges: List[_SimEdge],
                 frames: int = 1, specs: Optional[List[NeedSpec]] = None):
        self.mods = mods
        self.edges = edges
        self.frames = frames
        self.specs = specs          # per-edge NeedSpecs (vector engine reuse)
        # only modules that participate in the dataflow are stepped: Const
        # register banks (no edges at all) are always-valid and never move
        self.active = [m for m in mods if m.in_edges or m.out_edges]
        self.sinks = [m for m in self.active
                      if m.in_edges and not m.out_edges]
        # frame accounting is anchored at the first sink: a frame "ends"
        # the cycle its last token is absorbed there
        self.frame_tokens = (self.sinks[0].out_total // frames
                             if self.sinks else 0)

    def _stall_limit(self) -> int:
        max_l = max((m.latency for m in self.active), default=0)
        max_gap = max((_ceil_div(m.rden, max(1, m.rnum))
                       for m in self.active), default=1)
        return max_l + max_gap + 64

    def _default_horizon(self) -> int:
        est = 0
        for m in self.active:
            rate = Fraction(m.rnum, m.rden)
            est = max(est, m.latency + math.ceil(m.out_total / rate))
        return 8 * est + 16 * self._stall_limit()

    def run(self, max_cycles: Optional[int] = None,
            sample_every: int = 0, early_abort: bool = True) -> SimResult:
        """``early_abort=True`` (the default) detects provably frozen
        states — zero progress, no inflight token maturing later, no
        module poppable or pending a credit-refill launch — and jumps
        straight to the cycle the patient stall-limit path would return
        at, with the identical diagnosis and ``cycles_saved`` reporting
        the skip.  Disabled automatically when sampling (a time series of
        repeated plateau samples is the caller's explicit request)."""
        horizon = max_cycles or self._default_horizon()
        stall_limit = self._stall_limit()
        t = 0
        last_progress = 0
        samples: List[Tuple[int, List[int]]] = []
        frame_ends: List[int] = []
        sink0 = self.sinks[0] if self.sinks else None
        while not all(s.launched >= s.out_total for s in self.sinks):
            if t >= horizon:
                return self._result(t, f"horizon exceeded ({horizon} cycles)",
                                    samples, frame_ends)
            if t - last_progress > stall_limit:
                return self._result(t, self._diagnose(), samples, frame_ends)
            progress = False
            # frames fully drained at the first sink as of the start of this
            # cycle — the frame stamp for high-water marks reached at t
            gframe = (sink0.launched // self.frame_tokens
                      if sink0 and self.frame_tokens else 0)
            # --- phase A: matured tokens push downstream ---
            for m in self.active:
                fl = m.inflight
                if fl and fl[0] <= t:
                    blocked = False
                    for e in m.out_edges:
                        if e.cap is not None and e.occ >= e.cap:
                            blocked = True
                            break
                    if not blocked:
                        fl.popleft()
                        m.pushed += 1
                        for e in m.out_edges:
                            e.occ += 1
                            e.pushed += 1
                            if e.occ > e.hwm:
                                e.hwm = e.occ
                                e.hwm_cycle = t
                                e.hwm_frame = gframe
                        progress = True
            if sample_every and t % sample_every == 0:
                samples.append((t, [e.occ for e in self.edges]))
            # --- phase B: consume toward the next output, then launch ---
            for m in self.active:
                if m.launched >= m.out_total:
                    continue
                k = m.launched + 1
                needs = m.needs(k)
                ready = True
                for j, (e, _) in enumerate(m.in_edges):
                    if m.consumed[j] < needs[j] and e.occ > 0:
                        e.occ -= 1
                        e.popped += 1
                        m.consumed[j] += 1
                        progress = True
                    if m.consumed[j] < needs[j]:
                        ready = False
                if m.throttled:
                    c = m.credit + m.rnum
                    if ready and c >= m.rden:
                        self._launch(m, t)
                        m.credit = c - m.rden
                        progress = True
                    else:
                        # depth-one bucket: no catch-up burst after a stall
                        m.credit = min(c, m.rden)
                elif ready:
                    self._launch(m, t)
                    progress = True
            if sink0 and self.frame_tokens:
                while (len(frame_ends) <
                       sink0.launched // self.frame_tokens):
                    frame_ends.append(t)
            if progress:
                last_progress = t
            elif early_abort and not sample_every and self._frozen(t):
                # nothing can ever move again: skip the fruitless plateau
                # and return exactly what the patient path would
                t_ret = last_progress + stall_limit + 1
                if horizon <= t_ret:
                    res = self._result(
                        horizon, f"horizon exceeded ({horizon} cycles)",
                        samples, frame_ends)
                else:
                    res = self._result(t_ret, self._diagnose(), samples,
                                       frame_ends)
                res.cycles_saved = res.cycles - (t + 1)
                return res
            t += 1
        return self._result(t, None, samples, frame_ends)

    def _frozen(self, t: int) -> bool:
        """After a zero-progress cycle: True iff the state can provably
        never change again.  Three future events could break a stall —
        an inflight token maturing at a later cycle, a ready-but-throttled
        module launching once its rate credit refills, or a pop freeing
        capacity — and a frozen state has none of them.  (A non-throttled
        ready module is impossible here: it would have launched this
        cycle, contradicting zero progress.)"""
        for m in self.active:
            if m.inflight and m.inflight[0] > t:
                return False            # matures later
            if m.launched >= m.out_total:
                continue
            k = m.launched + 1
            needs = m.needs(k)
            ready = True
            for j, (e, _) in enumerate(m.in_edges):
                if m.consumed[j] < needs[j]:
                    if e.occ > 0:
                        return False    # poppable next cycle
                    ready = False
            if ready:
                return False            # launches once credit refills
        return True

    @staticmethod
    def _launch(m: _SimMod, t: int) -> None:
        m.launched += 1
        m.inflight.append(t + m.latency)
        if not m.out_edges:          # sink: absorb, nothing matures
            m.inflight.pop()
            m.pushed += 1

    def _diagnose(self) -> str:
        why = []
        for m in self.active:
            if m.launched >= m.out_total and not m.inflight:
                continue
            k = m.launched + 1
            starved = [e.key for j, (e, _) in enumerate(m.in_edges)
                       if k <= m.out_total
                       and m.consumed[j] < m.needs(k)[j] and e.occ == 0]
            full = [e.key for e in m.out_edges
                    if m.inflight and e.cap is not None and e.occ >= e.cap]
            if starved or full:
                why.append(f"{m.name}[{m.idx}]"
                           + (f" starved on {starved}" if starved else "")
                           + (f" blocked on full {full}" if full else ""))
        return "; ".join(why) or "no token movement"

    def _result(self, t: int, deadlock: Optional[str],
                samples: List[Tuple[int, List[int]]],
                frame_ends: Optional[List[int]] = None) -> SimResult:
        per_edge = [EdgeOccupancy(e.key, None if e.cap is None else e.cap - 1,
                                  e.hwm, e.hwm_cycle, e.pushed, e.popped,
                                  e.token_bits, hwm_frame=e.hwm_frame)
                    for e in self.edges]
        occ = OccupancyTrace(per_edge, t,
                             sample_cycles=[s[0] for s in samples],
                             samples=[s[1] for s in samples] or None)
        sink_tokens = sum(s.launched for s in self.sinks)
        return SimResult(t, sink_tokens, deadlock, occ, frames=self.frames,
                         frame_ends=list(frame_ends or []), engine="scalar")


# --------------------------------------------------------------------------
# public entry point


def simulate(design, fifo_depths: Optional[Mapping[EdgeKey, int]] = None,
             unbounded: bool = False, max_cycles: Optional[int] = None,
             sample_every: int = 0, frames: int = 1,
             engine: str = "auto", device=None) -> SimResult:
    """Simulate ``frames`` back-to-back frames through ``design``
    (an HWDesign).

    ``fifo_depths`` overrides the design's solved per-edge depths (missing
    keys fall back to the analytic solution); ``unbounded=True`` removes all
    capacity limits, so the recorded high-water marks are the pipeline's
    true dynamic buffering requirement. ``engine`` selects the cycle engine:
    "vector" (the packed-state engine: the cycle kernel on ``device``
    "cuda", its plain version on "cpu"), "scalar" (the Python loop, on the
    host), or "auto": "scalar" when an occupancy time series is requested
    (sampling is scalar-only) or ``device`` is "cpu", else "vector".
    ``device`` None means "cuda", which raises without a card."""
    from .vector import is_cpu
    depths: Dict[EdgeKey, int] = dict(design.fifo.depth) if design.fifo else {}
    if fifo_depths:
        depths.update(fifo_depths)
    if engine == "auto":
        engine = "scalar" if sample_every or is_cpu(device) else "vector"
    if engine == "vector":
        if sample_every:
            raise ValueError("occupancy sampling requires engine='scalar'")
        from .vector import VectorSim
        return VectorSim(design.modules, design.edges, depths,
                         unbounded=unbounded, frames=frames,
                         device=device).run(max_cycles=max_cycles)
    if engine != "scalar":
        raise ValueError(f"unknown engine {engine!r}")
    sim = build_sim(design.modules, design.edges, depths,
                    unbounded=unbounded, frames=frames)
    return sim.run(max_cycles=max_cycles, sample_every=sample_every)
