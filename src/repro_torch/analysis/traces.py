"""Symbolic trace algebra over netlist edges (paper §4.2, completed).

``handshake.py``'s numeric trace replay is exact only on rate-matched
pixel-streaming edges.  This module closes the gap with a small symbolic
algebra of **ultimately-periodic phase traces** — cumulative token curves
``min(total, burst + rate * (t - offset))`` — derived from the same
``need_spec`` machinery the cycle simulator executes, and extends static
certification to the three edge classes the numeric model skips:

  - **dma-frame**: frame-granular production (one token carries a whole
    frame/buffer handle, ``tpf`` of 1-ish) feeding a pixel-streaming
    consumer — the producer's trace is a step function, not a slope;
  - **serializer**: ``Serialize``/``Deserialize`` rate conversion — token
    granularity changes across the module, so the two sides of its edges
    legitimately disagree on per-frame token counts;
  - **data-dependent**: ``Filter``/``SparseTake``/``External`` consumers,
    whose consumption timing depends on data the static model never sees —
    bounded by a worst-case rate envelope instead of an exact trace.

Every edge gets an :class:`EdgeCertificate` with a *sound* occupancy floor
and ceiling (``floor <= simulated hwm <= ceiling``, asserted by the
three-way differential oracle in ``handshake.cross_check``), so no edge is
left "unmodeled".

The same algebra feeds the analytic FIFO solver: **cross-arm demand gaps**
on broadcast (fan-out) edges.  A broadcast producer pushes in lockstep on
every out-edge, but each arm's consumer only ever pops its own per-frame
total need ``N_i`` (pops are demand-driven: a consumer stops popping once
its remaining launches need nothing more).  For the producer to deliver
``max_j N_j`` tokens to the hungriest arm, every other arm ``i`` must have
capacity for the ``max_j N_j - N_i`` tokens it will receive but never pop
— dead residue that sits in the FIFO until frame end.  The per-edge slack
LP (core/buffers.py) cannot see this (it is a property of the *sibling*
arm), which is exactly why PYRAMID's reconvergent Downsample/Upsample
diamond deadlocked at the analytic depths: the Downsample arm consumes
1983 of the 2048 broadcast tokens, so the fanout edge must hold the 65
tokens the AbsDiff arm still needs pushed.  ``broadcast_extra_slots``
computes these gaps; ``compile_pipeline`` adds them to the analytic
depths, and ``required_capacities``/``deadlock_reason`` give the
design-space explorer a static pre-filter that rejects provably
deadlocked candidates before simulation.
"""
from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..hwsim.sim import UNEXERCISED_BURSTY, need_spec

EdgeKey = Tuple[int, int]

# the verdict ladder's certified edge classes, most exact first
EDGE_CLASSES = ("stream", "dma-frame", "serializer", "data-dependent")

_SERIALIZERS = ("Serialize", "Deserialize")


@dataclass(frozen=True)
class PhaseTrace:
    """One ultimately-periodic cumulative token curve:

        cum(t) = clip(burst + rate * (t - offset), 0, total)

    ``burst`` tokens may appear instantaneously at ``offset`` (the §4.3
    burstiness allowance); after that the curve climbs at ``rate`` tokens
    per cycle until it saturates at ``total`` (one frame's worth).  This is
    the closed form of the paper's (L, B) fit: L maps to ``offset``, B to
    ``burst``."""

    rate: Fraction
    burst: int
    offset: int
    total: int

    def cum(self, t: np.ndarray) -> np.ndarray:
        """Cumulative tokens by the end of cycle ``t`` (vectorized)."""
        t = np.asarray(t, dtype=np.int64)
        num, den = self.rate.numerator, self.rate.denominator
        lin = self.burst + ((t - self.offset) * num) // den
        return np.clip(lin, 0, self.total)

    def saturation_cycle(self) -> int:
        """First cycle at which ``cum`` reaches ``total``."""
        if self.rate <= 0:
            return self.offset
        gap = max(0, self.total - self.burst)
        return self.offset + -(-gap * self.rate.denominator
                               // self.rate.numerator)

    @classmethod
    def fit(cls, table: np.ndarray, rate: Fraction,
            total: Optional[int] = None) -> "PhaseTrace":
        """Tightest phase trace *dominating* a cumulative table: the least
        ``burst`` such that ``table[t] <= burst + rate * t`` for all t —
        the symbolic upper envelope of a profiled production/consumption
        trace (the dual of ``schedule.fit_LB``, which fits a *lower*
        envelope)."""
        table = np.asarray(table, dtype=np.int64)
        t = np.arange(len(table), dtype=np.int64)
        num, den = rate.numerator, rate.denominator
        slope = (t * num) // den
        burst = int(np.max(table - slope)) if len(table) else 0
        return cls(rate=rate, burst=max(0, burst), offset=0,
                   total=int(total if total is not None
                             else (table[-1] if len(table) else 0)))


def peak_backlog(prod: PhaseTrace, cons: PhaseTrace) -> int:
    """Exact maximum of ``prod.cum(t) - cons.cum(t)`` over all t >= 0.

    Both curves are piecewise linear with at most two breakpoints each
    (ramp start, saturation), so the difference is piecewise linear and
    its maximum is attained at a breakpoint — evaluate there instead of
    scanning a horizon."""
    pts = {0, prod.offset, prod.saturation_cycle(),
           cons.offset, cons.saturation_cycle()}
    # the difference is linear between adjacent breakpoints; include each
    # breakpoint's predecessor so one-sided corners are sampled too
    pts |= {max(0, p - 1) for p in list(pts)} | {p + 1 for p in list(pts)}
    t = np.array(sorted(p for p in pts if p >= 0), dtype=np.int64)
    return int(np.max(prod.cum(t) - cons.cum(t))) if len(t) else 0


@dataclass(frozen=True)
class EdgeCertificate:
    """One edge's certified static occupancy bracket.

    ``floor <= simulated high-water mark <= ceiling`` holds for a
    single-frame run at the installed depth, for every edge class:

      - floor: a consumer that needs >= 1 token forces occupancy 1 (a
        token must be pushed before it can be popped, and the push records
        the mark);
      - ceiling: occupancy never exceeds the installed capacity
        (``depth + 1``; the simulator enforces it) nor the producer's
        per-frame token total (a single frame cannot push more).

    ``production`` is the producer's symbolic phase trace; for
    data-dependent consumers ``consumption`` is the worst-case (slowest)
    bounded-rate envelope rather than an exact trace."""

    key: EdgeKey
    klass: str                  # one of EDGE_CLASSES
    floor: int
    ceiling: int
    need_total: int             # consumer's per-frame total need
    tpf: int                    # producer tokens per frame on this edge
    production: PhaseTrace
    consumption: Optional[PhaseTrace] = None

    def line(self) -> str:
        return (f"{self.key[0]:3d}->{self.key[1]:<3d} [{self.klass}] "
                f"hwm in [{self.floor}, {self.ceiling}] "
                f"(tpf={self.tpf} need={self.need_total})")


def classify_edge(prod, cons) -> str:
    """Edge class for the certificate ladder (see EDGE_CLASSES)."""
    if prod.kind in _SERIALIZERS or cons.kind in _SERIALIZERS:
        return "serializer"
    if prod.kind in UNEXERCISED_BURSTY or cons.kind in UNEXERCISED_BURSTY:
        return "data-dependent"
    ps = prod.iface_out.sched
    ci = (cons.iface_in or cons.iface_out).sched
    if ps.tokens_per_frame < ci.tokens_per_frame:
        # one producer token unlocks many consumer launches: the token is
        # a frame/buffer handle, not a pixel (DMA-granular production)
        return "dma-frame"
    return "stream"


def edge_need_totals(modules, edges) -> Dict[EdgeKey, int]:
    """Per-edge per-frame total consumption need (parallel edges merged by
    min — the demand-driven pop argument holds per physical FIFO, and the
    smallest willingness is the binding one)."""
    out: Dict[EdgeKey, int] = {}
    for e in edges:
        prod, cons = modules[e.src], modules[e.dst]
        tpf_e = prod.iface_out.sched.tokens_per_frame
        spec = need_spec(cons, prod, tpf_e)
        n = spec.need_frame(spec.out_total)
        key = (e.src, e.dst)
        out[key] = min(out.get(key, n), n)
    return out


def certify_edges(modules, edges,
                  depths: Mapping[EdgeKey, int]) -> List[EdgeCertificate]:
    """Sound per-edge occupancy certificates for every edge (no edge class
    is left unmodeled); see :class:`EdgeCertificate` for the bracket."""
    certs: List[EdgeCertificate] = []
    for e in edges:
        prod, cons = modules[e.src], modules[e.dst]
        tpf_e = prod.iface_out.sched.tokens_per_frame
        spec = need_spec(cons, prod, tpf_e)
        n_total = spec.need_frame(spec.out_total)
        klass = classify_edge(prod, cons)
        rate = Fraction(prod.rate) if prod.rate > 0 else Fraction(1)
        production = PhaseTrace(rate=rate, burst=e.src_burst,
                                offset=prod.latency, total=tpf_e)
        consumption = None
        if klass == "data-dependent" and spec.out_total > 0:
            # bounded-rate envelope: the consumer pops no faster than one
            # token per cycle and no more than its per-frame total
            consumption = PhaseTrace(rate=Fraction(1), burst=0, offset=0,
                                     total=n_total)
        cap = int(depths.get((e.src, e.dst), 0)) + 1
        certs.append(EdgeCertificate(
            key=(e.src, e.dst), klass=klass,
            floor=1 if n_total >= 1 else 0,
            ceiling=min(cap, tpf_e),
            need_total=n_total, tpf=tpf_e,
            production=production, consumption=consumption))
    return certs


# --------------------------------------------------------------------------
# cross-arm demand gaps on broadcast edges


def broadcast_gaps(tpf: Mapping[EdgeKey, int],
                   need_total: Mapping[EdgeKey, int]) -> Dict[EdgeKey, int]:
    """Pure form of the cross-arm rule: for each out-edge ``i`` of a
    multi-out producer, the capacity the edge must add for tokens it will
    receive (the producer pushes in lockstep, up to the hungriest arm's
    demand) but its own consumer never pops::

        gap_i = max(0, max_j need_total_j - need_total_i)

    Only edges with a positive gap appear in the result.  Sound because a
    consumer's pops are demand-driven (it pops everything pushed until its
    per-frame total, then stops), so at frame end exactly
    ``pushed - need_total_i`` tokens are stranded in FIFO ``i`` — and
    ``pushed`` must reach ``max_j need_total_j`` for every arm's consumer
    (and everything downstream of it) to finish the frame."""
    by_src: Dict[int, List[EdgeKey]] = {}
    for key in tpf:
        by_src.setdefault(key[0], []).append(key)
    gaps: Dict[EdgeKey, int] = {}
    for src, keys in by_src.items():
        if len(keys) < 2:
            continue
        hungriest = max(need_total[k] for k in keys)
        for k in keys:
            gap = hungriest - need_total[k]
            if gap > 0:
                gaps[k] = gap
    return gaps


def broadcast_extra_slots(modules, edges) -> Dict[EdgeKey, int]:
    """Cross-arm demand gaps for a mapped netlist: extra FIFO slots each
    broadcast out-edge needs on top of the per-edge slack LP's depths
    (``core.buffers.solve_buffers(extra_slots=...)``)."""
    needs = edge_need_totals(modules, edges)
    tpf = {k: modules[k[0]].iface_out.sched.tokens_per_frame for k in needs}
    return broadcast_gaps(tpf, needs)


def required_capacities(modules, edges) -> Dict[EdgeKey, int]:
    """Minimum per-FIFO capacity (``depth + 1``) for the netlist to be
    free of broadcast-residue deadlock: the cross-arm gap itself.  A
    candidate allocation below any of these capacities provably deadlocks
    (see ``deadlock_reason``); meeting them does not by itself prove
    liveness — that remains the cross-check's job."""
    return dict(broadcast_extra_slots(modules, edges))


def deadlock_reason(depths: Mapping[EdgeKey, int],
                    required: Mapping[EdgeKey, int]) -> Optional[str]:
    """Statically decide whether ``depths`` provably deadlock: some
    broadcast out-edge has less capacity than the dead residue it must
    hold, so its producer blocks forever before the hungriest sibling arm
    is served.  Returns the proof as a diagnosis string, or None."""
    for key in sorted(required):
        cap = int(depths.get(key, 0)) + 1
        if cap < required[key]:
            return (f"fifo {key}: capacity {cap} < {required[key]} tokens "
                    "of cross-arm broadcast residue (statically certain "
                    "deadlock)")
    return None


__all__ = [
    "EDGE_CLASSES", "PhaseTrace", "EdgeCertificate", "peak_backlog",
    "classify_edge", "certify_edges", "edge_need_totals", "broadcast_gaps",
    "broadcast_extra_slots", "required_capacities", "deadlock_reason",
]
