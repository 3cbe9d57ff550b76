"""FIFO buffer allocation: the register-minimization solve (paper §4.2-4.3).

Given the mapped module DAG with per-module latency L_m and burstiness B_m,
assign each module a start offset s_m such that every consumer starts no
earlier than its producers deliver:

    s_c - s_p - L_p >= 0            for every edge p -> c

and minimize the total buffering   sum_e bits_e * (s_c - s_p - L_p).
A FIFO of depth (s_c - s_p - L_p) + B_p is then placed on each edge: the
slack delays the producer's trace to match the consumer, and B_p extra slots
absorb the producer's bursts (§4.3).

The paper solves this with Z3; we do the same, with a scipy linprog fallback
(the constraint matrix is totally unimodular, so the LP relaxation is
integral — the problem is the classic retiming/register-minimization LP
[Leiserson & Saxe]).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class Edge:
    src: int          # module index
    dst: int          # module index
    token_bits: int
    src_latency: int
    src_burst: int


@dataclass
class BufferSolution:
    start: List[int]                 # s_m per module
    slack: Dict[Tuple[int, int], int]   # per-edge delay-FIFO depth
    depth: Dict[Tuple[int, int], int]   # slack + burst  (total FIFO depth)
    total_bits: int
    solver: str

    def with_depths(self, depth: Dict[Tuple[int, int], int],
                    edges: Sequence[Edge],
                    solver: Optional[str] = None) -> "BufferSolution":
        """A copy of this solution with ``depth`` installed (and total_bits
        recomputed from ``edges``): how the simulation-guided allocator's
        proven depths replace the analytic ones in ``fifo_solver="sim"``
        mode. Start offsets are untouched — shrinking capacity toward the
        simulated high-water marks does not move the schedule."""
        bits = {(e.src, e.dst): e.token_bits for e in edges}
        total = sum(d * bits[k] for k, d in depth.items())
        return BufferSolution(list(self.start), dict(self.slack),
                              dict(depth), total, solver or self.solver)


def solve_buffers(n_modules: int, edges: Sequence[Edge],
                  solver: str = "z3",
                  include_burst: bool = True,
                  extra_slots: Optional[Mapping[Tuple[int, int], int]]
                  = None) -> BufferSolution:
    """Solve the register-minimization problem.

    solver: "z3" (paper-faithful), "lp" (scipy), or "asap" (no optimization:
    earliest-start longest-path schedule, which is what careful manual
    allocation achieves on in-tree pipelines).

    ``extra_slots`` adds per-edge slots on top of the solved slack + burst:
    the cross-arm demand gaps of reconvergent broadcast joins
    (``analysis.traces.broadcast_extra_slots``), which are a property of an
    edge's *sibling* arms and therefore invisible to this per-edge LP — a
    broadcast out-edge must also hold the tokens it receives in lockstep
    with the hungriest arm but whose own consumer never pops them.
    """
    if n_modules == 0:
        return BufferSolution([], {}, {}, 0, solver)
    if solver == "z3":
        start = _solve_z3(n_modules, edges)
        if start is None:  # z3 budget expired -> exact LP (same optimum)
            start = _solve_lp(n_modules, edges)
    elif solver == "lp":
        start = _solve_lp(n_modules, edges)
    elif solver == "asap":
        start = _solve_asap(n_modules, edges)
    else:
        raise ValueError(f"unknown solver {solver}")

    # normalize: a uniform shift of all starts changes nothing (§4.2 traces
    # are shift-invariant); pin the earliest module to cycle 0
    lo = min(start)
    start = [s - lo for s in start]

    slack, depth, total = {}, {}, 0
    for e in edges:
        sl = start[e.dst] - start[e.src] - e.src_latency
        assert sl >= 0, (e, start[e.src], start[e.dst])
        d = sl + (e.src_burst if include_burst else 0)
        if extra_slots:
            d += int(extra_slots.get((e.src, e.dst), 0))
        slack[(e.src, e.dst)] = sl
        depth[(e.src, e.dst)] = d
        total += d * e.token_bits
    return BufferSolution(start, slack, depth, total, solver)


def _solve_z3(n: int, edges: Sequence[Edge]) -> Optional[List[int]]:
    try:
        import z3
    except ImportError:  # pragma: no cover
        return None
    # fresh context per solve: Z3's shared global context degrades after
    # many Optimize instances (measured: a 0.1 s instance hanging for
    # minutes mid-sweep). Z3's Optimize is also erratic on big-coefficient
    # register-min instances even with a fresh context, so the budget is
    # short and solve_buffers falls back to the exact LP (identical optima
    # — property-tested) when it expires.
    ctx = z3.Context()
    opt = z3.Optimize(ctx=ctx)
    opt.set(timeout=2_000)
    s = [z3.Int(f"s{i}", ctx=ctx) for i in range(n)]
    for v in s:
        opt.add(v >= 0)
    obj = 0
    for e in edges:
        opt.add(s[e.dst] - s[e.src] - e.src_latency >= 0)
        obj = obj + e.token_bits * (s[e.dst] - s[e.src] - e.src_latency)
    opt.minimize(obj)
    if str(opt.check()) != "sat":
        return None
    m = opt.model()
    return [m.eval(v).as_long() for v in s]


def _solve_lp(n: int, edges: Sequence[Edge]) -> List[int]:
    from scipy.optimize import linprog
    # objective: sum_e b_e (s_c - s_p)  (constant -b_e*L_e dropped)
    c = np.zeros(n)
    for e in edges:
        c[e.dst] += e.token_bits
        c[e.src] -= e.token_bits
    A, b = [], []
    for e in edges:
        row = np.zeros(n)
        row[e.src] = 1.0
        row[e.dst] = -1.0
        A.append(row)
        b.append(-float(e.src_latency))
    res = linprog(c, A_ub=np.asarray(A), b_ub=np.asarray(b),
                  bounds=[(0, None)] * n, method="highs")
    assert res.success, res.message
    return [int(round(x)) for x in res.x]


def _solve_asap(n: int, edges: Sequence[Edge]) -> List[int]:
    """Longest-path earliest start (no reconvergence optimization)."""
    s = [0] * n
    # relax edges |V| times (the DAG is small; Bellman-Ford style)
    for _ in range(n):
        changed = False
        for e in edges:
            need = s[e.src] + e.src_latency
            if s[e.dst] < need:
                s[e.dst] = need
                changed = True
        if not changed:
            break
    return s
