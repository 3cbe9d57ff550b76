"""Pipeline-parallel stage-buffer planning via the paper's register
minimization solve (§4.2 reused at cluster scale).

A 1F1B pipeline is a multi-rate dataflow graph: each stage is a module with
latency = its pipeline depth (in microbatch ticks) and rate 1 (one
microbatch per tick in steady state); the backward stage consumes the
forward stage's stashed activations. Solving the same difference-constraint
system that sizes FIFOs on the FPGA yields the number of in-flight
microbatches each stage must buffer — recovering the classic 1F1B result
(stage i stashes p - i activations) from first principles, and generalizing
to uneven stage latencies (e.g. a heavier embedding stage) where the
classic formula does not hold.

The counterpart of ``repro.parallel.pipeline`` (host code, on the port's
``core.buffers``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

from ..core import buffers as buf


@dataclass
class PPlan:
    n_stages: int
    n_microbatches: int
    stash_per_stage: List[int]       # activations buffered per stage
    total_stash: int
    bubble_ticks: int                # warmup+drain bubble
    steady_efficiency: float         # useful ticks / total ticks


def plan_1f1b(n_stages: int, n_microbatches: int,
              stage_latency: Optional[List[int]] = None,
              bwd_factor: int = 2,
              activation_bytes: int = 1) -> PPlan:
    """Size the activation stash of every stage with the §4.2 solver.

    Module graph: fwd_0 -> fwd_1 -> ... -> fwd_{p-1} -> bwd_{p-1} -> ...
    -> bwd_0. Edge fwd_i -> bwd_i carries the stashed activations; its
    solved slack (+1 for the in-flight microbatch) is the stash depth.
    """
    p = n_stages
    lat = stage_latency or [1] * p
    # module ids: fwd 0..p-1, bwd p..2p-1 (bwd stage i = id p + (p-1-i))
    edges = []
    for i in range(p - 1):
        edges.append(buf.Edge(i, i + 1, 0, lat[i], 0))          # fwd chain
    for j in range(p - 1):
        # bwd chain runs in reverse stage order; bwd of stage k has latency
        # bwd_factor * lat[k]
        k_from = p - 1 - j
        edges.append(buf.Edge(p + j, p + j + 1, 0,
                              bwd_factor * lat[k_from], 0))
    edges.append(buf.Edge(p - 1, p, 0, lat[p - 1], 0))          # turnaround
    # stash edges: fwd_i -> bwd_i (token bits = activation bytes: this is
    # what the objective minimizes)
    stash_edges = []
    for i in range(p):
        e = buf.Edge(i, p + (p - 1 - i), activation_bytes, lat[i], 0)
        edges.append(e)
        stash_edges.append(e)

    sol = buf.solve_buffers(2 * p, edges, solver="lp")
    # §4.2: a FIFO delaying by d ticks at rate R holds ceil(d*R) tokens; in
    # steady 1F1B each stage serves one microbatch every (1+bwd_factor)
    # ticks, so the stash in *microbatches* is ceil(slack / (1+bwd)).
    # (+1: the microbatch currently being computed is also resident)
    stash = [math.ceil(sol.slack[(e.src, e.dst)] / (1 + bwd_factor)) + 1
             for e in stash_edges]

    total_lat = sum(lat) + bwd_factor * sum(lat)
    ticks = (n_microbatches * (1 + bwd_factor) * max(lat)) + total_lat
    useful = n_microbatches * (1 + bwd_factor) * max(lat)
    return PPlan(p, n_microbatches, stash, sum(stash),
                 bubble_ticks=total_lat,
                 steady_efficiency=useful / ticks)
