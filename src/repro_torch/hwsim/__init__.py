"""hwsim: the cycle domain of the port (copies of the reference's scalar
engine, allocator and area model).

Where core/executor.py and core/lowering compute what a pipeline produces
(the value domain), this package computes when: a cycle-level simulation of
valid/ready token flow through the mapped RModule netlist (sim.py), per-FIFO
occupancy high-water marks (occupancy.py), a simulation-guided FIFO
allocator that tightens the analytic solve and re-simulates to prove it
(allocate.py), and the paper's auto-vs-hand area comparison (area.py).

The engine is the scalar one: ``engine="auto"`` resolves to ``"scalar"``
and ``"vector"`` raises until the vectorized engine is ported.

Entry points: ``HWDesign.simulate()`` / ``HWDesign.optimize_fifos()``, or
directly::

    from repro_torch.hwsim import simulate, allocate_fifos
    res = simulate(design)                  # SimResult
    alloc = allocate_fifos(design)          # AllocationResult, proven
"""
from .allocate import AllocationResult, allocate_fifos  # noqa: F401
from .area import (AreaRow, BRAM_CLB_EQUIV, area_units,  # noqa: F401
                   compare, fifo_area, table_lines)
from .occupancy import EdgeOccupancy, OccupancyTrace  # noqa: F401
from .sim import (CycleSim, NeedSpec, PROFILED, SimResult,  # noqa: F401
                  UNEXERCISED_BURSTY, build_sim, need_spec, simulate)
