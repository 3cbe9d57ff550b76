"""hwsim: the cycle domain of the port.

Where core/executor.py and core/lowering compute what a pipeline produces
(the value domain), this package computes when: a cycle-level simulation of
valid/ready token flow through the mapped RModule netlist (sim.py, the
scalar engine on the host; vector.py, the packed-state engine: the cycle
kernel ``csrc/cyclesim.cu`` on the card, its plain version on the CPU),
many FIFO-depth variants of one netlist at once (population.py, one kernel
launch), per-FIFO occupancy high-water marks (occupancy.py), a
simulation-guided FIFO allocator that tightens the analytic solve and
re-simulates to prove it (allocate.py), the paper's auto-vs-hand area
comparison (area.py), and the serve-ingest queue model (ingest.py).

``engine="auto"`` runs the kernel on ``device="cuda"`` (the default, which
raises without a card) and the scalar engine on ``device="cpu"``.

Entry points: ``HWDesign.simulate()`` / ``HWDesign.optimize_fifos()``, or
directly::

    from repro_torch.hwsim import simulate, allocate_fifos
    res = simulate(design)                  # SimResult, on the card
    alloc = allocate_fifos(design, device="cpu")   # proven, on the host
"""
from .allocate import (AllocationError, AllocationResult,  # noqa: F401
                       allocate_fifos)
from .area import (AreaRow, BRAM_CLB_EQUIV, area_units,  # noqa: F401
                   compare, fifo_area, table_lines)
from .ingest import (IngestResult, poisson_arrival_cycles,  # noqa: F401
                     replay_ingest, simulate_ingest)
from .occupancy import EdgeOccupancy, OccupancyTrace  # noqa: F401
from .sim import (CycleSim, NeedSpec, PROFILED, SimResult,  # noqa: F401
                  UNEXERCISED_BURSTY, build_sim, need_spec, simulate)
from .vector import VectorSim  # noqa: F401


def __getattr__(name):
    # lazy: population batching is only used by repro_torch.explore sweeps
    if name == "PopulationSim":
        from .population import PopulationSim
        return PopulationSim
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
