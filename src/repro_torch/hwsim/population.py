"""Design-population batching: many FIFO capacity vectors, one launch.

The design-space explorer evaluates dozens of FIFO-depth variants of the
same mapped netlist.  Each variant changes only the per-edge capacity
vector (the module graph, rates, latencies and need tables are shared),
so the packed-state recurrence of ``vector.VectorSim`` runs K designs at
once through the cycle kernel's wrapper (``kernels/cyclesim``): on the
card, one launch of ``csrc/cyclesim.cu`` with one thread block per
design; on the CPU, the plain version design after design (the engine
name is then the reference's ``"population-serial"``).

Each design keeps its own clock and makes its own event jumps.  The
reference advances its population on one global clock and jumps only
when every running design is mid-plateau, which keeps XLA's gathers small;
a design's results do not depend on that.  So every ``SimResult`` field is
the one a serial ``VectorSim`` run of the same capacity vector gives,
``cycles_skipped`` and ``cycles_saved`` included (the reference's
population counts its skipped cycles on the global clock, and sets no
``cycles_saved``).
"""
from __future__ import annotations

from typing import List, Mapping, Optional, Sequence

import numpy as np

from ..core.buffers import Edge
from ..core.rigel import RModule
from .sim import EdgeKey, SimResult
from .vector import VectorSim


class PopulationSim:
    """Batched cycle simulation of K capacity vectors over one netlist.

    ``depth_sets`` is a sequence of per-edge depth mappings (missing keys
    default to depth 0, capacity 1, exactly like ``VectorSim``); all other
    netlist structure is shared.  ``run()`` returns one ``SimResult`` per
    depth set, in order.  ``device`` is ``"cuda"`` (None, one kernel
    launch) or ``"cpu"`` (the plain version, serially)."""

    def __init__(self, modules: Sequence[RModule], edges: Sequence[Edge],
                 depth_sets: Sequence[Mapping[EdgeKey, int]],
                 frames: int = 1, device=None):
        if not depth_sets:
            raise ValueError("depth_sets must be non-empty")
        self.base = VectorSim(modules, edges, depth_sets[0], frames=frames,
                              device=device)
        self.K = len(depth_sets)
        self.frames = frames
        b = self.base
        self.caps = np.array(
            [[int(ds.get(k, 0)) + 1 for k in b.keys] for ds in depth_sets],
            np.int64).reshape(self.K, b.E)

    # -- entry ----------------------------------------------------------
    def run(self, max_cycles: Optional[int] = None,
            event_jump: bool = True) -> List[SimResult]:
        import torch
        from ..kernels.cyclesim import cycle_sim
        b = self.base
        horizon = max_cycles or b._default_horizon()
        caps = torch.from_numpy(self.caps.copy()).to(b.device)
        runs = cycle_sim(b, caps, horizon, b._stall_limit(), event_jump)
        return [self._result(run, k, horizon)
                for k, run in enumerate(runs)]

    def _result(self, run, k: int, horizon: int) -> SimResult:
        s, frame_ends, code = run
        engine = "population-serial" if self.base.device == "cpu" \
            else "population"
        return self.base._result(s, frame_ends, code, horizon,
                                 cap=self.caps[k], engine=engine)
