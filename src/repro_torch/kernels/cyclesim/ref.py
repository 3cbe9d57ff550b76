"""The plain version of the cycle kernel: each design through the packed
recurrence's per-cycle torch operations (``hwsim.vector.VectorSim``'s
``_run_plain``), one design after another, on the CPU."""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch


def cycle_sim_ref(sim, caps: torch.Tensor, horizon: int, stall_limit: int,
                  event_jump: bool = True
                  ) -> List[Tuple[dict, List[int], Optional[int]]]:
    """Run every row of ``caps`` (K, E) over ``sim``'s packed netlist to
    its stop code: per design, its final state, its frame-end cycles and
    its stop code (None when done)."""
    return [sim.with_caps(row)._run_plain(horizon, stall_limit, event_jump)
            for row in caps.cpu().numpy()]
