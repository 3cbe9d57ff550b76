"""Per-FIFO occupancy accounting for the cycle simulator (hwsim.sim).

Every simulated edge records its high-water mark (max tokens resident in
the FIFO, measured after the push phase), the cycle it was first reached,
and push/pop totals; optionally a sampled occupancy time series. The
allocator (hwsim.allocate) shrinks each FIFO to ``hwm - 1`` — the -1 is the
producer's output register, which the simulator counts as one capacity slot
on every edge (capacity = depth + 1).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

EdgeKey = Tuple[int, int]


@dataclass(frozen=True)
class EdgeOccupancy:
    key: EdgeKey
    depth: Optional[int]     # allocated depth (None = unbounded run)
    hwm: int                 # max tokens resident (<= depth + 1 when bounded)
    hwm_cycle: int           # first cycle the high-water mark was reached
    pushed: int
    popped: int
    token_bits: int
    # frame during which the high-water mark was first reached (frames fully
    # drained at the sink as of that cycle) — multi-frame steady-state runs
    # can first reach their mark in a later frame than cycle 0's
    hwm_frame: int = 0

    @property
    def needed_depth(self) -> int:
        """FIFO depth this edge actually needed (high-water mark minus the
        producer's output register slot)."""
        return max(self.hwm - 1, 0)


@dataclass
class OccupancyTrace:
    per_edge: List[EdgeOccupancy]
    cycles: int
    sample_cycles: List[int] = field(default_factory=list)
    samples: Optional[List[List[int]]] = None   # sample x edge occupancy

    def hwm_by_key(self) -> Dict[EdgeKey, int]:
        """Max high-water mark per (src, dst) key (parallel edges merge)."""
        out: Dict[EdgeKey, int] = {}
        for e in self.per_edge:
            out[e.key] = max(out.get(e.key, 0), e.hwm)
        return out

    def needed_depth_by_key(self) -> Dict[EdgeKey, int]:
        out: Dict[EdgeKey, int] = {}
        for e in self.per_edge:
            out[e.key] = max(out.get(e.key, 0), e.needed_depth)
        return out

    def report_lines(self, modules: Optional[Sequence] = None) -> List[str]:
        def name(i: int) -> str:
            if modules is not None and 0 <= i < len(modules):
                return f"{modules[i].name}[{i}]"
            return str(i)

        lines = []
        for e in sorted(self.per_edge, key=lambda x: -x.needed_depth)[:12]:
            cap = "inf" if e.depth is None else str(e.depth)
            lines.append(
                f"fifo {name(e.key[0])}->{name(e.key[1])}: "
                f"hwm={e.hwm} (depth {cap}) at cycle {e.hwm_cycle} "
                f"frame {e.hwm_frame}, "
                f"{e.pushed} pushed / {e.popped} popped")
        return lines

    def as_dict(self) -> Dict[str, Dict[str, int]]:
        return {f"{k[0]}->{k[1]}": d
                for k, d in self.needed_depth_by_key().items()}
