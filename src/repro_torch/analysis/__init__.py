"""Static analyses of the port.

  verify_ir.py — the lowering IR's structural invariants (``verify_ir``:
                 what ``apply_rules`` checks after every rewrite);
  traces.py    — the symbolic phase-trace algebra over the mapped netlist:
                 edge classes, certified occupancy brackets, deadlock
                 proofs, and the cross-arm broadcast demand gaps
                 (``broadcast_extra_slots``) the analytic FIFO solve
                 provisions for.

Importing this package loads neither the lowering nor torch:
``compile_pipeline`` reaches ``traces`` through it.
"""
from .traces import (EDGE_CLASSES, EdgeCertificate, PhaseTrace,  # noqa: F401
                     broadcast_extra_slots, broadcast_gaps, certify_edges,
                     classify_edge, deadlock_reason, edge_need_totals,
                     peak_backlog, required_capacities)
