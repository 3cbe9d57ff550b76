"""Pass 1 of the lowering compiler: an explicit lowering IR.

``LoweringIR`` is built once from the HWImg ``Val`` DAG and replaces the
scattered ``toposort``/``_consumer_counts`` walks of the old single-pass
lowerer with a node table plus use-def edges.  Every node carries its
type/shape/scalar metadata and a live consumer list, so rewrite rules
(rewrite.py) and the execution engine (engine.py) never re-derive them.

The IR is a mutable graph: the rewrite engine attaches fused ``Dispatch``
records to pattern roots, rewires nodes (identity collapses), or replaces a
node in place with a new op (algebraic rewrites such as pyramid collapse).
After every mutation ``refresh()`` recomputes liveness, the schedule and the
consumer lists; interiors of a fused region become dead and drop out of the
schedule automatically (dead-code elimination).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..dtypes import DType
from ..hwimg import Val, scalar_of, toposort, type_shape


@dataclass(frozen=True)
class Dispatch:
    """A fused-region dispatch attached to a pattern root: the region is
    replaced by ``apply(*leaf_values)`` (leaves are uids of the region's
    graph inputs)."""

    kernel: str
    leaves: Tuple[int, ...]
    apply: Callable
    note: str


@dataclass
class IRNode:
    """One node of the lowering IR (the table row for one HWImg Val)."""

    uid: int
    op: str
    params: Dict[str, Any]
    inputs: Tuple[int, ...]            # producer uids, in operand order
    ty: DType
    shape: Tuple[int, ...]             # trailing ndarray shape (type_shape)
    scalar: DType                      # scalar leaf type
    input_tys: Tuple[DType, ...]
    consumers: List[int] = field(default_factory=list)  # one entry per use
    dispatch: Optional[Dispatch] = None

    @property
    def ncons(self) -> int:
        return len(self.consumers)

    def __repr__(self):
        return f"%{self.uid}={self.op}"


class LoweringIR:
    """Node table + use-def edges for one pipeline output."""

    def __init__(self, out: Val):
        self.nodes: Dict[int, IRNode] = {}
        for v in toposort(out):
            self.nodes[v.uid] = IRNode(
                uid=v.uid, op=v.op, params=v.p, inputs=tuple(
                    i.uid for i in v.inputs),
                ty=v.ty, shape=type_shape(v.ty), scalar=scalar_of(v.ty),
                input_tys=tuple(i.ty for i in v.inputs))
        self.root: int = out.uid
        self._next_uid = max(self.nodes) + 1
        self.order: List[IRNode] = []
        self.refresh()

    # ---- queries ----
    def node(self, uid: int) -> IRNode:
        return self.nodes[uid]

    def effective_inputs(self, n: IRNode) -> Tuple[int, ...]:
        """Scheduling inputs: a dispatched node depends only on its fused
        region's leaves; everything strictly inside the region is dead."""
        return n.dispatch.leaves if n.dispatch is not None else n.inputs

    # ---- mutation (used by the rewrite engine) ----
    def set_dispatch(self, uid: int, d: Dispatch) -> None:
        self.nodes[uid].dispatch = d
        self.refresh()

    def rewire(self, old_uid: int, new_uid: int) -> None:
        """Replace every use of old_uid with new_uid (identity collapse) —
        including uses as a fused region's leaf, or the rewired node would
        stay live through effective_inputs and rematch forever."""
        for n in self.nodes.values():
            if old_uid in n.inputs:
                n.inputs = tuple(new_uid if u == old_uid else u
                                 for u in n.inputs)
                n.input_tys = tuple(self.nodes[u].ty for u in n.inputs)
            if n.dispatch is not None and old_uid in n.dispatch.leaves:
                n.dispatch = dataclasses.replace(
                    n.dispatch, leaves=tuple(
                        new_uid if u == old_uid else u
                        for u in n.dispatch.leaves))
        if self.root == old_uid:
            self.root = new_uid
        self.refresh()

    def replace_op(self, uid: int, op: str, params: Dict[str, Any],
                   inputs: Tuple[int, ...]) -> None:
        """Replace a node in place with a new op of the same type (algebraic
        rewrite); consumers keep pointing at ``uid``."""
        n = self.nodes[uid]
        n.op, n.params, n.inputs = op, params, tuple(inputs)
        n.dispatch = None
        n.input_tys = tuple(self.nodes[u].ty for u in n.inputs)
        self.refresh()

    # ---- liveness / schedule / consumers ----
    def refresh(self) -> None:
        """Recompute the live set from the root (following effective
        inputs), the topological schedule over it, and per-node consumer
        lists. Dead nodes stay in the table but leave the schedule."""
        order: List[IRNode] = []
        seen = set()

        def visit(uid: int):
            if uid in seen:
                return
            seen.add(uid)
            n = self.nodes[uid]
            for i in self.effective_inputs(n):
                visit(i)
            order.append(n)

        visit(self.root)
        self.order = order
        for n in self.nodes.values():
            n.consumers = []
        for n in order:
            for i in self.effective_inputs(n):
                self.nodes[i].consumers.append(n.uid)

    @property
    def live_uids(self) -> set:
        return {n.uid for n in self.order}
