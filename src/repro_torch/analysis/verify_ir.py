"""Pass 2 of the static verifier: LoweringIR structural invariants.

The lowering IR (core/lowering/ir.py) is a *mutable* graph the rewrite
engine edits in place (``set_dispatch`` / ``replace_op`` / ``rewire``).  A
buggy rewrite rule used to surface three layers later as a bit-exactness
diff; ``check_ir`` makes it fail at the rule instead.  Checked invariants:

  1. use-def consistency — every input uid resolves, ``input_tys`` matches
     the producers' current types (``rewire``/``replace_op`` must keep them
     in sync);
  2. schedule sanity / acyclicity — every live node's effective inputs are
     scheduled *before* it.  ``refresh()``'s DFS terminates on a cyclic
     graph (seen-set) but emits an out-of-order schedule, so this check is
     exactly the cycle detector;
  3. no dangling consumers — consumer lists point at live nodes that
     really reference the producer through their effective inputs;
  4. dispatch hygiene — fused-region leaves resolve to live nodes;
  5. metadata/type preservation — ``shape``/``scalar`` match ``ty``, and
     re-running the op's ``infer`` over the current input types reproduces
     the node's recorded type (Replace must be type-preserving).

``apply_rules`` calls ``check_ir`` after every mutation (on by default;
exported kill-switch env var ``REPRO_VERIFY_IR=0``) and raises
``InvariantViolation`` naming the offending rule.
"""
from __future__ import annotations

import os
from typing import List, Optional

from ..core.hwimg import OPS, scalar_of, type_shape
from ..core.lowering.ir import LoweringIR

VERIFY_ENV = "REPRO_VERIFY_IR"

# ops whose recorded type is an input contract, not inferable from inputs
_NO_REINFER = ("Input", "Const", "External")


class InvariantViolation(RuntimeError):
    """A rewrite left the lowering IR structurally inconsistent."""

    def __init__(self, context: str, violations: List[str]):
        self.context = context
        self.violations = list(violations)
        detail = "\n  ".join(self.violations)
        super().__init__(
            f"IR invariant violated after {context}:\n  {detail}")


def verify_enabled() -> bool:
    """Whether the per-rewrite IR check is on (default: yes)."""
    return os.environ.get(VERIFY_ENV, "1") != "0"


def check_ir(ir: LoweringIR) -> List[str]:
    """Return every structural-invariant violation in ``ir`` (empty = ok)."""
    v: List[str] = []
    if ir.root not in ir.nodes:
        return [f"root uid %{ir.root} is not in the node table"]
    pos = {n.uid: i for i, n in enumerate(ir.order)}
    if ir.root not in pos:
        v.append(f"root %{ir.root} is missing from the schedule")
    for n in ir.order:
        tag = f"%{n.uid}={n.op}"
        # -- use-def consistency
        missing = [u for u in n.inputs if u not in ir.nodes]
        for u in missing:
            v.append(f"{tag}: input %{u} is not in the node table")
        if not missing:
            expect = tuple(ir.nodes[u].ty for u in n.inputs)
            if n.input_tys != expect:
                v.append(f"{tag}: stale input_tys {n.input_tys!r} "
                         f"(producers now have {expect!r})")
        # -- schedule order / acyclicity
        for u in ir.effective_inputs(n):
            if u not in pos:
                v.append(f"{tag}: effective input %{u} is not scheduled")
            elif pos[u] >= pos[n.uid]:
                v.append(f"{tag}: effective input %{u} is scheduled at or "
                         f"after its consumer — the graph has a cycle")
        # -- consumer symmetry
        for cu in n.consumers:
            c = ir.nodes.get(cu)
            if c is None or cu not in pos:
                v.append(f"{tag}: dangling consumer %{cu} (dead or unknown)")
            elif n.uid not in ir.effective_inputs(c):
                v.append(f"{tag}: consumer %{cu}={c.op} does not reference "
                         f"it through its effective inputs")
        # -- dispatch hygiene
        if n.dispatch is not None:
            for leaf in n.dispatch.leaves:
                if leaf not in pos:
                    v.append(f"{tag}: dispatch '{n.dispatch.kernel}' leaf "
                             f"%{leaf} is not live")
        # -- metadata and type preservation
        if n.shape != type_shape(n.ty):
            v.append(f"{tag}: shape {n.shape} does not match type "
                     f"{n.ty!r} ({type_shape(n.ty)})")
        if n.scalar != scalar_of(n.ty):
            v.append(f"{tag}: scalar {n.scalar!r} does not match type "
                     f"{n.ty!r}")
        if n.op in OPS and n.op not in _NO_REINFER and not missing:
            try:
                ty = OPS[n.op].infer(n.params, *n.input_tys)
            except Exception as ex:            # noqa: BLE001 - diagnostic
                v.append(f"{tag}: type inference failed over current "
                         f"inputs: {ex}")
            else:
                if ty is not None and ty != n.ty:
                    v.append(f"{tag}: type not preserved — recorded "
                             f"{n.ty!r}, inferred {ty!r}")
    return v


def assert_ir(ir: LoweringIR, context: str = "rewrite") -> None:
    """``check_ir`` that raises ``InvariantViolation`` (named diagnostics
    for the rewrite driver's per-mutation hook)."""
    violations = check_ir(ir)
    if violations:
        raise InvariantViolation(context, violations)


def check_rewrites(out_val, backend: str = "torch",
                   rules: Optional[list] = None) -> List[str]:
    """Build a fresh LoweringIR for ``out_val`` and run the full rewrite
    fixpoint under the invariant checker; returns the violations (empty =
    the entire rewrite run is structurally clean).  This is the CLI /
    ``HWDesign.verify()`` entry point — it exercises every resident rule
    the backend enables, independent of any cached lowering."""
    from ..core.lowering.patterns import RULES
    from ..core.lowering.rewrite import apply_rules
    ir = LoweringIR(out_val)
    pre = check_ir(ir)
    if pre:
        return [f"(pre-rewrite) {p}" for p in pre]
    old = os.environ.get(VERIFY_ENV)
    os.environ[VERIFY_ENV] = "1"
    try:
        apply_rules(ir, rules if rules is not None else RULES, backend)
    except InvariantViolation as ex:
        return [f"({ex.context}) {p}" for p in ex.violations]
    finally:
        if old is None:
            os.environ.pop(VERIFY_ENV, None)
        else:
            os.environ[VERIFY_ENV] = old
    return check_ir(ir)
