"""Pass 2 of the lowering compiler: a generic pattern-rewrite engine.

Fusion patterns are *declarative data*, not hand-rolled graph walkers: a
``RewriteRule`` carries an op-chain spec (``OpPat`` trees with ``Leaf``
capture slots, ``Chain``/``Many``/``Opt``/``Either`` combinators for the
optional width-adjustment links real pipelines contain) plus guard
predicates.  Rules are applied to fixpoint in priority order; a match
produces either

  * a ``Dispatch`` — the region collapses into one fused callable
    (a resident CUDA kernel or a fused torch implementation), or
  * a ``Replace``/``Rewire`` — an algebraic graph-to-graph rewrite
    (e.g. pyramid Down/Downsample chain collapse).

Matching discipline (the software meets-or-exceeds rule, paper §5.2):
every matched interior node must have exactly one consumer — fusing a
multi-consumer interior would duplicate or orphan work — except ``Const``
coefficient banks, whose values are baked into the dispatch and which stay
alive for any other consumer.  The concrete rules live in patterns.py.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

from .ir import Dispatch, IRNode, LoweringIR

# --------------------------------------------------------------------------
# declarative pattern vocabulary


@dataclass(frozen=True)
class Leaf:
    """Capture slot: matches any producer; the bound node becomes one of the
    fused region's graph inputs."""

    bind: str


@dataclass(frozen=True)
class OpPat:
    """Match one IR node by op name (and PointFn name for Map/Reduce ops).

    ``ins`` constrains the node's operands (None = don't descend); each slot
    is an OpPat, Leaf, Chain or Either.  ``where`` is a node-local guard
    predicate; cross-capture guards belong on the rule.  ``commutative``
    also tries the two-operand slots in swapped order."""

    op: Union[str, Tuple[str, ...]]
    fn: Union[str, Tuple[str, ...], None] = None
    ins: Optional[Tuple[Any, ...]] = None
    bind: Optional[str] = None
    where: Optional[Callable[[IRNode], bool]] = None
    commutative: bool = False


@dataclass(frozen=True)
class Many:
    """Zero or more single-consumer unary links matching ``pat`` (e.g. the
    ``Map(AddMSBs)`` width-adjustment chains)."""

    pat: OpPat


@dataclass(frozen=True)
class Opt:
    """Zero or one single-consumer unary link matching ``pat``."""

    pat: OpPat


@dataclass(frozen=True)
class Chain:
    """A unary spine: intermediate links (Many/Opt/OpPat) descend through
    ``inputs[0]``; the final element (OpPat/Leaf/Either) anchors the end."""

    links: Tuple[Any, ...]

    def __init__(self, *links):
        object.__setattr__(self, "links", tuple(links))


@dataclass(frozen=True)
class Either:
    """First matching alternative wins."""

    alts: Tuple[Any, ...]

    def __init__(self, *alts):
        object.__setattr__(self, "alts", tuple(alts))


@dataclass
class Match:
    """A successful pattern match: the anchor node plus captured bindings."""

    ir: LoweringIR
    anchor: IRNode
    env: Dict[str, IRNode] = field(default_factory=dict)

    def __getitem__(self, name: str) -> IRNode:
        return self.env[name]

    def get(self, name: str) -> Optional[IRNode]:
        return self.env.get(name)


# --------------------------------------------------------------------------
# rewrite results (what a rule's build() returns) — Dispatch lives in ir.py


@dataclass(frozen=True)
class Replace:
    """Replace the anchor in place with a new op (same uid and type)."""

    op: str
    params: Dict[str, Any]
    inputs: Tuple[int, ...]
    note: str


@dataclass(frozen=True)
class Rewire:
    """Replace every use of the anchor with an existing node (identity)."""

    target: int
    note: str


@dataclass(frozen=True)
class RewriteRule:
    """name + declarative pattern + guard predicate + builder.

    ``guard(m)`` checks cross-capture exactness conditions (wrap bounds,
    shape agreement, factorizability); ``build(m)`` returns the rewrite
    (Dispatch / Replace / Rewire) or None to decline late.  ``backends``
    restricts the rule (CUDA-kernel dispatches are kernels-only; torch-level
    fusions and algebraic rewrites apply everywhere)."""

    name: str
    pattern: OpPat
    build: Callable[[Match], Union[Dispatch, Replace, Rewire, None]]
    guard: Optional[Callable[[Match], bool]] = None
    backends: Tuple[str, ...] = ("torch", "kernels")


# --------------------------------------------------------------------------
# matcher

def _names(x) -> Tuple[str, ...]:
    return (x,) if isinstance(x, str) else tuple(x)


def _node_matches(pat: OpPat, n: IRNode) -> bool:
    if n.op not in _names(pat.op):
        return False
    if pat.fn is not None:
        fn = n.params.get("fn")
        if fn is None or fn.name not in _names(pat.fn):
            return False
    if pat.where is not None and not pat.where(n):
        return False
    return True


def _match_op(pat: OpPat, n: IRNode, ir: LoweringIR, env: Dict[str, IRNode],
              is_anchor: bool) -> bool:
    if not _node_matches(pat, n):
        return False
    # interior single-consumer discipline (Const banks exempt: baked values)
    if not is_anchor and n.op != "Const" and n.ncons != 1:
        return False
    if n.dispatch is not None:
        return False
    if pat.bind is not None:
        env[pat.bind] = n
    if pat.ins is None:
        return True
    if len(n.inputs) != len(pat.ins):
        return False
    orders = [pat.ins]
    if pat.commutative and len(pat.ins) == 2:
        orders.append((pat.ins[1], pat.ins[0]))
    for slots in orders:
        trial = dict(env)
        if all(_match_slot(s, ir.node(u), ir, trial)
               for s, u in zip(slots, n.inputs)):
            env.clear()
            env.update(trial)
            return True
    return False


def _match_slot(slot, n: IRNode, ir: LoweringIR,
                env: Dict[str, IRNode]) -> bool:
    if isinstance(slot, Leaf):
        env[slot.bind] = n
        return True
    if isinstance(slot, OpPat):
        return _match_op(slot, n, ir, env, is_anchor=False)
    if isinstance(slot, Either):
        for alt in slot.alts:
            trial = dict(env)
            if _match_slot(alt, n, ir, trial):
                env.clear()
                env.update(trial)
                return True
        return False
    if isinstance(slot, Chain):
        cur = n
        for link in slot.links[:-1]:
            if isinstance(link, Many):
                while (cur.ncons == 1 and cur.dispatch is None
                       and len(cur.inputs) == 1
                       and _node_matches(link.pat, cur)):
                    cur = ir.node(cur.inputs[0])
            elif isinstance(link, Opt):
                if (cur.ncons == 1 and cur.dispatch is None
                        and len(cur.inputs) == 1
                        and _node_matches(link.pat, cur)):
                    if link.pat.bind is not None:
                        env[link.pat.bind] = cur
                    cur = ir.node(cur.inputs[0])
            else:                       # mandatory unary OpPat link
                if not (len(cur.inputs) == 1
                        and _match_op(link, cur, ir, env, is_anchor=False)):
                    return False
                cur = ir.node(cur.inputs[0])
        return _match_slot(slot.links[-1], cur, ir, env)
    raise TypeError(f"unknown pattern slot {slot!r}")


def match(rule: RewriteRule, n: IRNode, ir: LoweringIR) -> Optional[Match]:
    env: Dict[str, IRNode] = {}
    if not _match_op(rule.pattern, n, ir, env, is_anchor=True):
        return None
    m = Match(ir, n, env)
    if rule.guard is not None and not rule.guard(m):
        return None
    return m


# --------------------------------------------------------------------------
# driver: apply rules to fixpoint, in priority order

# fixpoint-divergence cap: at least this many rule applications are always
# allowed; large graphs get proportionally more (every sound rule strictly
# shrinks or dispatches the graph, so legitimate runs stay far below it)
MIN_REWRITE_CAP = 128
_RECENT_RULES = 12


def _rewrite_cap(ir: LoweringIR) -> int:
    return max(MIN_REWRITE_CAP, 16 * len(ir.nodes))


def apply_rules(ir: LoweringIR, rules: List[RewriteRule], backend: str
                ) -> Tuple[Dict[int, Dispatch], List[str], int]:
    """Rewrite ``ir`` to fixpoint.  Returns (fusions, notes, n_rewrites):
    ``fusions`` maps pattern-root uid -> Dispatch; ``n_rewrites`` counts the
    algebraic (Replace/Rewire) rewrites.

    Two guards harden the fixpoint loop (repro.analysis):

      * after every mutation the IR's structural invariants are checked
        (analysis/verify_ir.py; disable with REPRO_VERIFY_IR=0) so a buggy
        rule raises ``InvariantViolation`` naming itself, and
      * a divergence cap aborts a ping-ponging rule pair with a RuntimeError
        naming the recently applied rules instead of looping forever.
    """
    # lazy import: repro.analysis imports core, so a module-level import
    # here would be a cycle
    from ...analysis.verify_ir import (InvariantViolation, check_ir,
                                       verify_enabled)
    verify = verify_enabled()
    cap = _rewrite_cap(ir)
    applied = 0
    recent: deque = deque(maxlen=_RECENT_RULES)
    notes: List[str] = []
    n_rewrites = 0
    changed = True
    while changed:
        changed = False
        for rule in rules:
            if backend not in rule.backends:
                continue
            for n in list(ir.order):
                if n.dispatch is not None:
                    continue
                m = match(rule, n, ir)
                if m is None:
                    continue
                r = rule.build(m)
                if r is None:
                    continue
                if isinstance(r, Dispatch):
                    ir.set_dispatch(n.uid, r)
                elif isinstance(r, Replace):
                    ir.replace_op(n.uid, r.op, r.params, r.inputs)
                    n_rewrites += 1
                elif isinstance(r, Rewire):
                    ir.rewire(n.uid, r.target)
                    n_rewrites += 1
                else:
                    raise TypeError(f"rule {rule.name} returned {r!r}")
                applied += 1
                recent.append(rule.name)
                if verify:
                    violations = check_ir(ir)
                    if violations:
                        raise InvariantViolation(
                            f"rule {rule.name!r}", violations)
                if applied > cap:
                    culprits = ", ".join(sorted(set(recent)))
                    raise RuntimeError(
                        f"rewrite fixpoint did not converge after "
                        f"{applied} rule applications (cap {cap} for "
                        f"{len(ir.nodes)} nodes); recently applied rules: "
                        f"[{culprits}] — a rule pair is likely "
                        f"ping-ponging")
                notes.append(r.note)
                changed = True
                break
            if changed:
                break
    # report dispatches from the live graph: later rewires may have
    # retargeted a dispatch's leaves or killed its root
    fusions = {n.uid: n.dispatch for n in ir.order if n.dispatch is not None}
    return fusions, notes, n_rewrites
