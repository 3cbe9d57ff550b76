"""Pass 3 of the lowering compiler: the torch execution engine.

The torch counterpart of ``repro/core/lowering/engine.py``.  The scheduled,
rewritten IR is partitioned into segments, each of which becomes either

* a **megakernel** (kernels backend): one generated CUDA kernel that walks
  the frame tile by tile with every intermediate in shared memory
  (megakernel.py), launched through the ``megakernel`` registry entry; or
* a **generic segment**: the segment's nodes run eagerly one by one — a
  node carrying a ``Dispatch`` (a rule matched its subgraph) calls the
  dispatch, which on the kernels backend may launch a hand-written CUDA
  kernel; every other node goes through the LOWERERS table, and every
  result is wrapped to its declared width (``torch_mask``).

The planning is the reference's: ``_clustered_body`` groups streamable
nodes into maximal runs, ``_partition`` carves each run that is worth a
kernel into a megakernel segment (keeping the generic path, with a note,
where the emitter raises ``MKUnsupported``), and the notes and
``megakernel_stats()`` carry the reference's wording and keys, so plans
compare node for node.

No FMA split.  The reference closes a generic segment wherever an f32
multiply feeds an add in the same XLA program (``_fma_groups``), because
XLA fuses and contracts them.  Eager PyTorch rounds op by op, so a generic
torch segment is IEEE op-at-a-time already, and a megakernel decides float
rounding inside itself (every f32 operation rounded once).

Frame axis.  Every image value carries an explicit leading frame axis and
``Const`` values a size-1 one that broadcasts, so ``__call__`` (one frame)
is ``run_batch`` with one frame, and a batch of N frames is one launch per
kernel, not N.  The reference tracks batchedness per task and vmaps.

Device.  A compiled pipeline lives on one ``torch.device``: its Const
values (and the kernels' coefficient banks) move there once, inputs are
moved there per call, and on a CUDA device the segments' generated kernels
are built when the pipeline is lowered.  ``run_batch_device`` keeps
results there.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..compile import LOWERING_BACKENDS as BACKENDS
from ..hwimg import Val
from .ir import IRNode, LoweringIR
from .lowerers import LOWERERS, torch_mask
from .megakernel import (Megakernel, MKUnsupported, emit_megakernel,
                         streamable, worth_emitting)
from .patterns import MK_SUBSUMED_RULES, RULES
from .rewrite import apply_rules

def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless the caller
    names another.  Raises rather than carrying on quietly on the CPU when
    there is no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (want cuda or cpu)")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain versions on the CPU")
    return dev


def _spec(v) -> Any:
    if isinstance(v, tuple):
        return tuple(_spec(e) for e in v)
    if isinstance(v, torch.Tensor):
        return (tuple(v.shape), str(v.dtype))
    a = np.asarray(v)
    return (a.shape, str(a.dtype))


def _const_tensor(value, device: torch.device) -> torch.Tensor:
    a = np.asarray(value)
    if a.dtype.kind in "iu":
        a = a.astype(np.int64)              # the integer carrier
    return torch.as_tensor(a).to(device)[None]      # size-1 frame axis


def _as_input(raw, device: torch.device, frame_axis: bool) -> torch.Tensor:
    t = torch.as_tensor(raw) if not isinstance(raw, torch.Tensor) else raw
    if not (t.is_floating_point() or t.dtype == torch.bool):
        t = t.to(torch.int64)               # the integer carrier
    t = t.to(device)
    return t[None] if frame_axis else t


def _broadcast_frames(r, n: int):
    if isinstance(r, tuple):
        return tuple(_broadcast_frames(x, n) for x in r)
    if r.shape[0] != n:
        r = r.expand((n,) + tuple(r.shape[1:]))
    return r


def _first_frame(r):
    if isinstance(r, tuple):
        return tuple(_first_frame(x) for x in r)
    return r[0]


def _to_numpy(r):
    if isinstance(r, tuple):
        return tuple(_to_numpy(x) for x in r)
    return r.cpu().numpy()


def _unlowered(n: IRNode) -> bool:
    return (n.dispatch is None and n.op not in ("Input", "Const")
            and n.op not in LOWERERS)


class _Task:
    """One schedulable unit: a generic segment (its nodes run eagerly, in
    order) or, via _MKTask, a megakernel segment."""

    def __init__(self, nodes: List[IRNode], in_uids: Tuple[int, ...],
                 out_uids: Tuple[int, ...]):
        self.nodes = nodes
        self.in_uids = in_uids
        self.out_uids = out_uids

    def call(self, engine: "CompiledPipeline", invals) -> Tuple[Any, ...]:
        env = dict(zip(self.in_uids, invals))
        for n in self.nodes:
            env[n.uid] = engine._eval_node(n, env)
        return tuple(env[u] for u in self.out_uids)


class _MKTask(_Task):
    """A megakernel segment: the whole span is one generated CUDA kernel
    (its plain version on the CPU)."""

    def __init__(self, nodes: List[IRNode], in_uids: Tuple[int, ...],
                 out_uids: Tuple[int, ...], mk: Megakernel):
        super().__init__(nodes, in_uids, out_uids)
        self.mk = mk

    def call(self, engine: "CompiledPipeline", invals) -> Tuple[Any, ...]:
        from ...kernels.registry import get_kernel
        return get_kernel("megakernel").site_fn(self.mk, *invals)


class CompiledPipeline:
    """Executable lowering of an HWImg DAG on one device, bit-exact against
    the numpy executor on integer pipelines and generic segments, within
    ``megakernel.FLOAT_ULP_BOUND`` on megakernel float segments.

    Pipeline: build the IR (ir.py), rewrite it to fixpoint against the
    resident rule library (rewrite.py / patterns.py; the kernels backend
    enables the CUDA-kernel dispatch rules, and megakernel emission skips
    the rules its streaming subsumes), partition the schedule, and emit
    one kernel per megakernel segment.  ``notes`` is the lowering report;
    ``fusions`` maps pattern-root uid -> Dispatch; ``megakernels`` lists
    the emitted segment kernels."""

    def __init__(self, out: Val, backend: str = "torch", device=None,
                 megakernel: str = "auto"):
        if backend not in BACKENDS:
            raise ValueError(f"unknown lowering backend {backend!r} "
                             f"(want one of {BACKENDS})")
        if megakernel not in ("auto", "off"):
            raise ValueError(f"unknown megakernel mode {megakernel!r}")
        self.backend = backend
        self.device = resolve_device(device)
        # megakernels are a kernels-backend feature: the torch backend is
        # the plain generic lowering
        self.megakernel_on = backend == "kernels" and megakernel == "auto"
        self.megakernels: List[Megakernel] = []
        self.ir = LoweringIR(out)
        rules = [r for r in RULES
                 if not (self.megakernel_on and r.name in MK_SUBSUMED_RULES)]
        self.fusions, self.notes, self.graph_rewrites = apply_rules(
            self.ir, rules, backend)
        missing = sorted({n.op for n in self.ir.order if _unlowered(n)})
        if missing:
            raise NotImplementedError(
                f"no torch lowering for {', '.join(missing)} yet")
        self._inputs = [n for n in self.ir.order if n.op == "Input"]
        self._body = [n for n in self.ir.order if n.op != "Input"]
        self._consts = {n.uid: torch_mask(_const_tensor(n.params["value"],
                                                        self.device), n.ty)
                        for n in self._body if n.op == "Const"}
        self._plan = self._partition()
        self.notes.append(
            f"lowering backend={backend}: {len(self.fusions)} fused "
            f"dispatch(es), {self.graph_rewrites} graph rewrite(s); "
            f"eager engine on {self.device}: {len(self._plan)} program "
            f"segment(s) over {sum(len(t.nodes) for t in self._plan)} nodes"
            + (f", {len(self.megakernels)} megakernel(s)"
               if self.megakernels else ""))
        for mk in self.megakernels:
            self.notes.append("  " + mk.report_line())
        if self.device.type == "cuda" and self.megakernels:
            from ...kernels import _build
            _build.build_generated({mk.name: mk.source
                                    for mk in self.megakernels})
        # per-signature call counts, keyed by (mode, frame signature)
        self.signatures: Dict[Tuple[str, Any], int] = {}

    # ---- planning ----
    def _segment_io(self, nodes: List[IRNode]
                    ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        produced = {n.uid for n in nodes}
        in_uids: List[int] = []
        for n in nodes:
            for u in self.ir.effective_inputs(n):
                if u not in produced and u not in in_uids:
                    in_uids.append(u)
        out_uids = tuple(
            n.uid for n in nodes
            if n.uid == self.ir.root
            or any(c not in produced for c in n.consumers))
        return tuple(in_uids), out_uids

    def _clustered_body(self) -> List[IRNode]:
        """Topological order over non-Input nodes that groups streamable
        nodes into maximal contiguous runs (Kahn's algorithm preferring to
        stay in the current class; FIFO within a class preserves the
        schedule's relative order)."""
        body = self._body
        in_body = {n.uid for n in body}
        deps = {n.uid: {u for u in self.ir.effective_inputs(n)
                        if u in in_body} for n in body}
        ndep = {u: len(vs) for u, vs in deps.items()}
        cons: Dict[int, List[int]] = {n.uid: [] for n in body}
        for n in body:
            for u in deps[n.uid]:
                cons[u].append(n.uid)
        ready: Dict[bool, deque] = {True: deque(), False: deque()}
        for n in body:                  # ir.order: deterministic seeding
            if ndep[n.uid] == 0:
                ready[streamable(n)].append(n)
        out: List[IRNode] = []
        cur = True
        while ready[True] or ready[False]:
            if not ready[cur]:
                cur = not cur
            n = ready[cur].popleft()
            out.append(n)
            for cuid in cons[n.uid]:
                ndep[cuid] -= 1
                if ndep[cuid] == 0:
                    cn = self.ir.nodes[cuid]
                    ready[streamable(cn)].append(cn)
        return out

    def _partition(self) -> List[_Task]:
        """Segment the schedule.  Megakernel mode carves maximal streamable
        spans and emits one fused CUDA kernel per span (falling back to the
        generic path per span on MKUnsupported); everything else — the
        whole schedule on ``backend="torch"`` — becomes maximal generic
        segments."""
        if not self.megakernel_on:
            groups: List[Tuple[bool, List[IRNode]]] = [(False, self._body)]
        else:
            spans: List[Tuple[bool, List[IRNode]]] = []
            for n in self._clustered_body():
                cls = streamable(n)
                if spans and spans[-1][0] == cls:
                    spans[-1][1].append(n)
                else:
                    spans.append((cls, [n]))
            groups = []
            pending: List[IRNode] = []  # spans that stay generic
            for is_stream, nodes in spans:
                if not (is_stream and worth_emitting(nodes)):
                    pending.extend(nodes)
                    continue
                if pending:
                    groups.append((False, pending))
                    pending = []
                groups.append((True, nodes))
            if pending:
                groups.append((False, pending))

        tasks: List[_Task] = []
        for want_mk, nodes in groups:
            if not nodes:
                continue
            in_uids, out_uids = self._segment_io(nodes)
            if want_mk:
                try:
                    mk = emit_megakernel(
                        self.ir, nodes, in_uids, out_uids,
                        name=f"mk{len(self.megakernels)}")
                except MKUnsupported as exc:
                    self.notes.append(f"megakernel fallback ({exc}); "
                                      f"generic segment(s) instead")
                    tasks.append(_Task(nodes, in_uids, out_uids))
                    continue
                self.megakernels.append(mk)
                tasks.append(_MKTask(nodes, in_uids, out_uids, mk))
            else:
                tasks.append(_Task(nodes, in_uids, out_uids))
        return tasks

    # ---- execution ----
    def _eval_node(self, n: IRNode, env: Dict[int, Any]) -> Any:
        if n.op == "Const":
            return self._consts[n.uid]
        if n.dispatch is not None:
            r = n.dispatch.apply(*[env[u] for u in n.dispatch.leaves])
        else:
            r = LOWERERS[n.op](n, n.params, [env[u] for u in n.inputs])
        return torch_mask(r, n.ty)

    def _load_inputs(self, inputs: Dict[str, Any], frame_axis: bool
                     ) -> Dict[int, Any]:
        env: Dict[int, Any] = {}
        for n in self._inputs:
            raw = inputs[n.params["name"]]
            if isinstance(raw, tuple):
                env[n.uid] = tuple(_as_input(e, self.device, frame_axis)
                                   for e in raw)
            else:
                env[n.uid] = _as_input(raw, self.device, frame_axis)
        return env

    def _run(self, inputs: Dict[str, Any], mode: str):
        self._record(inputs, mode)
        with torch.no_grad():
            env = self._load_inputs(inputs, frame_axis=mode == "frame")
            for t in self._plan:
                outs = t.call(self, [env[u] for u in t.in_uids])
                env.update(zip(t.out_uids, outs))
        first = env[self._inputs[0].uid] if self._inputs else None
        while isinstance(first, tuple):
            first = first[0]
        frames = 1 if first is None else first.shape[0]
        return _broadcast_frames(env[self.ir.root], frames)

    def _record(self, inputs, mode: str) -> None:
        sig = (mode, self.frame_signature(inputs))
        self.signatures[sig] = self.signatures.get(sig, 0) + 1

    def __call__(self, inputs: Dict[str, Any]):
        """One frame: inputs without a frame axis; numpy results."""
        return _to_numpy(_first_frame(self._run(inputs, "frame")))

    def run_batch(self, inputs: Dict[str, Any]):
        """A batch: every input carries a leading frame axis; numpy
        results with the same leading axis.  Each kernel launches once for
        the whole batch."""
        return _to_numpy(self._run(inputs, "batch"))

    def run_batch_device(self, inputs: Dict[str, Any]):
        """The serving call path: batched execution whose results stay on
        the device as tensors (launches are asynchronous; a caller
        synchronises when it needs them)."""
        return self._run(inputs, "serve")

    def segment_inputs(self, mk: Megakernel, inputs: Dict[str, Any]
                       ) -> List[Any]:
        """The values megakernel segment ``mk`` receives for a batch of
        ``inputs`` (the plan run up to it), with their frame axis: the hook
        that holds one segment's kernel against its plain version."""
        with torch.no_grad():
            env = self._load_inputs(inputs, frame_axis=False)
            for t in self._plan:
                if getattr(t, "mk", None) is mk:
                    return [env[u] for u in t.in_uids]
                outs = t.call(self, [env[u] for u in t.in_uids])
                env.update(zip(t.out_uids, outs))
        raise ValueError(f"{mk.name} is not a segment of this pipeline")

    @staticmethod
    def frame_signature(inputs: Dict[str, Any]) -> Tuple:
        """Hashable (shape, dtype) signature of an input dict."""
        return tuple(sorted((k, _spec(v)) for k, v in inputs.items()))

    def node_values(self, inputs: Dict[str, Any]) -> Dict[int, Any]:
        """Eager per-node evaluation of one frame returning every live
        node's value keyed by uid, as numpy without the frame axis — the
        node-level diffing hook against the executor (every node through
        its dispatch or the generic LOWERERS, megakernel segments too)."""
        with torch.no_grad():
            env = self._load_inputs(inputs, frame_axis=True)
            for n in self._body:
                env[n.uid] = self._eval_node(n, env)
        return {u: _to_numpy(_first_frame(v)) for u, v in env.items()}

    # ---- reporting ----
    def megakernel_stats(self) -> Dict[str, Any]:
        """Per-pipeline megakernel roll-up (the reference's keys): segment
        counts, fused-node total, line-buffer bytes, and a per-segment
        roofline table (scalar ops vs kernel-boundary bytes)."""
        return {
            "segments": len(self.megakernels),
            "total_segments": len(self._plan),
            "fused_nodes": sum(m.n_nodes for m in self.megakernels),
            "linebuf_bytes": sum(m.linebuf_bytes
                                 for m in self.megakernels),
            "float_nodes": sum(m.float_nodes for m in self.megakernels),
            "rooflines": [
                {"segment": m.name, "flops": m.flops,
                 "io_bytes": m.io_bytes,
                 "arithmetic_intensity":
                     round(m.arithmetic_intensity, 4)}
                for m in self.megakernels],
        }

    def call_stats(self) -> List[str]:
        """Per-signature call counts (mode, shapes, calls)."""
        lines = []
        for (mode, spec), calls in sorted(self.signatures.items(),
                                          key=lambda kv: repr(kv[0])):
            shapes = ", ".join(f"{name}={s}" for name, s in spec)
            lines.append(f"calls[{mode}] {shapes}: calls={calls}")
        return lines

    def report_lines(self) -> List[str]:
        return list(self.notes) + self.call_stats()
