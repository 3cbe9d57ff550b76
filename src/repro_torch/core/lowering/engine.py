"""Pass 3 of the lowering compiler: the eager torch execution engine.

The torch counterpart of ``repro/core/lowering/engine.py``.  The rewritten
IR runs node by node on one device: a node carrying a ``Dispatch`` (a rule
matched its subgraph) calls the dispatch, which on the ``"kernels"``
backend launches a hand-written CUDA kernel; every other node goes through
the generic LOWERERS table, and every result is wrapped to its declared
width (``torch_mask``).  The schedule is one program segment: this slice
emits no megakernels, which is the only thing that splits segments in the
reference besides the FMA split below.

Frame axis.  Every image value carries an explicit leading frame axis and
``Const`` values a size-1 one that broadcasts, so ``__call__`` (one frame)
is ``run_batch`` with one frame, and a batch of N frames is one launch per
kernel, not N.  The reference tracks batchedness per task and vmaps.

No FMA split.  The reference closes a segment wherever an f32 multiply
feeds an add in the same program (``_fma_groups``,
``backend_contracts_fma``), because XLA fuses and contracts them.  Eager
PyTorch rounds op by op, so a generic torch segment is IEEE op-at-a-time
already, and this slice has no float chain; the megakernel slice decides
float exactness inside its own kernels.

Device.  A compiled pipeline lives on one ``torch.device``: its Const
values (and the kernels' coefficient banks) move there once, inputs are
moved there per call.  ``run_batch_device`` keeps results there.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..hwimg import Val
from .ir import IRNode, LoweringIR
from .lowerers import LOWERERS, torch_mask
from .patterns import RULES
from .rewrite import apply_rules

BACKENDS = ("torch", "kernels")


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


class CompiledPipeline:
    """Executable lowering of an HWImg DAG on one device, bit-exact against
    the numpy executor on integer pipelines.

    Pipeline: build the IR (ir.py), rewrite it to fixpoint against the
    resident rule library (rewrite.py / patterns.py; the kernels backend
    enables the CUDA-kernel dispatch rules), then run the schedule as one
    eager segment.  ``notes`` is the lowering report; ``fusions`` maps
    pattern-root uid -> Dispatch."""

    def __init__(self, out: Val, backend: str = "torch", device=None):
        if backend not in BACKENDS:
            raise ValueError(f"unknown lowering backend {backend!r} "
                             f"(want one of {BACKENDS})")
        self.backend = backend
        self.device = resolve_device(device)
        self.ir = LoweringIR(out)
        self.fusions, self.notes, self.graph_rewrites = apply_rules(
            self.ir, RULES, backend)
        missing = sorted({n.op for n in self.ir.order if _unlowered(n)})
        if missing:
            raise NotImplementedError(
                f"no torch lowering for {', '.join(missing)} yet")
        self._inputs = [n for n in self.ir.order if n.op == "Input"]
        self._body = [n for n in self.ir.order if n.op != "Input"]
        self._consts = {n.uid: torch_mask(_const_tensor(n.params["value"],
                                                        self.device), n.ty)
                        for n in self._body if n.op == "Const"}
        self.notes.append(
            f"lowering backend={backend}: {len(self.fusions)} fused "
            f"dispatch(es), {self.graph_rewrites} graph rewrite(s); "
            f"eager engine on {self.device}: 1 program segment(s) over "
            f"{len(self._body)} nodes")
        # per-signature call counts, keyed by (mode, frame signature)
        self.signatures: Dict[Tuple[str, Any], int] = {}

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

    def _env(self, inputs: Dict[str, Any], frame_axis: bool
             ) -> Dict[int, Any]:
        env = self._load_inputs(inputs, frame_axis)
        for n in self._body:
            env[n.uid] = self._eval_node(n, env)
        return env

    def _run(self, inputs: Dict[str, Any], mode: str):
        self._record(inputs, mode)
        frame_axis = mode == "frame"
        with torch.no_grad():
            env = self._env(inputs, frame_axis)
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

    @staticmethod
    def frame_signature(inputs: Dict[str, Any]) -> Tuple:
        """Hashable (shape, dtype) signature of an input dict."""
        return tuple(sorted((k, _spec(v)) for k, v in inputs.items()))

    def node_values(self, inputs: Dict[str, Any]) -> Dict[int, Any]:
        """Per-node evaluation of one frame returning every live node's
        value keyed by uid, as numpy without the frame axis — the
        node-level diffing hook against the executor.  (The engine is
        eager, so this is the normal path with every value kept.)"""
        with torch.no_grad():
            env = self._env(inputs, frame_axis=True)
        return {u: _to_numpy(_first_frame(v)) for u, v in env.items()}

    # ---- reporting ----
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

