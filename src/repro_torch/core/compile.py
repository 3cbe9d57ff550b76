"""Top-level compile driver of the port (the slim ``compile_pipeline``).

The torch counterpart of ``repro/core/compile.py``'s software half:
``compile_pipeline(uf, T, options=CompileOptions(backend=..., device=...))``
builds the pipeline and returns an ``HWDesign`` whose ``lower`` / ``run`` /
``run_batch`` / ``run_batch_device`` go through the lowering compiler
(IR -> rewrite rules -> segments: generated megakernels and eager generic
segments) on one device.

The hardware half of the reference (interface and rate solve, local
mapping, FIFO allocation, ``report()``, ``simulate``, ``serve``) is not
ported yet; ``T`` is recorded for it.

Device rule: every entry point runs on ``device="cuda"`` unless the call
or ``CompileOptions.device`` names another; with no card and no explicit
``device="cpu"`` it raises.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from fractions import Fraction
from typing import Any, Dict, List, Optional, Tuple

from .hwimg import UserFunction, Val
from .lowering.engine import BACKENDS, CompiledPipeline, resolve_device


@dataclass(frozen=True)
class CompileOptions:
    """Typed option bundle for :func:`compile_pipeline`.

    ``backend`` is the default engine for ``HWDesign.run``: "torch" (the
    generic plain lowering) or "kernels" (the same plus dispatch of matched
    subgraphs to the hand-written CUDA kernels).  ``device`` is the default
    device; None means "cuda"."""
    backend: str = "kernels"
    device: Optional[str] = None

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r} "
                             f"(want one of {BACKENDS})")


@dataclass
class HWDesign:
    name: str
    T: Fraction                       # requested input throughput (px/cycle)
    in_val: Val
    out_val: Val
    options: CompileOptions = field(default_factory=CompileOptions)
    _lowered: Dict[Tuple[str, str, str], CompiledPipeline] = field(
        default_factory=dict, repr=False)

    def lower(self, backend: Optional[str] = None, device=None,
              megakernel: str = "auto") -> CompiledPipeline:
        """The lowering-compiler executable for this design, cached per
        (backend, device, megakernel): explicit IR -> rewrite rules ->
        segments (megakernels on the kernels backend unless
        ``megakernel="off"``) -> engine."""
        b = backend or self.options.backend
        dev = resolve_device(device if device is not None
                             else self.options.device)
        key = (b, str(dev), megakernel)
        if key not in self._lowered:
            self._lowered[key] = CompiledPipeline(
                self.out_val, backend=b, device=dev, megakernel=megakernel)
        return self._lowered[key]

    def run(self, inputs: Dict[str, Any], backend: Optional[str] = None,
            device=None):
        """One frame (inputs without a frame axis), bit-exact against the
        numpy executor; numpy results."""
        return self.lower(backend, device)(inputs)

    def run_batch(self, inputs: Dict[str, Any],
                  backend: Optional[str] = None, device=None):
        """A batch: every input carries a leading frame axis; each kernel
        launches once for the whole batch.  Numpy results."""
        return self.lower(backend, device).run_batch(inputs)

    def run_batch_device(self, inputs: Dict[str, Any],
                         backend: Optional[str] = None, device=None):
        """Batched execution whose results stay on the device as tensors."""
        return self.lower(backend, device).run_batch_device(inputs)

    def lowering_report(self) -> str:
        """Fused-dispatch and megakernel notes and per-signature call
        counts for every instantiated (backend, device, megakernel)
        lowering."""
        lines: List[str] = []
        for (b, dev, mk), lp in sorted(self._lowered.items()):
            lines.append(f" -- lowering backend={b} device={dev} "
                         f"megakernel={mk} --")
            lines.extend(f"  {ln}" for ln in lp.report_lines())
        return "\n".join(lines)


def compile_pipeline(uf: UserFunction, T: Fraction = Fraction(1),
                     options: Optional[CompileOptions] = None) -> HWDesign:
    """Build ``uf`` into a design that lowers and runs on the device.
    Nothing is lowered (and no device is touched) until the first
    ``lower``/``run``."""
    inp, out = uf.build()
    return HWDesign(uf.name, Fraction(T), inp, out,
                    options or CompileOptions())
