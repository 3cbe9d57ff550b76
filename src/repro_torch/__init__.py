"""repro_torch — the PyTorch/CUDA port of the HWTool reproduction.

It mirrors ``repro``'s layout so each module has an obvious counterpart,
runs on an NVIDIA Hopper card by default, and imports neither ``jax`` nor
anything of ``repro`` (it keeps its own copy of what it needs):

  core/dtypes, core/hwimg   the HWImg type system and language (copies)
  core/executor             the bit-accurate numpy executor (a copy)
  core/{mapper,rigel,schedule,buffers}
                            the hardware half: interface and rate solve,
                            local mapping, FIFO allocation (copies)
  hwsim/, analysis/traces   the cycle simulator (the scalar engine, the
                            packed-state engine on the cycle kernel,
                            design populations), the allocator, the area
                            model, the ingest model and the trace algebra
  explore/                  the design-space explorer (Pareto sweeps)
  core/lowering/            IR -> rewrite rules -> segments: generated
                            megakernels (CUDA C++ per fused segment) and
                            eager torch segments
  core/compile              ``compile_pipeline`` -> design with the module
                            netlist, FIFOs, ``report``, ``simulate``,
                            ``optimize_fifos``, ``explore`` and
                            run/run_batch
  kernels/                  hand-written CUDA kernels (csrc/*.cu) and the
                            megakernels' build and launch, behind wrappers
                            that count their launches
  apps/                     CONVOLUTION, STEREO, FLOW, DESCRIPTOR, PYRAMID

Backends: ``"numpy"`` (the executor, on the host), ``"torch"`` (the
generic plain lowering) and ``"kernels"`` (the same plus dispatch of
matched subgraphs to the CUDA kernels, and one generated CUDA kernel per
fused segment).  The lowering backends run on ``device="cuda"`` unless the
caller passes ``device="cpu"``; with no card and no explicit CPU device
they raise.
"""
from .core import (CompileOptions, ExploreOptions, HWDesign,  # noqa: F401
                   SimOptions, compile_pipeline)
