"""repro_torch.core — the HWImg language and its PyTorch/CUDA compiler.

Public surface:
  dtypes   — HWImg type system (fig. 2), a copy of the reference's
  hwimg    — the embedded image-processing language (§3), a copy
  executor — bit-accurate reference semantics ("Verilator analog", §6),
             a copy
  rigel    — Rigel2 IR: schedule/interface types, module model (§4), a copy
  schedule — trace model F_L(t), burst fitting (§4.2-4.3), a copy
  buffers  — FIFO allocation via register minimization, Z3/LP (§4.2),
             a copy
  mapper   — local meets-or-exceeds mapping + conversions (§5), a copy
  lowering — automatic HWImg -> torch/CUDA lowering (software §5.2 analog)
  compile  — ``compile_pipeline``, ``CompileOptions``, ``SimOptions`` and
             ``ExploreOptions``

Importing this package loads neither the lowering nor torch.
"""
from .compile import (CompileOptions, ExploreOptions, HWDesign,  # noqa: F401
                      SimOptions, compile_pipeline)
from .dtypes import (Array2d, ArrayT, Bits, Bool, Float, Int, SparseT,  # noqa
                     TupleT, UInt)
from .hwimg import (Abs, AbsDiff, Add, AddAsync, AddMSBs, And, ArgMin,  # noqa
                    Concat, Const, Crop, Downsample, External, FanIn, FanOut,
                    Filter, FloatAdd, FloatDiv, FloatMul, FloatSqrt, FloatSub,
                    Gt, Input, Map, Max, Min, Mul, Pad, PointFn, Reduce,
                    ReducePatch, RemoveMSBs, Replicate, Rshift, SparseTake,
                    Stack, Stencil, Sub, ToFloat, UserFunction, Upsample, Val)
