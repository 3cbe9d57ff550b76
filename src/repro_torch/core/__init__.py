"""repro_torch.core — the HWImg language and its PyTorch/CUDA compiler.

Public surface:
  dtypes   — HWImg type system (fig. 2), a copy of repro.core.dtypes
  hwimg    — the embedded image-processing language (§3), a copy
  lowering — automatic HWImg -> torch/CUDA lowering (software §5.2 analog)
  compile  — ``compile_pipeline`` and ``CompileOptions``
"""
from .compile import CompileOptions, HWDesign, compile_pipeline  # noqa: F401
from .dtypes import (Array2d, ArrayT, Bits, Bool, Float, Int, SparseT,  # noqa
                     TupleT, UInt)
from .hwimg import (Abs, AbsDiff, Add, AddAsync, AddMSBs, And, ArgMin,  # noqa
                    Concat, Const, Crop, Downsample, External, FanIn, FanOut,
                    Filter, FloatAdd, FloatDiv, FloatMul, FloatSqrt, FloatSub,
                    Gt, Input, Map, Max, Min, Mul, Pad, PointFn, Reduce,
                    ReducePatch, RemoveMSBs, Replicate, Rshift, SparseTake,
                    Stack, Stencil, Sub, ToFloat, UserFunction, Upsample, Val)
