"""The lowering compiler: automatic HWImg -> PyTorch/CUDA mapping as a
multi-pass pipeline (the torch counterpart of ``repro.core.lowering``):

  ir.py        pass 1 — explicit lowering IR (node table + use-def edges)
  rewrite.py   pass 2 — declarative pattern-rewrite engine (fixpoint)
  patterns.py  the resident rule library (conv2d, sad, separable_conv,
               window_sum, pyramid collapses); ``register_rule`` adds one
  lowerers.py  generic per-operator torch lowerings + wrap masking
  megakernel.py  one generated CUDA kernel per fused segment (K3)
  engine.py    pass 3 — partition into segments, then execution

A fusion fires only when provably bit-exact against the numpy executor;
everything else takes the generic lowering, bit-exact by construction.

Backends:
    "torch"    generic lowering (the analog of the reference's "jax")
    "kernels"  the above + dispatch of matched subgraphs to the
               hand-written CUDA kernels and megakernel emission (the
               analog of "pallas")
"""
from .engine import BACKENDS, CompiledPipeline, resolve_device  # noqa: F401
from .ir import Dispatch, IRNode, LoweringIR  # noqa: F401
from .lowerers import LOWERERS, torch_mask, torch_point_fn  # noqa: F401
from .megakernel import (FLOAT_ULP_BOUND, Megakernel,  # noqa: F401
                         MKUnsupported, emit_megakernel)
from .patterns import MK_SUBSUMED_RULES, RULES, register_rule  # noqa: F401
from .rewrite import (Chain, Either, Leaf, Many, Match, Opt,  # noqa: F401
                      OpPat, Replace, Rewire, RewriteRule, apply_rules)
