"""Wrapper of the generated megakernels (K3).

``megakernel_segment(mk, *invals)`` runs one emitted segment (a
``core.lowering.megakernel.Megakernel``) on the values of its ``in_uids``
and returns the values of its ``out_uids``.  On CUDA tensors it builds the
segment's generated source (``kernels/_build.py``, cached by its hash) and
launches it once for all frames, or raises; on CPU tensors it takes the
plain version in ref.py; any other device raises.  Launches count under
``"megakernel"``, one per segment call.
"""
from __future__ import annotations

import ctypes
from typing import Any, List, Tuple

import torch

from .. import _build, _checks
from .ref import megakernel_ref

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_void_p)


def _flatten(mk, invals) -> List[torch.Tensor]:
    leaves = []
    for u, v in zip(mk.in_uids, invals):
        leaves.extend(v if isinstance(v, tuple) else (v,))
    if len(leaves) != len(mk.in_leaves):
        raise ValueError(f"{mk.name}: {len(leaves)} input leaves, want "
                         f"{len(mk.in_leaves)}")
    return leaves


def megakernel_segment(mk, *invals) -> Tuple[Any, ...]:
    leaves = [t.contiguous() for t in _flatten(mk, invals)]
    if _checks.route("megakernel", *leaves) == "cpu":
        return megakernel_ref(mk, *invals)
    frames = max(t.shape[0] for t in leaves)
    for t, lf in zip(leaves, mk.in_leaves):
        if t.dtype != lf.dtype or tuple(t.shape[1:]) != lf.shape \
                or t.shape[0] not in (1, frames):
            raise ValueError(
                f"{mk.name}: input %{lf.uid} is {tuple(t.shape)} {t.dtype}, "
                f"want (frames,) + {lf.shape} {lf.dtype}")
    if frames > _checks.MAX_FRAMES:
        raise ValueError(f"{mk.name}: at most {_checks.MAX_FRAMES} frames "
                         f"per launch, got {frames}")
    dev = leaves[0].device
    outs = [torch.empty((frames,) + lf.shape, dtype=lf.dtype, device=dev)
            for lf in mk.out_leaves]
    if frames == 0:
        return mk.group_outputs(outs)
    fn = _build.generated_function(mk.name, mk.source, "mk_launch",
                                   _ARGTYPES)
    ins = (ctypes.c_void_p * len(leaves))(*[t.data_ptr() for t in leaves])
    strides = (ctypes.c_longlong * len(leaves))(
        *[t[0].numel() if t.shape[0] == frames and frames > 1 else 0
          for t in leaves])
    out_ptrs = (ctypes.c_void_p * len(outs))(*[t.data_ptr() for t in outs])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("megakernel", fn, ins, strides, out_ptrs, frames,
                      stream)
    return mk.group_outputs(outs)
