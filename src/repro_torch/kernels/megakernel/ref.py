"""Plain PyTorch version of a megakernel segment (K3).

Contract: ``megakernel_ref(mk, *invals)`` evaluates the segment's nodes
whole-frame, in schedule order, through the port's LOWERERS, each result
wrapped by ``torch_mask`` — exactly what the ``torch`` backend does for
those nodes one by one.  ``invals`` are the values of ``mk.in_uids`` (a
tuple for a tuple-typed value), each with the engine's leading frame axis;
the result is the tuple of the values of ``mk.out_uids``.  Each value is
freed after its last use inside the segment: FLOW's 8x8 patches are about
1 GB each at 1080p on the int64 carrier.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ...core.lowering.lowerers import LOWERERS, torch_mask


def _device(v) -> torch.device:
    return _device(v[0]) if isinstance(v, tuple) else v.device


def megakernel_ref(mk, *invals) -> Tuple[Any, ...]:
    device = _device(invals[0]) if invals else torch.device("cpu")
    env: Dict[int, Any] = dict(zip(mk.in_uids, invals))
    last_use = {u: i for i, n in enumerate(mk.nodes) for u in n.inputs}
    keep = set(mk.out_uids) | set(mk.in_uids)
    for i, n in enumerate(mk.nodes):
        if n.op == "Const":
            env[n.uid] = torch.as_tensor(mk.consts[n.uid]).to(device)[None]
        else:
            env[n.uid] = torch_mask(
                LOWERERS[n.op](n, n.params, [env[u] for u in n.inputs]),
                n.ty)
        for u in set(n.inputs):
            if last_use[u] == i and u not in keep:
                del env[u]
    return tuple(env[u] for u in mk.out_uids)
