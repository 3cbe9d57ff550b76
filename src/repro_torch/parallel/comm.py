"""Collective byte counting for the roofline; the role of
``repro/parallel/hlo.py``.

The reference parses XLA's optimized HLO text and sums the result shape of
every communication op.  The port has no HLO: it counts at dispatch
instead.  ``collective_bytes()`` is a ``TorchDispatchMode`` that sees the
collectives DTensor and ``torch.distributed`` issue on each rank's local
tensors (``_c10d_functional`` ops, DTensor's shard-to-shard all-to-all,
and the eager ``c10d`` ops) and sums each one's result bytes per kind, the
reference's accounting and keys: ``all-gather``, ``all-reduce``,
``reduce-scatter``, ``all-to-all``, ``collective-permute`` and ``total``.
It counts one rank's bytes: on a fake process group, the bytes each rank
of the mesh would move.

    with collective_bytes() as rec:
        step(...)
    rec.counts   # {"all-gather": ..., ..., "total": ...}
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# op name (namespace.name) -> (kind, where the result tensors are: "out" for
# the op's return, an int for that positional argument of an in-place op)
_OPS = {
    "_c10d_functional.all_gather_into_tensor": ("all-gather", "out"),
    "_c10d_functional.all_gather_into_tensor_out": ("all-gather", "out"),
    "_c10d_functional.all_gather_into_tensor_coalesced": ("all-gather", "out"),
    "_c10d_functional.all_reduce": ("all-reduce", "out"),
    "_c10d_functional.all_reduce_": ("all-reduce", "out"),
    "_c10d_functional.all_reduce_coalesced": ("all-reduce", "out"),
    "_c10d_functional.all_reduce_coalesced_": ("all-reduce", "out"),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", "out"),
    "_c10d_functional.reduce_scatter_tensor_coalesced": ("reduce-scatter",
                                                         "out"),
    "_c10d_functional.all_to_all_single": ("all-to-all", "out"),
    "_dtensor.shard_dim_alltoall": ("all-to-all", "out"),
    "c10d.allgather_": ("all-gather", 0),
    "c10d._allgather_base_": ("all-gather", 0),
    "c10d.allgather_coalesced_": ("all-gather", 0),
    "c10d.allgather_into_tensor_coalesced_": ("all-gather", 0),
    "c10d.allreduce_": ("all-reduce", 0),
    "c10d.allreduce_coalesced_": ("all-reduce", 0),
    "c10d.reduce_scatter_": ("reduce-scatter", 0),
    "c10d._reduce_scatter_base_": ("reduce-scatter", 0),
    "c10d.reduce_scatter_tensor_coalesced_": ("reduce-scatter", 0),
    "c10d.alltoall_": ("all-to-all", 0),
    "c10d.alltoall_base_": ("all-to-all", 0),
    "c10d.recv_": ("collective-permute", 0),
}


def _nbytes(obj) -> int:
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (list, tuple)):
        return sum(_nbytes(o) for o in obj)
    return 0


class collective_bytes(TorchDispatchMode):
    """Bytes moved per collective kind (result-shape accounting) while the
    mode is on; ``counts`` also has ``total``, and ``calls`` the number of
    collectives per kind."""

    def __init__(self):
        super().__init__()
        self.counts: Dict[str, int] = {"total": 0}
        self.calls: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            # let DTensor run and issue its collectives on local tensors,
            # which come back through this mode
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        op = getattr(func, "_overloadpacket", None)
        name = f"{func.namespace}.{op.__name__}" if op is not None else ""
        if name in _OPS:
            kind, where = _OPS[name]
            n = _nbytes(out if where == "out" else args[where])
            self.counts[kind] = self.counts.get(kind, 0) + n
            self.counts["total"] = self.counts.get("total", 0) + n
            self.calls[kind] = self.calls.get(kind, 0) + 1
        return out
