"""A per-device body over a ``DeviceMesh``: the counterpart of jax's
``shard_map(..., check_rep=False)``, on DTensor's ``local_map``, and the
collectives a body calls (``psum``, ``pmax``, ``all_to_all``).

``shard_map(local, mesh, in_specs, out_specs)`` returns a function of
global tensors.  A DTensor argument is redistributed to its spec; any other
tensor is taken as the global value, the same on every rank, and sliced to
this rank's shard differentiably.  ``local`` sees each rank's shard as a
plain tensor and returns its shard of the output.  The output is a DTensor
if any argument was one, else the global value as a plain tensor on every
rank.

Gradients follow shard_map's transpose: an argument split over a mesh axis
gets its shard's gradient; an argument replicated over an axis gets the sum
of every rank's gradient on that axis (``Partial``, reduced when the
gradient leaves the body), since each rank's body used it for its own part
of the work.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from .mapper import PartitionSpec, placements


def batch_axes(mesh):
    """The mesh axes a batch dim is split over: ("pod", "data") on the
    multi-pod mesh, else "data"."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else "data"


class _PSum(torch.autograd.Function):
    """All-reduce (sum) over a process group; its backward all-reduces the
    gradient (every rank's output is the same sum of every rank's input)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_reduce(t, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def _all_reduce(t, group):
    import torch.distributed._functional_collectives as funcol
    return funcol.wait_tensor(funcol.all_reduce(t.contiguous(), "sum", group))


def psum(t, group):
    """``lax.psum`` over ``group``, differentiable."""
    return _PSum.apply(t, group)


def pmax(t, group):
    """``lax.pmax`` over ``group`` (no gradient)."""
    import torch.distributed._functional_collectives as funcol
    return funcol.wait_tensor(funcol.all_reduce(t.detach().contiguous(),
                                                "max", group))


def all_to_all(t, group):
    """``lax.all_to_all(t, axis, 0, 0, tiled=False)``: chunk i of dim 0 to
    rank i of ``group``, chunk j of the result from rank j; differentiable
    (the backward is the reverse all-to-all)."""
    import torch.distributed._functional_collectives as funcol
    return funcol.wait_tensor(funcol.all_to_all_single_autograd(
        t.contiguous(), None, None, group))


def to_mesh(x, mesh, spec: PartitionSpec):
    """A plain tensor holding the global value (the same on every rank) as a
    DTensor placed by ``spec``: replicated, then split locally.  It stays
    in the graph: ``x``'s gradient is the whole gradient on every rank
    (the split's backward gathers it)."""
    from torch.distributed.tensor import DTensor, Replicate
    rep = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                             run_check=False)
    return rep.redistribute(mesh, placements(spec, mesh))


def shard_map(local: Callable, mesh, in_specs: Sequence[PartitionSpec],
              out_specs: PartitionSpec) -> Callable:
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    in_pl = tuple(placements(s, mesh) for s in in_specs)
    grad_pl = tuple([Partial() if isinstance(p, Replicate) else p for p in pl]
                    for pl in in_pl)
    fn = local_map(local, out_placements=placements(out_specs, mesh),
                   in_placements=in_pl, in_grad_placements=grad_pl,
                   device_mesh=mesh, redistribute_inputs=True)

    def run(*args):
        plain = not any(isinstance(a, DTensor) for a in args)
        out = fn(*(a if isinstance(a, DTensor) else to_mesh(a, mesh, s)
                   for a, s in zip(args, in_specs)))
        return out.full_tensor() if plain else out

    return run
