"""Production mesh construction; the counterpart of ``repro.launch.mesh``.

A function, not a module-level constant: importing this module touches no
process group.  Single pod = 256 devices as (data=16, model=16); multi-pod
= 2 pods x 256 devices as (pod=2, data=16, model=16).  The 'pod' axis
carries the slow (inter-pod) hop: only data parallelism (and optionally
the decode cache sequence) is mapped onto it.

``make_production_mesh`` builds a ``DeviceMesh`` on the process group that
exists (``torch.distributed.init_process_group`` first: NCCL ranks on
cards, or the dry run's fake group of 256 / 512 ranks); ``production_shape``
gives the same axes and sizes with no process group, which is all the
sharding mapper reads.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple


class MeshShape(NamedTuple):
    """A mesh's axis names and sizes, with a ``DeviceMesh``'s attribute
    names, for the mapper when there is no process group."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]


def production_shape(*, multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """The production ``DeviceMesh`` over the existing process group, which
    must have 256 ranks (512 with ``multi_pod``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    want = production_shape(multi_pod=multi_pod)
    n = 1
    for s in want.shape:
        n *= s
    if not dist.is_initialized():
        raise RuntimeError(f"make_production_mesh: no process group; the "
                           f"{'x'.join(map(str, want.shape))} mesh wants "
                           f"{n} ranks")
    if dist.get_world_size() != n:
        raise RuntimeError(f"make_production_mesh: the process group has "
                           f"{dist.get_world_size()} ranks; the "
                           f"{'x'.join(map(str, want.shape))} mesh wants {n}")
    return init_device_mesh(device_type, want.shape,
                            mesh_dim_names=want.mesh_dim_names)


# Roofline constants per device: datasheet figures of the card the chip
# runs report, "NVIDIA H100 80GB HBM3, 700.00 W" (H100 SXM5), not
# measurements.
PEAK_FLOPS_BF16 = 989e12          # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12                  # HBM3 bytes/s
NVLINK_BW = 450e9                 # NVLink 4 bytes/s per direction (900 both)
HBM_BYTES = 80e9                  # HBM bytes a card
