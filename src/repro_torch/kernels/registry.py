"""Operator-to-kernel registry: the resident hand-written CUDA kernels
addressable by the lowering compiler (core/lowering/).

The software analog of the paper's library of hand-optimized Rigel2
hardware generators (§5.2): a declarative rewrite rule (core/lowering/
patterns.py) recognizes an HWImg subgraph at a site and dispatches it to
the registered kernel through ``site_fn``; the engine launches each fused
segment through the ``megakernel`` entry.  Every entry carries its plain
PyTorch version (``ref_fn``), the source it is built from, the TPU kernel
it replaces, and a launch counter.  ``flash_attention`` (K4) is called by
the model substrate (models/layers.py) and ``cyclesim`` by the cycle
engines (hwsim/vector.py, hwsim/population.py), not by the lowering, so
they have no HWImg site.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

from . import _build


@dataclass(frozen=True)
class KernelEntry:
    name: str
    kernel_fn: Callable             # wrapper: CUDA kernel or plain on CPU
    ref_fn: Callable                # plain PyTorch version
    site_fn: Optional[Callable]     # HWImg-site adapter (lowering)
    source: str                     # CUDA source, repo-relative
    replaces: str                   # the TPU kernel, file:line

    def launches(self) -> int:
        """Launches of this kernel since the last reset_launch_counts()."""
        return _build.launch_count(self.name)


KERNELS: Dict[str, KernelEntry] = {}


def register_kernel(entry: KernelEntry) -> KernelEntry:
    KERNELS[entry.name] = entry
    return entry


def get_kernel(name: str) -> KernelEntry:
    return KERNELS[name]


def reset_launch_counts() -> None:
    _build.reset_launch_counts()


def _register_resident() -> None:
    from .conv2d.ops import conv2d_hwimg_site, conv2d_stencil
    from .cyclesim import cycle_sim, cycle_sim_ref
    from .conv2d.ref import conv2d_ref
    from .flash.ops import flash_attention
    from .flash.ref import attention_ref
    from .megakernel.ops import megakernel_segment
    from .megakernel.ref import megakernel_ref
    from .sad.ops import sad_disparity, sad_hwimg_site
    from .sad.ref import sad_ref

    register_kernel(KernelEntry(
        "conv2d", conv2d_stencil, conv2d_ref, conv2d_hwimg_site,
        source="src/repro_torch/csrc/conv2d.cu",
        replaces="src/repro/kernels/conv2d/kernel.py:25"))
    register_kernel(KernelEntry(
        "sad", sad_disparity, sad_ref, sad_hwimg_site,
        source="src/repro_torch/csrc/sad.cu",
        replaces="src/repro/kernels/sad/kernel.py:20"))
    # K3: one kernel per fused segment, CUDA C++ that the emitter writes
    # (with csrc/mk_common.cuh) and _build compiles per segment
    register_kernel(KernelEntry(
        "megakernel", megakernel_segment, megakernel_ref, megakernel_segment,
        source="src/repro_torch/core/lowering/megakernel.py",
        replaces="src/repro/core/lowering/megakernel.py:372"))
    # K4: prefill and decode forms (flash_attention, flash_decode; the
    # decode form's source is csrc/flash_decode.cu), counted under one name
    # (and each form under "flash_attention:<form>", flash.ops.form_launches)
    register_kernel(KernelEntry(
        "flash_attention", flash_attention, attention_ref, None,
        source="src/repro_torch/csrc/flash_attn.cu",
        replaces="src/repro/kernels/flash/kernel.py:26"))
    # the cycle kernel ports the reference's two XLA loops (no pallas_call):
    # vector.py::_segment_impl and population.py:180 _pop_impl
    register_kernel(KernelEntry(
        "cyclesim", cycle_sim, cycle_sim_ref, None,
        source="src/repro_torch/csrc/cyclesim.cu",
        replaces="src/repro/hwsim/vector.py:458"))


_register_resident()
