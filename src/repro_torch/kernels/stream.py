"""Tile constants of the megakernel emitter (K3), the torch counterpart of
``repro/kernels/stream.py``.

The reference streams 8-row blocks across the whole frame width, with the
input frames resident in the TPU's VMEM.  A Hopper block has at most
232,448 B of shared memory, so the CUDA kernel tiles columns as well as
rows: each node of a fused segment keeps the 2-D *window* of its virtual
frame that its consumers demand, and every value outside the node's own
frame reads as zero (the executor's stencil zero fill).  The window
helpers themselves (floor division, wrap masks, zero-filled reads) are
CUDA C++ in ``csrc/mk_common.cuh``; the CPU tests hold a torch model of
the same tiling.
"""
from __future__ import annotations

from typing import Tuple

import torch

# rows of one output tile: the reference's MK_BLOCK_ROWS, so the row
# demands of every node equal the reference's at its streaming block
MK_BLOCK_ROWS = 8
# columns of one output tile, shrunk by the emitter until the segment's
# windows fit in shared memory
MK_TILE_COLS = 32
MK_THREADS = 256                        # threads per block
MK_SMEM_LIMIT = 232_448                 # shared memory one H100 block can use
MK_SM_SMEM = 233_472                    # shared memory of one H100 SM
MK_SMEM_RESERVED = 1_024                # of it, reserved per resident block
MK_SM_THREADS = 2_048                   # resident threads per SM


def nbytes(shape: Tuple[int, ...], dtype: torch.dtype) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n * torch.empty((), dtype=dtype).element_size()
