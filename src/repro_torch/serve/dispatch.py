"""Batch dispatch through the lowering engine, CUDA streams of its own.

``submit()`` stacks a batch, copies it to each device through pinned host
buffers (``device_put_batch``), enqueues the compiled pipeline on it
(``run_batch_device``) and records a ``torch.cuda.Event``, all under the
dispatcher's compute stream for that device, and returns without
waiting: the upload, the kernels (K1-K3 launch on
``torch.cuda.current_stream()``, which is this stream) and the generic
segments and ``External``'s host call of the plan are ordered on that
stream.  ``InflightBatch.wait()`` reads the results back on a read-back
stream of its own (one a slot of ``depth``), which waits on the batch's
event only: the copies go with ``non_blocking=True`` into page-locked
buffers of that slot, and the thread blocks on an event recorded after
them, then copies the rows into numpy arrays the caller owns.

While batch N runs, the server submits batch N+1: N+1's host staging
overlaps N's kernels, and its upload and kernels queue behind N's on the
compute stream; N's read-back waits for N's event alone, so it overlaps
N+1's upload and kernels.  The server calls ``submit`` on its event
loop's thread and ``wait`` on a readback thread, and bounds the batches
in flight at ``depth`` (2 = double buffering), the backpressure point
between batching and compute: a slot's read-back buffers are reused only
once the batch that last used them was read.

On the CPU there is no stream and no event: ``submit`` runs the batch to
completion and ``wait`` converts the results.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .batcher import FrameRequest, split_frames, stack_frames
from .sharding import PinnedRing, device_put_batch, shard_frames


def _to_host(r):
    if isinstance(r, tuple):
        return tuple(_to_host(x) for x in r)
    return r.cpu().numpy()


def _copy_out(r, bufs: Dict[Any, torch.Tensor], stream, key=()):
    """Enqueue ``r``'s copy into the page-locked buffer ``bufs[key]`` on
    ``stream`` (``record_stream`` keeps ``r``'s memory from reuse until
    the copy is done); returns the buffers in ``r``'s structure."""
    if isinstance(r, tuple):
        return tuple(_copy_out(x, bufs, stream, key + (i,))
                     for i, x in enumerate(r))
    buf = bufs.get(key)
    if buf is None or buf.shape != r.shape or buf.dtype != r.dtype:
        buf = torch.empty(r.shape, dtype=r.dtype, pin_memory=True)
        bufs[key] = buf
    r.record_stream(stream)
    buf.copy_(r, non_blocking=True)
    return buf


def _owned(h):
    if isinstance(h, tuple):
        return tuple(_owned(x) for x in h)
    return h.numpy().copy()


def _concat(parts: List[Any]):
    if isinstance(parts[0], tuple):
        return tuple(_concat([p[i] for p in parts])
                     for i in range(len(parts[0])))
    return parts[0] if len(parts) == 1 else np.concatenate(parts)


class _Shard:
    """One device's part of a dispatched batch.  It holds the device
    inputs and outputs until they were read; ``event`` was recorded after
    the batch's work on the compute stream, and ``read`` copies the
    outputs back on ``stream``, a read-back stream, into ``bufs``, its
    slot's page-locked buffers."""

    def __init__(self, inputs, out, event=None, stream=None, bufs=None):
        self.inputs = inputs
        self.out = out
        self.event = event
        self.stream = stream
        self.bufs = bufs

    def read(self):
        if self.event is None:
            return _to_host(self.out)
        with torch.cuda.device(self.stream.device), \
                torch.cuda.stream(self.stream):
            self.stream.wait_event(self.event)
            host = _copy_out(self.out, self.bufs, self.stream)
            done = torch.cuda.Event()
            done.record(self.stream)
        done.synchronize()
        return _owned(host)


class InflightBatch:
    """A dispatched batch: its device shards plus the requests awaiting
    them.  ``wait()`` reads each shard back and returns per-frame numpy
    outputs (padding rows dropped)."""

    def __init__(self, reqs: List[FrameRequest], shards: List[_Shard],
                 n: int, t_dispatch: float):
        self.reqs = reqs
        self._shards = shards
        self._n = n
        self.t_dispatch = t_dispatch

    def wait(self) -> List[Any]:
        shards, self._shards = self._shards, []
        return split_frames(_concat([s.read() for s in shards]), self._n)


class BatchDispatcher:
    """Dispatch stacked batches of one app: ``compiled`` holds one
    ``CompiledPipeline`` per device the frame axis splits over (one entry
    for a single device)."""

    def __init__(self, compiled: Sequence, depth: int = 2):
        self.compiled = list(compiled)
        if not self.compiled:
            raise ValueError("BatchDispatcher needs a compiled pipeline")
        self._depth = depth
        self._submitted = 0
        cuda = [c.device.type == "cuda" for c in self.compiled]
        self._streams = [torch.cuda.Stream(device=c.device) if on else None
                         for c, on in zip(self.compiled, cuda)]
        self._staging = [PinnedRing(depth) if on else None for on in cuda]
        # a device's read-back streams and page-locked output buffers, one
        # a slot: at most ``depth`` batches are in flight, so a slot's are
        # free again when its next batch is read
        self._readback = [[(torch.cuda.Stream(device=c.device), {})
                           for _ in range(depth)] if on else None
                          for c, on in zip(self.compiled, cuda)]

    def submit(self, reqs: List[FrameRequest],
               pad_to: Optional[int] = None) -> InflightBatch:
        batch, _ = stack_frames(reqs, pad_to=pad_to)
        parts, _n = shard_frames(batch, len(self.compiled))
        slot = self._submitted % self._depth
        self._submitted += 1
        shards = []
        for lp, stream, staging, readback, part in zip(
                self.compiled, self._streams, self._staging, self._readback,
                parts):
            if stream is None:
                inputs = device_put_batch(part, lp.device)
                shards.append(_Shard(inputs, lp.run_batch_device(inputs)))
                continue
            with torch.cuda.device(lp.device), torch.cuda.stream(stream):
                inputs = device_put_batch(part, lp.device, stream, staging)
                out = lp.run_batch_device(inputs)
                event = torch.cuda.Event()
                event.record(stream)
            staging.seal(event)
            shards.append(_Shard(inputs, out, event, *readback[slot]))
        return InflightBatch(reqs, shards, len(reqs), time.perf_counter())
