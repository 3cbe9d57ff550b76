"""Frame-axis sharding and host-to-device staging for the serving layer.

A stacked batch carries frames on axis 0.  With more than one device the
axis splits into contiguous shards, one per device, and each shard runs
through that device's own lowering (``design.lower(backend, device=d)``).
With one device (``devices`` None or a single entry) nothing splits, so
callers never branch on the device count.

On a CUDA device every stacked leaf is copied into a page-locked host
buffer of a ``PinnedRing`` and from there to the device with
``non_blocking=True`` on the dispatcher's stream, so the copy is ordered
before the batch's kernels on that stream (and after the previous
batch's); the staging into the pinned buffer overlaps the previous
batch's work.  On the CPU there is no pinning and no stream.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def frame_sharding(devices=None) -> Optional[List[torch.device]]:
    """The devices the frame axis splits over, as ``torch.device``s, or
    None when there is one device (``devices`` None or a single entry)."""
    if devices is None:
        return None
    devs = [torch.device(d) for d in devices]
    for d in devs:
        if d.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {d} (want cuda or cpu)")
    return devs if len(devs) > 1 else None


def _n_frames(batch: Dict[str, Any]) -> int:
    v = next(iter(batch.values()))
    return (v[0] if isinstance(v, tuple) else v).shape[0]


def pad_frames(batch: Dict[str, Any], multiple: int
               ) -> Tuple[Dict[str, Any], int]:
    """Pad the frame axis up to a multiple of ``multiple`` by repeating the
    last frame (rows are independent in the batched pipeline); returns
    (batch, n_real)."""
    n = _n_frames(batch)
    pad = (-n) % multiple
    if pad == 0:
        return batch, n

    def ext(v):
        if isinstance(v, tuple):
            return tuple(ext(e) for e in v)
        a = np.asarray(v)
        return np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])

    return {k: ext(v) for k, v in batch.items()}, n


def shard_frames(batch: Dict[str, Any], n_shards: int
                 ) -> Tuple[List[Dict[str, Any]], int]:
    """Split a stacked batch into ``n_shards`` contiguous, equal shards of
    the frame axis (padded first to a multiple of ``n_shards``); returns
    (shards, n_real)."""
    batch, n = pad_frames(batch, n_shards)
    per = _n_frames(batch) // n_shards

    def cut(v, i):
        if isinstance(v, tuple):
            return tuple(cut(e, i) for e in v)
        return np.asarray(v)[i * per:(i + 1) * per]

    return [{k: cut(v, i) for k, v in batch.items()}
            for i in range(n_shards)], n


class PinnedRing:
    """Page-locked staging buffers of one device's transfers, in ``depth``
    slots used in turn.  ``begin()`` takes the next slot and first waits
    for the event of the batch that used it ``depth`` batches ago, so a
    buffer is never rewritten while a copy from it may still be pending;
    ``seal(event)`` hands the slot the event of the batch now using it.
    The server keeps at most ``depth`` batches in flight, so the wait in
    ``begin()`` finds that event complete."""

    def __init__(self, depth: int = 2):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self._slots: List[Dict[Any, torch.Tensor]] = [
            {} for _ in range(depth)]
        self._events: List[Optional[torch.cuda.Event]] = [None] * depth
        self._next = 0
        self._cur: Optional[int] = None

    def begin(self) -> None:
        i = self._next
        self._next = (i + 1) % len(self._slots)
        ev = self._events[i]
        if ev is not None:
            ev.synchronize()
            self._events[i] = None
        self._cur = i

    def stage(self, key, t: torch.Tensor) -> torch.Tensor:
        """``t`` copied into the current slot's pinned buffer for ``key``."""
        if self._cur is None:
            raise RuntimeError("PinnedRing.stage before begin()")
        slot = self._slots[self._cur]
        buf = slot.get(key)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            slot[key] = buf
        buf.copy_(t)
        return buf

    def seal(self, event: torch.cuda.Event) -> None:
        if self._cur is None:
            raise RuntimeError("PinnedRing.seal before begin()")
        self._events[self._cur] = event
        self._cur = None


def device_put_batch(batch: Dict[str, Any], device,
                     stream: Optional[torch.cuda.Stream] = None,
                     staging: Optional[PinnedRing] = None
                     ) -> Dict[str, Any]:
    """The stacked batch as tensors on ``device`` (leaves keep their
    dtypes; the engine casts integers to its int64 carrier on the device).

    On a CUDA device each leaf goes through a pinned buffer of a slot of
    ``staging`` (begun here) and is copied with ``non_blocking=True`` on
    ``stream``, the dispatcher's: the caller records an event on that
    stream after the batch's work and passes it to ``staging.seal``, and
    keeps the returned tensors alive until that event completes.  On the
    CPU the leaves are wrapped without a copy (no stream, no staging)."""
    dev = torch.device(device)

    def put(key, v):
        if isinstance(v, tuple):
            return tuple(put(key + (i,), e) for i, e in enumerate(v))
        t = torch.from_numpy(np.ascontiguousarray(v))
        if dev.type == "cpu":
            return t
        return staging.stage(key, t).to(dev, non_blocking=True)

    if dev.type == "cpu":
        return {k: put((k,), v) for k, v in batch.items()}
    if stream is None or staging is None:
        raise ValueError("a transfer to the card takes the dispatcher's "
                         "stream and its PinnedRing")
    staging.begin()
    with torch.cuda.device(dev), torch.cuda.stream(stream):
        return {k: put((k,), v) for k, v in batch.items()}
