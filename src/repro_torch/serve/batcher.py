"""Dynamic micro-batcher: signature-bucketed frame aggregation.

Incoming frames are bucketed by (app, per-frame input signature) so that a
flushed batch is always stackable — same shapes, same dtypes — and every
batch of a bucket reaches the lowering engine with one signature (the
engine's per-signature call counts, ``CompiledPipeline.signatures``).

Two batching disciplines share the bucket store:

- **flush-the-bucket** (push API: ``add``/``due``): a bucket flushes when
  it reaches ``max_batch`` frames (size flush) or when its oldest frame
  has waited ``max_delay_s`` (deadline flush) — a partial bucket stalls
  for the deadline even while the compute pipeline sits idle.
- **continuous (rolling) batching** (pull API: ``put``/``take``): buckets
  are a rolling admission window.  The server *pulls* a batch whenever a
  compute slot frees: a full bucket first, else an expired one, else —
  when the pipeline would otherwise idle — the best partial bucket
  (highest priority class, then fullest, then oldest).  While a batch is
  in flight the window keeps topping up, so the batch dispatched when the
  slot frees is as full as the interim arrivals allow and dispatch never
  idles behind a deadline timer.

``take`` always drains a *single* bucket (at most ``max_batch`` frames),
so a rolling batch can never mix signatures, exactly like a flushed one.

Buckets are the serving-layer analog of the paper's FIFO allocation: each
is a bounded queue whose occupancy (current + high-water) is accounted in
``ServeStats`` and surfaced through ``HWDesign.report()``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


def frame_signature(inputs: Dict[str, Any]) -> Tuple:
    """Hashable (name, shape, dtype) signature of one frame's input dict
    (tuple-valued inputs, e.g. stereo pairs, sign per element).  Delegates
    to the engine's canonical signature helper so bucketing keys can never
    drift from the engine's signature keys (lazy import: the policy half of
    this module stays importable without the lowering)."""
    from ..core.lowering.engine import CompiledPipeline
    return CompiledPipeline.frame_signature(inputs)


@dataclass
class FrameRequest:
    """One in-flight frame: its inputs, bucketing key, and completion."""
    app: str
    inputs: Dict[str, Any]
    signature: Tuple
    enqueue_t: float
    future: Any = None                # concurrent.futures.Future (or None)
    priority: int = 1                 # admission.NORMAL (0=high .. 2=low)


def _stack(leaves: List[Any]):
    if isinstance(leaves[0], tuple):
        return tuple(_stack([leaf[i] for leaf in leaves])
                     for i in range(len(leaves[0])))
    return np.stack([np.asarray(x) for x in leaves])


def stack_frames(reqs: List[FrameRequest],
                 pad_to: Optional[int] = None) -> Tuple[Dict[str, Any], int]:
    """Stack a uniform-signature request list into one batched input dict
    with a leading frame axis; returns ``(batch, n_real)``.  ``pad_to``
    repeats the last frame up to that size so partial deadline flushes
    reach the engine at a batch size warmup has run (frames are
    independent in the batched pipeline, so padding rows cannot perturb
    real rows)."""
    n = len(reqs)
    assert len({r.signature for r in reqs}) == 1, "mixed-signature batch"
    total = max(pad_to or n, n)
    idx = list(range(n)) + [n - 1] * (total - n)
    batch = {k: _stack([reqs[i].inputs[k] for i in idx])
             for k in reqs[0].inputs}
    return batch, n


def split_frames(out: Any, n: int) -> List[Any]:
    """Invert ``stack_frames`` on a batched output (array or tuple of
    arrays), dropping padding rows beyond ``n``.  Frames are copied out of
    the batch buffer: a client retaining one frame's result must not pin
    the whole (padded) batch in memory."""
    if isinstance(out, tuple):
        per = [split_frames(e, n) for e in out]
        return [tuple(p[i] for p in per) for i in range(n)]
    a = np.asarray(out)
    return [a[i].copy() for i in range(n)]


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@dataclass
class _Bucket:
    reqs: List[FrameRequest] = field(default_factory=list)
    oldest_t: float = 0.0


class MicroBatcher:
    """Signature-bucketed size/deadline batcher (pure, clock-injected:
    the caller passes ``now`` so the policy is unit-testable)."""

    def __init__(self, max_batch: int = 8, max_delay_s: float = 0.002,
                 pad_pow2: bool = True):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.max_batch = max_batch
        self.max_delay_s = max_delay_s
        self.pad_pow2 = pad_pow2
        self._buckets: Dict[Tuple, _Bucket] = {}
        # occupancy accounting (FIFO story at the serving layer)
        self.pending = 0
        self.pending_hw = 0
        self.size_flushes = 0
        self.deadline_flushes = 0
        self.topup_flushes = 0        # partial batches pulled by a free slot

    def key_of(self, req: FrameRequest) -> Tuple:
        return (req.app, req.signature)

    def add(self, req: FrameRequest, now: float) -> List[List[FrameRequest]]:
        """Enqueue one frame; returns the batches this arrival completed
        (at most one: the request's own bucket reaching ``max_batch``)."""
        self.put(req, now)
        b = self._buckets[self.key_of(req)]
        if len(b.reqs) >= self.max_batch:
            self.size_flushes += 1
            return [self._flush(self.key_of(req))]
        return []

    # ---- pull API (continuous / rolling batching) ----
    def put(self, req: FrameRequest, now: float) -> None:
        """Enqueue one frame into its rolling window, flushing nothing:
        batches leave via ``take`` when the server has a free slot."""
        b = self._buckets.setdefault(self.key_of(req), _Bucket())
        if not b.reqs:
            b.oldest_t = now
        b.reqs.append(req)
        self.pending += 1
        self.pending_hw = max(self.pending_hw, self.pending)

    def has_pending(self) -> bool:
        return self.pending > 0

    def take(self, now: float, allow_partial: bool = False,
             partial_hold_s: float = 0.0) -> Optional[List[FrameRequest]]:
        """Pull the next dispatchable batch (up to ``max_batch`` frames
        from ONE bucket — never mixing signatures), or None.

        Selection order: a full bucket (size flush) first, then a bucket
        whose oldest frame has expired (deadline flush), then — only with
        ``allow_partial`` (a compute slot would otherwise idle) — the
        best partial bucket: most important priority class, then most
        frames, then oldest.  A partial is top-up eligible only once its
        oldest frame has waited ``partial_hold_s`` — the batching window
        that keeps burst arrivals from being shattered into singleton
        batches when compute keeps pace with the arrival gap.  The
        un-taken remainder of an over-full bucket stays as the rolling
        window's head, its deadline reset to the remaining oldest frame.
        """
        best_key, best_rank = None, None
        for key, b in self._buckets.items():
            if not b.reqs:
                continue
            full = len(b.reqs) >= self.max_batch
            expired = now - b.oldest_t >= self.max_delay_s
            held = now - b.oldest_t >= partial_hold_s
            if not (full or expired or (allow_partial and held)):
                continue
            # rank: full beats expired beats topped-up partial; within a
            # tier, highest priority class, then fullest, then oldest
            tier = 0 if full else (1 if expired else 2)
            rank = (tier, min(r.priority for r in b.reqs),
                    -len(b.reqs), b.oldest_t)
            if best_rank is None or rank < best_rank:
                best_key, best_rank = key, rank
        if best_key is None:
            return None
        b = self._buckets[best_key]
        tier = best_rank[0]
        if tier == 0:
            self.size_flushes += 1
        elif tier == 1:
            self.deadline_flushes += 1
        else:
            self.topup_flushes += 1
        if len(b.reqs) <= self.max_batch:
            return self._flush(best_key)
        reqs, b.reqs = b.reqs[:self.max_batch], b.reqs[self.max_batch:]
        b.oldest_t = b.reqs[0].enqueue_t
        self.pending -= len(reqs)
        return reqs

    def due(self, now: float) -> List[List[FrameRequest]]:
        """Deadline sweep: flush every bucket whose oldest frame has waited
        ``max_delay_s`` (fires partial batches)."""
        out = []
        for key in [k for k, b in self._buckets.items()
                    if b.reqs and now - b.oldest_t >= self.max_delay_s]:
            self.deadline_flushes += 1
            out.append(self._flush(key))
        return out

    def flush_all(self) -> List[List[FrameRequest]]:
        """Drain every bucket (server shutdown)."""
        return [self._flush(k) for k, b in list(self._buckets.items())
                if b.reqs]

    def next_deadline(self) -> Optional[float]:
        """Absolute time of the earliest pending deadline, or None."""
        ts = [b.oldest_t + self.max_delay_s
              for b in self._buckets.values() if b.reqs]
        return min(ts) if ts else None

    def next_topup_ready(self, partial_hold_s: float) -> Optional[float]:
        """Absolute time when the earliest pending bucket becomes top-up
        eligible under ``partial_hold_s``, or None when nothing pends."""
        ts = [b.oldest_t + partial_hold_s
              for b in self._buckets.values() if b.reqs]
        return min(ts) if ts else None

    def pad_target(self, n: int) -> Optional[int]:
        """The warmed (pow2) batch size for an ``n``-frame flush."""
        return min(next_pow2(n), self.max_batch) if self.pad_pow2 else None

    def _flush(self, key: Tuple) -> List[FrameRequest]:
        reqs = self._buckets.pop(key).reqs
        self.pending -= len(reqs)
        return reqs
