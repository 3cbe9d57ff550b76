"""Deterministic synthetic token pipeline with multi-process sharding and
prefetch: the counterpart of ``repro.data.pipeline``.

  - determinism: batch t is a pure function of (seed, step), the
    reference's numpy LCG bit for bit, so a restart replays identical data
    with nothing to checkpoint beyond the step counter;
  - process sharding: each process makes only its rows of the global
    batch (``torch.distributed``'s rank and world size when it is
    initialised, else 0 and 1);
  - prefetch: a background thread keeps ``prefetch`` batches ahead.  On
    the card each batch goes to pinned host memory and then to the card
    by a non-blocking copy on a side stream; the iterator makes the
    caller's stream wait on that copy's event before handing it over.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np
import torch

from ..core.lowering import resolve_device


@dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab: int
    seed: int = 0
    input_mode: str = "tokens"      # tokens | embeddings
    d_model: int = 0                # for embeddings mode
    prefetch: int = 2


def _batch_at(cfg: DataConfig, step: int, lo: int, hi: int
              ) -> Dict[str, np.ndarray]:
    """Rows [lo, hi) of global batch `step` — pure function of (seed, step).

    A cheap LCG keyed by (seed, step, row) generates a Zipf-ish token
    stream with document structure (BOS resets every ~512 tokens)."""
    n, s = hi - lo, cfg.seq_len
    rows = np.arange(lo, hi, dtype=np.uint64)[:, None]
    cols = np.arange(s + 1, dtype=np.uint64)[None, :]
    key = np.uint64((cfg.seed * 0x9E3779B97F4A7C15
                     + step * 0xBF58476D1CE4E5B9) % (1 << 64))
    x = (rows * np.uint64(6364136223846793005) + cols + key)
    x ^= x >> np.uint64(33)
    x *= np.uint64(0xFF51AFD7ED558CCD)
    x ^= x >> np.uint64(33)
    # Zipf-ish: square the uniform to skew towards small ids
    u = (x % np.uint64(1 << 30)).astype(np.float64) / float(1 << 30)
    toks = (u * u * (cfg.vocab - 2)).astype(np.int32) + 2
    doc_pos = (np.arange(s + 1) + (x[:, :1] % np.uint64(512)).astype(
        np.int64)) % 512
    toks = np.where(doc_pos == 0, 1, toks)          # BOS
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.input_mode == "embeddings":
        emb = ((toks[:, :-1, None] * np.arange(1, cfg.d_model + 1)) % 97
               ).astype(np.float32) / 97.0 - 0.5
        out["tokens"] = emb
    return out


def process_slice(global_batch: int):
    """(lo, hi): this process's rows of a global batch."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        pc, pi = dist.get_world_size(), dist.get_rank()
    else:
        pc, pi = 1, 0
    per = global_batch // pc
    return pi * per, (pi + 1) * per


def make_dataset(cfg: DataConfig, start_step: int = 0,
                 device="cuda") -> Iterator[Dict[str, torch.Tensor]]:
    """Infinite iterator of this process's batches on ``device``, from
    ``start_step`` on.  Raises without a card unless ``device`` is the
    CPU."""
    device = resolve_device(device)
    lo, hi = process_slice(cfg.global_batch)
    side = torch.cuda.Stream(device) if device.type == "cuda" else None

    def produce(step):
        host = {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in _batch_at(cfg, step, lo, hi).items()}
        if side is None:
            return host, None
        with torch.cuda.stream(side):
            out = {k: v.pin_memory().to(device, non_blocking=True)
                   for k, v in host.items()}
            ready = torch.cuda.Event()
            ready.record(side)
        return out, ready

    q: "queue.Queue" = queue.Queue(maxsize=cfg.prefetch)
    stop = threading.Event()

    def worker():
        step = start_step
        while not stop.is_set():
            item = produce(step)
            while not stop.is_set():
                try:
                    q.put(item, timeout=1.0)
                    break
                except queue.Full:
                    continue
            step += 1

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            batch, ready = q.get()
            if ready is not None:
                stream = torch.cuda.current_stream(device)
                stream.wait_event(ready)
                for v in batch.values():
                    v.record_stream(stream)
            yield batch
    finally:
        stop.set()
