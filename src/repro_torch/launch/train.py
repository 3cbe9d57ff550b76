"""Fault-tolerant training launcher; the counterpart of
``repro.launch.train``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
      --smoke --steps 50 --ckpt-dir CKPT_DIR [--device cpu]

``--smoke`` takes the reduced config; without it the full config trains
(its numpy ``init_params`` takes minutes at full width).  Without
``--device cpu`` it runs on the card and raises if there is none.

What it keeps of the reference:
  - resume from the newest committed checkpoint (crash or preemption);
  - SIGTERM: a synchronous save, then a clean exit;
  - a heartbeat file per process and a per-step wall-time watchdog that
    warns of a straggler;
  - ``async_save`` every ``--ckpt-every`` steps: the step that follows
    waits for the device-to-host copy into pinned buffers (allocated by
    the first save, reused by the later ones), and the files are written
    on a background thread;
  - deterministic data: a resumed run replays the exact token stream from
    its start step.
A checkpoint is labelled with the number of updates it holds, the periodic
ones as the final one (the reference labels its periodic saves one lower,
so resuming from one would take a batch twice); resuming from step N takes
batch N next.  Each step ends with a read of its loss, so the step times
are the card's.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from ..checkpoint import (async_save, latest_step, restore_checkpoint,
                          save_checkpoint, wait_for_save)
from ..checkpoint.ckpt import process_index
from ..configs import ARCHS, reduced
from ..core.lowering import resolve_device
from ..data import DataConfig, make_dataset
from ..models import init_params, param_specs
from ..models.config import ModelConfig
from ..models.model import P
from ..optim import AdamWState, adamw_init
from ..train.steps import build_train_step


@dataclass
class TrainResult:
    start_step: int                 # the step the run began at (resumed)
    end_step: int                   # updates held by the final checkpoint
    losses: List[float] = field(default_factory=list)
    gnorms: List[float] = field(default_factory=list)
    step_s: List[float] = field(default_factory=list)   # host clock
    save_s: List[float] = field(default_factory=list)   # each async_save
    params: Any = None
    opt: Any = None


def _state_target(cfg: ModelConfig):
    """The (params, AdamW state) structure with each leaf's shape, for a
    restore that allocates nothing before it reads."""
    specs = param_specs(cfg)
    return specs, AdamWState(P((), ()), specs, specs)


def train(cfg: ModelConfig, *, steps: int, batch: int, seq: int,
          ckpt_dir: str, ckpt_every: int = 20, log_every: int = 10,
          straggler_factor: float = 3.0, device="cuda",
          init: Optional[Callable] = None) -> TrainResult:
    """Train ``cfg`` to ``steps`` updates with AdamW on the synthetic
    stream, resuming from ``ckpt_dir``'s newest committed step.  ``init``
    (cfg, device) -> params makes the first parameters; init_params with
    seed 0 unless given."""
    device = resolve_device(device)
    dcfg = DataConfig(seq_len=seq, global_batch=batch, vocab=cfg.vocab,
                      input_mode=cfg.input_mode, d_model=cfg.d_model)
    step0 = 0
    last = latest_step(ckpt_dir)
    if last is not None:
        print(f"resuming from step {last}", flush=True)
        params, opt = restore_checkpoint(ckpt_dir, last, _state_target(cfg),
                                         device=device)
        step0 = last
    else:
        params = (init or (lambda c, d: init_params(c, 0, d)))(cfg, device)
        opt = adamw_init(params)
    train_step = build_train_step(cfg)
    data = make_dataset(dcfg, start_step=step0, device=device)

    stop = {"now": False}

    def on_sigterm(signum, frame):
        print("SIGTERM: checkpoint + exit", flush=True)
        stop["now"] = True

    previous = signal.signal(signal.SIGTERM, on_sigterm)
    os.makedirs(ckpt_dir, exist_ok=True)
    hb_path = os.path.join(ckpt_dir, f"heartbeat_{process_index()}")
    res = TrainResult(start_step=step0, end_step=step0)
    t_prev = time.time()
    step = step0 - 1
    try:
        for step in range(step0, steps):
            b = next(data)
            if cfg.mrope_sections:
                b["positions"] = torch.arange(
                    seq, dtype=torch.int32, device=device)[None, None].expand(
                        3, batch, seq)
            params, opt, metrics = train_step(params, opt, b)
            loss, gnorm = float(metrics["loss"]), float(metrics["gnorm"])
            dt = time.time() - t_prev
            t_prev = time.time()
            res.losses.append(loss)
            res.gnorms.append(gnorm)
            res.step_s.append(dt)
            # heartbeat + straggler watchdog
            with open(hb_path, "w") as f:
                json.dump({"step": step, "t": time.time(), "dt": dt}, f)
            med = float(np.median(res.step_s[-20:]))
            if len(res.step_s) > 5 and dt > straggler_factor * med:
                print(f"WARN step {step}: {dt:.2f}s vs median {med:.2f}s "
                      f"(straggler suspect)", flush=True)
            if step % log_every == 0:
                print(f"step {step}: loss={loss:.4f} gnorm={gnorm:.3f} "
                      f"({dt * 1e3:.0f}ms)", flush=True)
            if (step + 1) % ckpt_every == 0 and step + 1 < steps:
                t_save = time.time()
                async_save(ckpt_dir, step + 1, (params, opt))
                res.save_s.append(time.time() - t_save)
            if stop["now"]:
                break
        wait_for_save()
        save_checkpoint(ckpt_dir, step + 1, (params, opt))
    finally:
        data.close()
        signal.signal(signal.SIGTERM, previous)
    res.end_step = step + 1
    res.params, res.opt = params, opt
    if res.losses:
        print(f"done at step {step + 1}; final loss {res.losses[-1]:.4f}",
              flush=True)
    return res


def main(argv=None) -> TrainResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--straggler-factor", type=float, default=3.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    cfg = ARCHS[args.arch]
    if args.smoke:
        cfg = reduced(cfg)
    return train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                 ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                 log_every=args.log_every,
                 straggler_factor=args.straggler_factor, device=args.device)


if __name__ == "__main__":
    main()
