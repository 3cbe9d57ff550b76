"""Time one model's prefill on the card: the wall of a ``prefill_fn``
call, where one call's device time goes, and K4's prefill alone at the
model's local and global layer shapes.

    PYTHONPATH=src python -m repro_torch.launch.prefill_profile \\
        [--arch gemma3-1b] [--batch 4] [--prompt-len 1024] [--calls 5] \\
        [--dtype bfloat16|float32] [--k4-only] [--lse] [--padded]

The model runs in ``--dtype`` (bfloat16 by default: K4's tensor-core form;
float32 takes its SIMT form) with the random weights of ``init_params``
(seed 0).  ``--k4-only`` times K4 alone and skips the model; ``--lse``
times K4 with its row log-sum-exp (the training path's call).  An MLA
model's K4 takes q, k at dn + dr and v at dv, the scale 1/sqrt(dn + dr);
``--padded`` zero-pads all three to 256 (the form before K4 took
Dv != Dk, so an older revision can be timed at the same shape).  The
script uses only the package's public model API (``init_params``, ``build_forward``,
``kernels.flash.flash_attention``) and the profiler, so the same file can
time an earlier revision of the package put first on ``PYTHONPATH``: two
revisions compare within one run on one card (a revision older than
``kernels/timing.py`` needs that file copied into it first).  Prints one
JSON line, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS
from repro_torch.kernels.flash import flash_attention
from repro_torch.kernels.timing import device_events
from repro_torch.launch.serve import make_prompt
from repro_torch.models import build_forward, init_params


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gemma3-1b", choices=sorted(ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=1024)
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--k4-only", action="store_true")
    ap.add_argument("--lse", action="store_true")
    ap.add_argument("--padded", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("prefill_profile: needs a CUDA card")
    cfg = ARCHS[args.arch].replace(dtype=args.dtype)
    B, S = args.batch, args.prompt_len
    out = {"arch": cfg.name, "dtype": cfg.dtype, "batch": B, "prompt": S}

    # K4 alone at the model's layer shapes (random q, k, v from seed 4)
    rng = np.random.RandomState(4)
    dtype = getattr(torch, cfg.dtype)
    if cfg.mla:
        dk, dv = cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
        heads = (cfg.n_heads,) * 3
    else:
        dk = dv = cfg.hd
        heads = (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads)
    q, k, v = (torch.from_numpy(rng.randn(B, S, h, d).astype(
        np.float32)).cuda().to(dtype)
        for h, d in zip(heads, (dk, dk, dv)))
    if args.padded:
        q, k, v = (torch.nn.functional.pad(t, (0, 256 - t.shape[-1]))
                   for t in (q, k, v))
    out["k4_shapes"] = [list(t.shape) for t in (q, k, v)]
    layers = (("local", cfg.sliding_window), ("global", None)) \
        if cfg.sliding_window else (("global", None),)
    for layer, window in layers:
        events = device_events(lambda: flash_attention(
            q, k, v, causal=True, window=window, scale=dk ** -0.5,
            **({"return_lse": True} if args.lse else {})), 50,
            warmup=1)[1]
        out[f"k4_{layer}_ms"] = sum(events.values())
        out[f"k4_{layer}_kernels"] = sorted(events)
    del q, k, v
    if args.k4_only:
        return _report(out)

    # the model: wall of warm calls (host clock), then one profiled call
    t0 = time.perf_counter()
    params = init_params(cfg, 0, "cuda")
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    # [-2]: prefill_fn of the triple, and of an older revision's pair
    prefill_fn = build_forward(cfg)[-2]
    toks = torch.from_numpy(make_prompt(cfg, B, S).tokens).cuda()
    with torch.no_grad():
        prefill_fn(params, {"tokens": toks})
        walls = []
        for _ in range(args.calls):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prefill_fn(params, {"tokens": toks})
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        events = device_events(lambda: prefill_fn(params, {"tokens": toks}),
                               1, warmup=1)[1]
    device_ms = sum(events.values())
    top = sorted(events.items(), key=lambda kv: -kv[1])
    out.update({
        "wall_ms": statistics.median(walls), "wall_ms_all": walls,
        "device_ms": device_ms,
        "k4_device_ms": sum(ms for name, ms in events.items()
                            if "flash_" in name),
        "top": [{"name": name[:80], "ms": ms} for name, ms in top[:8]]})
    return _report(out)


def _report(out: dict) -> int:
    print(json.dumps(out), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
