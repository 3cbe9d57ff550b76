"""Time one model's prefill on the card: the wall of a ``prefill_fn``
call, where one call's device time goes, and K4's prefill alone at the
model's local and global layer shapes.

    PYTHONPATH=src python -m repro_torch.launch.prefill_profile \\
        [--arch gemma3-1b[,musicgen-medium,...]] [--batch 4] \\
        [--prompt-len 1024] [--calls 5] [--dtype bfloat16|float32] \\
        [--k4-only] [--lse] [--padded] [--iters 50]

The model runs in ``--dtype`` (bfloat16 by default: K4's tensor-core
forms, the wgmma form where Dk = Dv; float32 takes its SIMT form) with
the random weights of ``init_params`` (seed 0).  ``--k4-only`` times K4
alone and skips the model; ``--lse`` times K4 with its row log-sum-exp
(the training path's call).  Per layer shape, K4's line gives what
``decode_profile.py`` gives for decode: its max abs error against the
plain version (and the lse's), its device ms (the profiler's kernel
events) with each kernel's, its ``graph_ms`` (CUDA events around replays
of a CUDA graph of 20 back-to-back calls), its device ms with 256 MB
written before each call (``cold_ms``: the L2 holds none of the
operands, as in a model, where other kernels run between two layers' K4
calls; the model hands K4 contiguous (B, S, H, D) q, k and v),
``scaled_dot_product_attention``'s device and graph ms on (B, H, S, D)
copies of the same operands (GQA by ``enable_gqa``, a window as a
boolean band mask), and the bound (``kernels.timing.bound_ms``): the
larger of q, k, v and out's bytes over the memory rate and 2 (Dk + Dv)
flops a (q, k) pair in the band over the type's peak.  A kernel's device
ms is the mean of its recorded events times its launches a call
(``device_events``' ``whole_calls``: the profiler can lose records).
An MLA model's K4 takes q, k at dn + dr and v at dv, the scale 1/sqrt(dn
+ dr); ``--padded`` zero-pads all three to 256 (the form before K4 took
Dv != Dk, so an older revision can be timed at the same shape).  The
script uses only the package's public model API (``init_params``,
``build_forward``, ``kernels.flash.flash_attention``,
``kernels.flash.ref.attention_ref``, ``kernels.flash.ops.attention_pairs``)
and ``kernels/timing.py``, so the same file can time an earlier revision
of the package put first on ``PYTHONPATH``, with this revision's
``timing.py`` copied into it: two revisions compare within one run on
one card.  ``--arch`` takes a comma-separated list, run one after
another in one process.  Prints one JSON line an arch, then the card's
name and power limit.
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
from repro_torch.kernels.flash.ops import attention_pairs
from repro_torch.kernels.flash.ref import attention_ref
from repro_torch.kernels.timing import bound_ms, device_events, graph_ms
from repro_torch.launch.serve import make_prompt
from repro_torch.models import build_forward, init_params

# bytes written between calls for the cold reading: five times the H100's
# 50 MB L2
L2_FLUSH_BYTES = 256 << 20


def k4_case(q, k, v, window, scale, lse: bool, iters: int) -> dict:
    """K4 at one layer's shape against the plain version, its device and
    graph ms, its device ms with the L2 flushed before each call (a model
    runs other kernels between its layers' K4 calls), scaled_dot_product_
    attention's on the same operands and the bound."""
    import torch.nn.functional as F
    B, S, H, dk = q.shape
    hkv, dv = k.shape[2], v.shape[3]
    kw = {"return_lse": True} if lse else {}
    run = lambda: flash_attention(q, k, v, causal=True,       # noqa: E731
                                  window=window, scale=scale, **kw)
    got = run()
    want = attention_ref(q, k, v, causal=True, window=window, scale=scale,
                         return_lse=lse)
    out = {}
    if lse:
        (got, got_lse), (want, want_lse) = got, want
        out["lse_max_abs_err"] = float((got_lse - want_lse).abs().max())
    out["max_abs_err"] = float((got.float() - want).abs().max())
    ms, by_name = device_events(run, iters, warmup=1, whole_calls=True)
    out.update({"ms": ms, "kernels": {n[:90]: t for n, t in by_name.items()},
                "graph_ms": graph_ms(run)})
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=q.device)
    cold = device_events(lambda: (flush.zero_(), run()), iters, warmup=1,
                         whole_calls=True)[1]
    out["cold_ms"] = sum(t for n, t in cold.items() if "flash_" in n)
    del flush
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    mask = None
    if window:
        i = torch.arange(S, device=q.device)[:, None]
        j = torch.arange(S, device=q.device)[None]
        mask = (j <= i) & (j > i - window)
    lib = lambda: F.scaled_dot_product_attention(             # noqa: E731
        qt, kt, vt, attn_mask=mask, is_causal=mask is None, scale=scale,
        enable_gqa=True)
    out.update({"library_ms": device_events(lib, iters, warmup=1,
                                            whole_calls=True)[0],
                "library_graph_ms": graph_ms(lib)})
    nbytes = q.element_size() * (B * S * H * (dk + dv)
                                 + B * S * hkv * (dk + dv))
    if lse:
        nbytes += 4 * B * H * S
    flops = 2 * (dk + dv) * B * H * attention_pairs(S, S, True, window)
    out.update({"bytes": nbytes, "flops": flops})
    out["bound_ms"], out["bound_by"] = bound_ms(nbytes, flops, q.dtype)[:2]
    out["share_of_bound"] = out["bound_ms"] / ms
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gemma3-1b",
                    help="an arch of configs.ARCHS, or several, comma-"
                         "separated")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=1024)
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--k4-only", action="store_true")
    ap.add_argument("--lse", action="store_true")
    ap.add_argument("--padded", action="store_true")
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    archs = args.arch.split(",")
    unknown = sorted(set(archs) - set(ARCHS))
    if unknown:
        ap.error(f"unknown arch {unknown}: choose from {sorted(ARCHS)}")
    if not torch.cuda.is_available():
        raise SystemExit("prefill_profile: needs a CUDA card")
    for arch in archs:
        print(json.dumps(profile(args, arch)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return 0


def profile(args, arch: str) -> dict:
    """One arch's line: K4 alone at its layer shapes and, without
    ``--k4-only``, its ``prefill_fn``."""
    cfg = ARCHS[arch].replace(dtype=args.dtype)
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
    out["lse"] = args.lse
    layers = (("local", cfg.sliding_window), ("global", None)) \
        if cfg.sliding_window else (("global", None),)
    for layer, window in layers:
        case = k4_case(q, k, v, window, dk ** -0.5, args.lse, args.iters)
        out[f"k4_{layer}_ms"] = case["ms"]
        out[f"k4_{layer}_kernels"] = sorted(case["kernels"])
        out[f"k4_{layer}"] = case
    del q, k, v
    if args.k4_only:
        return out

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
    del params
    torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    raise SystemExit(main())
