"""Time K4's decode form alone on the card, against the plain version and
``scaled_dot_product_attention``, at the decode shapes of the model
paths: gemma3-1b's and the families' served at width.

    PYTHONPATH=src python -m repro_torch.launch.decode_profile \\
        [--cases granite_decode_bf16,decode_full] [--iters 200]

Per case, one JSON line: the split (``decode_split``) and the kernel it
takes (``decode_kernel``, where the revision has it), K4's max abs error
against the plain version, its device ms (the profiler's kernel events,
``kernels/timing.py``) with the ms of each kernel it ran, its
``graph_ms`` (CUDA events around replays of a CUDA graph of 20
back-to-back calls: every kernel and every gap between them), its
``call_ms`` (CUDA events around back-to-back calls, host work included),
the same three for one ``scaled_dot_product_attention`` call on (B, H, 1,
D) copies (GQA by ``enable_gqa``), and the bound: the bytes of q, the
span's K and V and out over 3.35 TB/s.  Operands are random from seed 4,
made on the card; a ``span`` case reads a strided view of a longer cache,
as ``models.layers.decode_attention`` passes it.  The script uses only
``kernels.flash.flash_decode``, ``decode_split``, ``kernels/timing.py`` and,
where the revision has it, ``decode_kernel``, so an earlier revision put
first on ``PYTHONPATH`` (with this revision's ``timing.py`` copied into it)
is timed by the same file: two revisions compare within one run on one
card.  Ends with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from repro_torch.kernels.flash import flash_decode
from repro_torch.kernels.flash.ops import decode_split
try:                        # a revision before the mma kernel has none
    from repro_torch.kernels.flash.ops import decode_kernel
except ImportError:
    decode_kernel = None
from repro_torch.kernels.flash.ref import attention_ref
from repro_torch.kernels.timing import (HBM_BYTES_PER_S, device_events,
                                        graph_ms)

# name: (B, Hkv, g, D, keys, cache slots, dtype): the span is the first
# keys slots of the cache, a strided view when keys < slots
CASES = {
    # granite-moe-3b-a800m's serve path: the last step over 4 x 160 slots,
    # a step over the first 100 (a view), and the f32 check's 2 x 128
    "granite_decode_bf16": (4, 8, 3, 64, 160, 160, "bfloat16"),
    "granite_decode_span_bf16": (4, 8, 3, 64, 100, 160, "bfloat16"),
    "granite_decode_f32": (2, 8, 3, 64, 128, 128, "float32"),
    # gemma3-1b's serve path: a global layer over the prompt's 1024 keys,
    # a local layer's 512-slot window span of the 1056-slot cache, and a
    # short span of 64 keys
    "decode_full": (4, 1, 4, 256, 1024, 1024, "bfloat16"),
    "decode_window_span": (4, 1, 4, 256, 512, 1056, "bfloat16"),
    "decode_short": (4, 1, 4, 256, 64, 1024, "bfloat16"),
    # the dense archs' serve paths (chip_smoke's families phase): the last
    # step over 4 x 160 slots (jamba's attention layer is qwen2-72b's) and
    # a step over the first 100 (a view; serving's steps cover 129-160
    # keys), and gemma-2b over a 1024-token prompt's keys
    "jamba_qwen2_72b_decode": (4, 8, 8, 128, 160, 160, "bfloat16"),
    "command_r_plus_decode": (4, 8, 12, 128, 160, 160, "bfloat16"),
    "qwen2_vl_decode": (4, 4, 7, 128, 160, 160, "bfloat16"),
    "jamba_qwen2_72b_decode_span": (4, 8, 8, 128, 100, 160, "bfloat16"),
    "command_r_plus_decode_span": (4, 8, 12, 128, 100, 160, "bfloat16"),
    "qwen2_vl_decode_span": (4, 4, 7, 128, 100, 160, "bfloat16"),
    "musicgen_decode": (4, 24, 1, 64, 160, 160, "bfloat16"),
    "gemma_2b_decode_160": (4, 1, 8, 256, 160, 160, "bfloat16"),
    "gemma_2b_decode_span": (4, 1, 8, 256, 100, 160, "bfloat16"),
    "gemma_2b_decode": (4, 1, 8, 256, 1024, 1024, "bfloat16"),
}


def operands(name: str, rng):
    B, hkv, g, D, keys, slots, dtype = CASES[name]
    dt = getattr(torch, dtype)

    def randn(shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            "cuda").to(dt)

    q = randn((B, 1, g * hkv, D))
    kc, vc = randn((B, slots, hkv, D)), randn((B, slots, hkv, D))
    return q, kc[:, :keys], vc[:, :keys]


def profile_case(name: str, rng, iters: int) -> dict:
    import torch.nn.functional as F
    q, k, v = operands(name, rng)
    B, _, H, D = q.shape
    keys, hkv = k.shape[1], k.shape[2]
    run = lambda: flash_decode(q, k, v)                     # noqa: E731
    err = float((run().float() - attention_ref(q, k, v, causal=False))
                .abs().max())
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib = lambda: F.scaled_dot_product_attention(           # noqa: E731
        qt, kt, vt, enable_gqa=True)
    out = {"case": name, "B": B, "H": H, "Hkv": hkv, "g": H // hkv, "D": D,
           "keys": keys, "dtype": str(q.dtype).split(".")[-1],
           "contiguous_span": k.is_contiguous(),
           "split": dict(zip(("kc", "nsplit"), decode_split(keys, B * hkv))),
           "max_abs_err": err}
    out["kernel"] = decode_kernel and decode_kernel(
        q.dtype, H // hkv, out["split"]["nsplit"])
    for key, fn in (("", run), ("library_", lib)):
        ms, by_name = device_events(fn, iters, whole_calls=True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        fn()
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        out.update({f"{key}ms": ms, f"{key}graph_ms": graph_ms(fn),
                    f"{key}call_ms": start.elapsed_time(end) / iters,
                    f"{key}kernels": {n[:90]: t for n, t in by_name.items()}})
    nbytes = q.element_size() * (2 * B * H * D + 2 * B * keys * hkv * D)
    out.update({"bytes": nbytes,
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                "merge_kernel": any("merge" in n for n in out["kernels"])})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("decode_profile: needs a CUDA card")
    rng = np.random.RandomState(4)
    for name in args.cases.split(","):
        print(json.dumps(profile_case(name, rng, args.iters)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
