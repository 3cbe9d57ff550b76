"""The reference's shape cells (``configs.SHAPES``) run on one card: an
arch's ``prefill_fn``, ``decode_fn`` or train step at the cell's own
sequence length, at the largest batch up to the reference's that the
card holds.

    PYTHONPATH=src python -m repro_torch.launch.cells --arch gemma3-1b \\
        --shape decode_32k [--batch 64] [--window-cache] [--seed 0]
    PYTHONPATH=src python -m repro_torch.launch.cells --arch gemma3-1b \\
        --shape prefill_32k --device cpu --smoke

A cell is the reference's dry-run cell made real (``launch/dryrun.py``
lowers the same three functions at the same shapes):

  prefill  ``build_forward(cfg)[1]`` on (B, seq) tokens, or frames, drawn
           from ``--seed`` as ``launch.serve.make_prompt`` draws them;
  decode   ``decode_fn`` at ``index = seq - 1`` and the ``STEPS - 1``
           steps after it, over a cache of ``seq + STEPS - 1`` slots
           (``window_cache``: the local layers' rolling caches of
           ``window`` slots) whose every slot holds K and V, or SSM and
           conv state, drawn from a ``torch.Generator`` seeded by
           ``--seed`` (``seeded_cache``): the dry run's cache at that
           length, filled without feeding the sequence through
           ``decode_fn`` one position at a time;
  train    ``train.build_train_step`` (``launch/train``'s step: AdamW, in
           place) on (B, seq) tokens of the data stream's first batch.

Weights are drawn on the device from ``--seed`` (``models.model.
draw_params``).  ``long_500k`` runs only for ``LONG_CONTEXT_ARCHS``, as
the dry run skips it.  A batch is never cut quietly: an allocation that
fails on the card raises ``MemoryError`` with the cell's bytes reckoned
(``reckon``: weights, AdamW's state and gradients, the cache, and
transients a token).  Without ``--device cpu`` the cell runs on the card
and raises if there is none; ``--smoke`` takes the reduced config at
``SMOKE_SEQ`` tokens and a batch of 2 (listed under ``reduced``).

Each cell prints one JSON line: arch, shape, kind, seq, the batch and the
reference's, ``reduced`` (each cut), host ms (a prefill or a train step:
the host clock around its one call, under the profiler, that ends in a
synchronize; a decode step: around ``STEPS`` steps after one profiled
step that warms them), device ms (the profiled call's device events,
``kernels/timing.py``), tokens/s, ``max_memory_allocated`` in GB beside
the reckoning, K4's launches from its counters over the timed call(s), by
form and by form and shape (``flash.ops.shape_launches``), and K4's
forms whose kernels the profiler saw in the profiled call.
"""
from __future__ import annotations

import argparse
import json
import math
import time
from typing import Optional

import numpy as np
import torch

from ..configs import ARCHS, LONG_CONTEXT_ARCHS, SHAPES, reduced
from ..core.lowering import resolve_device
from ..kernels import registry
from ..kernels.flash.ops import FORMS, form_launches, kernel_form, \
    shape_launches
from ..kernels.flash.ref import attention_ref
from ..models import build_forward
from ..models.config import ModelConfig
from ..models.model import (DTYPES, cache_specs, draw_params, param_specs,
                            tree_leaves, zero_cache)

STEPS = 4               # decode steps a cell: index seq - 1 and 3 after it
# a K4 output held against the plain version's within this share of the
# plain version's largest magnitude on the rows held, as well as within
# the type's absolute tolerance: at long spans the outputs (a softmax
# average of unit normals over n keys spreads about sqrt(e / n)) fall
# below bf16's 3e-2
K4_REL = 1e-2
SMOKE_SEQ, SMOKE_BATCH = 64, 2
_ITEMSIZE = {"bfloat16": 2, "float32": 4}     # bytes by a spec's dtype


def spec_bytes(tree) -> int:
    """The bytes of a spec tree's leaves (``P`` of param_specs or
    cache_specs)."""
    return sum(math.prod(p.shape) * _ITEMSIZE[p.dtype]
               for p in tree_leaves(tree))


def cache_bytes(cfg: ModelConfig, batch: int, seq: int) -> int:
    """The bytes of ``batch`` decode caches of ``seq`` slots
    (``cache_specs``; a rolling window cache where ``cfg.window_cache``)."""
    return spec_bytes(cache_specs(cfg, batch, seq))


def _layer_transients(cfg: ModelConfig, i: int) -> int:
    """Bytes a token that layer i's forward holds at once beyond the
    residual stream: an attention layer's q, k, v and out and its MLP's
    gate, up, activation and product (d_ff wide, or the top-k experts'
    for an MoE layer); a Mamba2 layer's in_proj output, its conv output
    before and after the SiLU, and the SSD scan's f32 blocks a token (the
    (chunk x heads) decay, mask, exp and scores) with B and C repeated
    over the heads, in f32 and in the activation type."""
    act = _ITEMSIZE[cfg.dtype]
    ff = cfg.d_ff * (cfg.moe_top_k if cfg.layer_is_moe(i) else 1)
    mlp = 4 * ff * act
    if cfg.layer_kind(i) == "attn":
        heads = cfg.n_heads + 2 * cfg.n_kv_heads
        return (2 * heads * cfg.hd + 2 * cfg.d_model) * act + mlp
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv = di + 2 * N
    ssd = 4 * cfg.ssm_chunk * H * 4 + 2 * H * N * (act + 4)
    return (2 * di + 2 * N + H + 2 * conv) * act + ssd + (
        mlp if cfg.d_ff else 0)


def reckon(cfg: ModelConfig, kind: str, batch: int, seq: int) -> dict:
    """The bytes a cell needs on the device, by part: the weights, for a
    train step the gradients (the weights' type) and AdamW's two f32
    moments, for decode the cache of ``seq + STEPS - 1`` slots, and the
    transients: a forward's widest layer a token, times the tokens (a
    train step runs one period's forward again in its backward and keeps
    each layer's input and its gradient: a period's layers, plus the
    residual stream twice a layer).  An estimate: on an H100 it came
    within 5-26 % of ``max_memory_allocated`` (PERF.md §5)."""
    act = _ITEMSIZE[cfg.dtype]
    weights = spec_bytes(param_specs(cfg))
    n_params = sum(math.prod(p.shape) for p in tree_leaves(param_specs(cfg)))
    out = {"weights": weights, "optimizer": 0, "cache": 0, "transients": 0}
    widest = max(_layer_transients(cfg, i) for i in range(cfg.n_layers))
    if kind == "decode":
        out["cache"] = cache_bytes(cfg, batch, seq + STEPS - 1)
        out["transients"] = batch * widest
    elif kind == "prefill":
        out["transients"] = batch * seq * (widest + 2 * cfg.d_model * act)
    else:
        out["optimizer"] = weights + 8 * n_params
        period = cfg.period if cfg.remat else cfg.n_layers
        out["transients"] = batch * seq * (
            period * widest + 2 * cfg.n_layers * cfg.d_model * act)
    out["total"] = sum(out.values())
    return out


def k4_limit(want, atol: float, rel: float = K4_REL) -> float:
    """The largest abs difference a K4 output may have from the plain
    version's ``want`` on the rows it is held on: ``atol``, or ``rel`` of
    ``want``'s largest magnitude where that is smaller."""
    return min(atol, rel * float(want.abs().max()))


def plain_rows(q, k, v, lo: int, hi: int, *, causal: bool, window=None,
               scale=None):
    """The plain version's (``attention_ref``) output rows [lo, hi) of a
    prefill whose query row i sits at key position i, computed on those
    rows alone: q's rows at their offset (``q_offset``) against the keys
    their bands meet, so that no (Sq x Skv) score matrix is made."""
    k0 = 0 if window is None else max(0, lo - window + 1)
    k1 = hi if causal else k.shape[1]
    return attention_ref(q[:, lo:hi], k[:, k0:k1], v[:, k0:k1],
                         causal=causal, window=window, scale=scale,
                         q_offset=lo - k0)


def seeded_cache(cfg: ModelConfig, batch: int, slots: int, seed: int,
                 device="cuda"):
    """A decode cache of ``slots`` slots (``zero_cache``'s layout) whose
    every entry, K and V or the SSM and conv state, is normal(0, 1) from
    a ``torch.Generator`` on ``device`` seeded by ``seed``, leaf by leaf in
    tree order, a stacked leaf one period at a time."""
    device = resolve_device(device)
    cache = zero_cache(cfg, batch, slots, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    for leaf in tree_leaves(cache):
        for part in (leaf.unbind(0) if leaf.dim() == 5 else (leaf,)):
            part.normal_(0.0, 1.0, generator=gen)
    return cache


def _inputs(cfg: ModelConfig, batch: int, seq: int, seed: int, device):
    """(B, seq) tokens, or frames in the activation type, and the
    positions (M-RoPE's (3, B, seq)), drawn as make_prompt draws them."""
    from .serve import make_prompt
    prompt = make_prompt(cfg, batch, seq, seed)
    x = torch.from_numpy(np.ascontiguousarray(prompt.tokens))
    if cfg.input_mode != "tokens":
        x = x.to(DTYPES[cfg.dtype])
    lead = (3, batch) if cfg.mrope_sections else (batch,)
    return {"tokens": x.to(device), "positions": torch.arange(
        seq, dtype=torch.int32, device=device).expand(*lead, seq)}


def _synced(device, fn):
    """fn() and its host ms, the device synchronized before and after."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, (time.perf_counter() - t0) * 1e3


def _release(device) -> None:
    """The caching allocator's free blocks returned to the card between a
    cell's calls: a call's tensors of gigabytes, freed in pieces, would
    otherwise leave the next call's largest one no block to fit (seen on
    an H100: 22.8 GB reserved and free, a 13.5 GiB request refused)."""
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _profiled(device, fn):
    """fn() once, under the profiler on the card: (its result, its host
    ms by ``_synced``, its device ms, and K4's forms whose kernels the
    profiler saw, ``flash.ops.kernel_form``; on the CPU neither of the
    last two is measured)."""
    if device.type != "cuda":
        out, ms = _synced(device, fn)
        return out, {"host_ms": ms, "device_ms": None, "k4_kernels": None}
    from ..kernels.timing import device_events
    calls = []
    dev_ms, by_name = device_events(
        lambda: calls.append(_synced(device, fn)), 1, warmup=0)
    out, ms = calls[-1]
    return out, {"host_ms": ms, "device_ms": dev_ms, "k4_kernels": sorted(
        {f for f in map(kernel_form, by_name) if f})}


def k4_counts() -> dict:
    """K4's launches since the counters were set to 0: by form, and by
    form and shape as [form, B, Sq, Skv, H, Hkv, window, causal, n]."""
    return {"k4_launches": form_launches(), "k4_shapes": [
        [f, *shape, n] for f in FORMS
        for shape, n in sorted(shape_launches(f).items(),
                               key=lambda kv: str(kv[0]))]}


def run_cell(arch: str, shape: str, batch: Optional[int] = None, *,
             window_cache: bool = False, seed: int = 0, device="cuda",
             smoke: bool = False) -> dict:
    """One cell on ``device``: the line described in the module's doc,
    returned (and not printed)."""
    if shape not in SHAPES:
        raise ValueError(f"no shape {shape!r}; the cells are "
                         f"{sorted(SHAPES)}")
    if shape == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
        raise ValueError(f"{arch} x long_500k is not a cell: long_500k runs "
                         f"only for {sorted(LONG_CONTEXT_ARCHS)}")
    device = resolve_device(device)
    seq, ref_batch, kind = SHAPES[shape]
    cfg = ARCHS[arch].replace(window_cache=window_cache)
    cuts = {}
    if smoke:
        cfg = reduced(cfg)
        cuts.update(config="reduced", seq=[seq, SMOKE_SEQ])
        seq = SMOKE_SEQ
        batch = SMOKE_BATCH if batch is None else batch
    batch = ref_batch if batch is None else batch
    if batch < ref_batch:
        cuts["batch"] = [ref_batch, batch]
    need = reckon(cfg, kind, batch, seq)
    line = {"arch": arch, "shape": shape, "kind": kind, "seq": seq,
            "batch": batch, "ref_batch": ref_batch, "reduced": cuts,
            "window_cache": window_cache, "n_layers": cfg.n_layers,
            "seed": seed, "device": str(device),
            "reckoned_gb": {k: v / 1e9 for k, v in need.items()}}
    if device.type == "cuda":
        line["device_name"] = torch.cuda.get_device_name(device)
        torch.cuda.reset_peak_memory_stats(device)
    try:
        line.update(_run(cfg, kind, batch, seq, seed, device))
    except torch.cuda.OutOfMemoryError as e:
        raise MemoryError(f"{arch} x {shape} at batch {batch} did not fit: "
                          f"reckoned {need['total'] / 1e9:.2f} GB "
                          f"({e})") from e
    if device.type == "cuda":
        line["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    return line


def _run(cfg, kind, batch, seq, seed, device) -> dict:
    """The cell's calls, K4's counters set to 0 just before the timed
    ones: weights drawn, then a prefill's or a train step's one profiled
    call, or a profiled decode step and the STEPS timed ones."""
    t0 = time.perf_counter()
    params = draw_params(cfg, seed, device)
    out = {"init_s": time.perf_counter() - t0}
    _, prefill_fn, decode_fn = build_forward(cfg)
    steps = STEPS
    with torch.no_grad():
        if kind == "prefill":
            inp = _inputs(cfg, batch, seq, seed, device)
            registry.reset_launch_counts()
            logits, prof = _profiled(device, lambda: prefill_fn(params, inp))
            out.update(prof, **k4_counts(),
                       tokens_per_s=batch * seq / prof["host_ms"] * 1e3)
            _finite(logits, (batch, 1, cfg.padded_vocab))
        elif kind == "decode":
            t0 = time.perf_counter()
            cache = seeded_cache(cfg, batch, seq + steps - 1, seed, device)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            out["cache_s"] = time.perf_counter() - t0
            out["cache_gb"] = cache_bytes(cfg, batch, seq + steps - 1) / 1e9
            toks = _inputs(cfg, batch, steps, seed, device)["tokens"]
            lead = (3, batch) if cfg.mrope_sections else (batch,)

            def step(i):
                pos = torch.full((*lead, 1), i, dtype=torch.int32,
                                 device=device)
                return decode_fn(params, cache, {
                    "tokens": toks[:, i - seq + 1:i - seq + 2],
                    "positions": pos}, index=i)[0]
            prof = _profiled(device, lambda: step(seq - 1))[1]
            out.update(device_ms=prof["device_ms"],
                       k4_kernels=prof["k4_kernels"])
            _release(device)
            registry.reset_launch_counts()
            logits, ms = _synced(device, lambda: [
                step(i) for i in range(seq - 1, seq - 1 + steps)][-1])
            out.update(k4_counts(), steps=steps, first_index=seq - 1,
                       host_ms=ms / steps,
                       tokens_per_s=batch * steps / ms * 1e3)
            _finite(logits, (batch, 1, cfg.padded_vocab))
        else:
            out.update(_train(cfg, batch, seq, seed, device, params))
    return out


def _train(cfg, batch, seq, seed, device, params):
    from ..data.pipeline import DataConfig, _batch_at
    from ..optim import adamw_init
    from ..train import build_train_step
    dcfg = DataConfig(seq, batch, cfg.vocab, seed=seed,
                      input_mode=cfg.input_mode, d_model=cfg.d_model)
    b = {k: torch.from_numpy(v).to(device)
         for k, v in _batch_at(dcfg, 0, 0, batch).items()}
    if cfg.mrope_sections:
        b["positions"] = torch.arange(seq, dtype=torch.int32,
                                      device=device).expand(3, batch, seq)
    opt = adamw_init(params)
    step = build_train_step(cfg)
    with torch.enable_grad():
        registry.reset_launch_counts()
        (_, _, metrics), out = _profiled(device,
                                         lambda: step(params, opt, b))
    out.update(k4_counts())
    loss, gnorm = float(metrics["loss"]), float(metrics["gnorm"])
    if not (math.isfinite(loss) and math.isfinite(gnorm)):
        raise AssertionError(f"train step: loss {loss}, gradient norm "
                             f"{gnorm}")
    out.update(tokens_per_s=batch * seq / out["host_ms"] * 1e3, loss=loss,
               gnorm=gnorm)
    return out


def _finite(logits, shape) -> None:
    if tuple(logits.shape) != shape or not bool(
            torch.isfinite(logits.float()).all()):
        raise AssertionError(f"logits of shape {tuple(logits.shape)}, want "
                             f"{shape}, or not finite")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--shape", required=True, choices=sorted(SHAPES))
    ap.add_argument("--batch", type=int, default=None,
                    help="the reference's global batch unless given")
    ap.add_argument("--window-cache", action="store_true",
                    help="rolling window caches for the local layers")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help=f"the reduced config at {SMOKE_SEQ} tokens")
    args = ap.parse_args(argv)
    if args.shape == "long_500k" and args.arch not in LONG_CONTEXT_ARCHS:
        print(f"SKIP {args.arch} x long_500k (full attention)")
        return None
    torch.backends.cuda.matmul.allow_tf32 = False
    line = run_cell(args.arch, args.shape, args.batch,
                    window_cache=args.window_cache, seed=args.seed,
                    device=args.device, smoke=args.smoke)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
