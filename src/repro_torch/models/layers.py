"""Model layers: norms, RoPE / M-RoPE, attention (prefill through K4 or
the naive oracle; under a gradient K4 with its log-sum-exp and the
reference's block-recompute backward; decode through K4 over the valid
span of a KV cache), the attention block, MLA (DeepSeek-V2: prefill
through K4 at a padded head dim, absorbed decode over the latent cache),
the gated MLP, the dropping top-k MoE, and the Mamba2 mixer (causal conv
and the chunked SSD scan).

The counterpart of ``repro.models.layers``.  Parameters are plain dicts
of tensors.  Unlike the reference, a decode step writes
its cache (KV, latent, conv window, SSM state) in place.  ``norm_dist``
(the norm over a feature axis split over a mesh axis) runs on a
``DeviceMesh`` through ``parallel.spmd.shard_map``.
"""
from __future__ import annotations

import math
import sys
from typing import Any, Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels._checks import ATTENTION_HEAD_DIMS
from ..kernels.flash import flash_attention, flash_decode
from ..kernels.flash.ref import MASK_VALUE

# an activation layout hook (parallel.ShardingMapper.shard on a mesh)
Shard = Callable[[Any, Tuple[Optional[str], ...]], Any]


def _noshard(x, axes):
    return x


# --------------------------------------------------------------------------
# norms (the gain is 1 + scale, as in the reference)


def rms_norm(x, scale, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x, scale, eps=1e-6):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def norm(x, scale, cfg):
    f = layer_norm if cfg.use_layernorm else rms_norm
    return f(x, scale, cfg.norm_eps)


def norm_dist(x, scale, cfg, mesh, axis: str = "model"):
    """Distributed norm over a model-sharded feature axis: each rank holds
    D/n features, and the row statistics come from per-shard partial sums
    all-reduced over ``axis``'s process group (bytes: O(B*S) scalars
    instead of an f32 full-residual all-gather).  x (B, S, D), a DTensor
    or the global value; differentiable (the all-reduce's backward
    all-reduces)."""
    from ..parallel.mapper import PartitionSpec as P
    from ..parallel.spmd import batch_axes, psum, shard_map

    D = x.shape[-1]
    group = mesh.get_group(axis)
    use_ln = cfg.use_layernorm
    eps = cfg.norm_eps

    def local(xl, sl):
        xf = xl.float()
        if use_ln:
            mu = psum(xf.sum(-1, keepdim=True), group) / D
            var = psum((xf - mu).square().sum(-1, keepdim=True), group) / D
            y = (xf - mu) * torch.rsqrt(var + eps)
        else:
            var = psum(xf.square().sum(-1, keepdim=True), group) / D
            y = xf * torch.rsqrt(var + eps)
        return (y * (1.0 + sl.float())).to(xl.dtype)

    spec = P(batch_axes(mesh), None, axis)
    return shard_map(local, mesh, (spec, P(axis)), spec)(x, scale)


# --------------------------------------------------------------------------
# RoPE


def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float,
               mrope_sections: Optional[Tuple[int, int, int]] = None):
    """x: (B, S, H, D). positions: (B, S) or (3, B, S) for M-RoPE.  The
    rotation pairs element i with element i + D/2 (halves, not
    interleaved)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                 # (d/2,)
    if mrope_sections is None:
        ang = positions[..., None].float() * freqs         # (B, S, d/2)
    else:
        # Qwen2-VL M-RoPE: the d/2 frequency slots are split into
        # (temporal, height, width) sections, each driven by its own
        # position stream.
        if sum(mrope_sections) != d // 2:
            raise ValueError(f"M-RoPE sections {mrope_sections} do not sum "
                             f"to head_dim / 2 = {d // 2}")
        parts, off = [], 0
        for i, s in enumerate(mrope_sections):
            parts.append(positions[i][..., None].float()
                         * freqs[off:off + s])
            off += s
        ang = torch.cat(parts, dim=-1)                     # (B, S, d/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention


def naive_attention(q, k, v, *, causal, window=None, q_offset=0):
    """Reference O(S^2)-memory attention (``attn_impl="naive"``): f32
    scores, a full softmax, p cast to v's type before p . v."""
    B, Sq, H, D = q.shape
    _, Skv, Hkv, Dv = v.shape
    G = H // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / math.sqrt(D)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Skv, device=q.device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    s = torch.where(mask, s, torch.full((), MASK_VALUE, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), v.float())
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dv).to(q.dtype)


# attention under a gradient: K4's prefill with the row log-sum-exp as the
# forward, and the reference's block-recompute backward
# (repro.models.layers._flash_bwd) in plain PyTorch.  Residuals are O(S*D)
# (q, k, v, out, lse), never the S x S softmax.


def flash_attention_bwd(q, k, v, out, lse, do, *, causal: bool, window,
                        scale: float, block_kv: int, q_offset: int = 0):
    """dq, dk, dv of softmax(q k^T * scale + mask) v, over key blocks of
    ``block_kv``: each block's scores recomputed in f32, p = exp(s - lse),
    dv = p^T do, dp = do v^T, ds = p (dp - dsum) scale with dsum =
    sum(do * out), dq accumulated in f32, dk = ds^T q.  GQA sums dk and dv
    over the g query heads of a kv head.  lse is (B, H, Sq), f32; query i
    sits at position i + ``q_offset`` for the masks.  Returns the three in
    q's dtype."""
    B, Sq, H, D = q.shape
    _, Skv, Hkv, Dv = v.shape
    G = H // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    dog = do.reshape(B, Sq, Hkv, G, Dv).float()
    og = out.reshape(B, Sq, Hkv, G, Dv).float()
    dsum = (dog * og).sum(-1).permute(0, 2, 3, 1)          # (B,Hkv,G,Sq)
    lse = lse.reshape(B, Hkv, G, Sq)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    dq = torch.zeros((B, Sq, Hkv, G, D), dtype=torch.float32,
                     device=q.device)
    dk = torch.empty((B, Skv, Hkv, D), dtype=torch.float32, device=q.device)
    dv = torch.empty((B, Skv, Hkv, Dv), dtype=torch.float32, device=q.device)
    for j0 in range(0, Skv, block_kv):
        j1 = min(j0 + block_kv, Skv)
        kblk = k[:, j0:j1].float()
        vblk = v[:, j0:j1].float()
        k_pos = torch.arange(j0, j1, device=q.device)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kblk) * scale
        mask = torch.ones((Sq, j1 - j0), dtype=torch.bool, device=q.device)
        if causal:
            mask &= k_pos[None, :] <= q_pos[:, None]
        if window is not None:
            mask &= k_pos[None, :] > q_pos[:, None] - window
        s = s + torch.where(mask, 0.0, MASK_VALUE)
        p = torch.exp(s - lse[..., None])                   # (B,Hkv,G,Sq,K)
        dv[:, j0:j1] = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
        dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, vblk)
        ds = p * (dp - dsum[..., None]) * scale
        dq += torch.einsum("bhgqk,bkhd->bqhgd", ds, kblk)
        dk[:, j0:j1] = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg)
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(q.dtype),
            dv.to(q.dtype))


class FlashAttention(torch.autograd.Function):
    """K4 (``flash_attention(..., return_lse=True)``; its plain version on
    the CPU) under a gradient: the counterpart of the reference's
    ``custom_vjp`` ``flash_attention``.  It saves (q, k, v, out, lse), and
    its backward is ``flash_attention_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, block_kv, q_offset=0):
        out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale, return_lse=True,
                                   q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window,
                    1.0 / math.sqrt(q.shape[-1]) if scale is None else scale,
                    block_kv, q_offset)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, scale, block_kv, q_offset = ctx.args
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do,
                                         causal=causal, window=window,
                                         scale=scale, block_kv=block_kv,
                                         q_offset=q_offset)
        return dq, dk, dv, None, None, None, None, None


def prefill_attention(q, k, v, cfg, *, window=None, scale=None,
                      q_offset: int = 0):
    """K4's prefill (``attn_impl="blocked"``): through ``FlashAttention``
    when grad mode is on and an operand requires grad, else the plain call
    that serving makes.  Query i sits at position i + ``q_offset``."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, True, window, scale,
                                    cfg.attn_block_kv, q_offset)
    return flash_attention(q, k, v, causal=True, window=window, scale=scale,
                           q_offset=q_offset)


# attention over a DeviceMesh: q, k, v DTensors.  Each rank attends on its
# shard (a per-rank body, as the reference's Pallas kernel runs per device):
# the batch as q splits it, q's heads where they are split (k and v split
# with them where the kv heads divide the axis, else gathered and sliced to
# the kv heads the rank's query heads read), or q's sequence (context
# parallel: k and v gathered and cut to the span the rank's rows see, the
# rows at their offset in it).


def _on_mesh(attend, q, k, v, window=None):
    """Causal ``attend(q, k, v, q_offset)`` on each rank's shard of the
    DTensors q (B, Sq, H, D), k and v (B, Skv, Hkv, D); query row i of
    the shard sits at key position i + ``q_offset`` of the keys it is
    given, which are cut to the band (``window``) the rows see.  Returns
    the output as a DTensor placed as q's shard is."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = q.device_mesh
    coord = mesh.get_coordinate()
    H, Hkv = q.shape[2], k.shape[2]
    G = H // Hkv
    qp, kp, kgrad = [], [], []
    offset, heads = 0, None
    for md, pl in enumerate(q.placements):
        n = mesh.size(md)
        if isinstance(pl, Shard) and pl.dim == 0:
            qp.append(pl)
            kp.append(pl)
            kgrad.append(pl)
        elif isinstance(pl, Shard) and pl.dim == 2 and heads is None:
            qp.append(pl)
            hn = H // n
            if Hkv % n == 0 and hn % G == 0:
                kp.append(pl)
                kgrad.append(pl)
            else:
                heads = ((coord[md] * hn) // G,
                         ((coord[md] + 1) * hn - 1) // G + 1)
                kp.append(Replicate())
                kgrad.append(Partial())
        elif (isinstance(pl, Shard) and pl.dim == 1 and not offset
              and q.shape[1] == k.shape[1]):
            qp.append(pl)
            offset = coord[md] * (q.shape[1] // n)
            kp.append(Replicate())
            kgrad.append(Partial())
        else:
            qp.append(Replicate())
            kp.append(Replicate())
            kgrad.append(Replicate())
    ql = q.redistribute(mesh, qp).to_local()
    kl = k.redistribute(mesh, kp).to_local(grad_placements=kgrad)
    vl = v.redistribute(mesh, kp).to_local(grad_placements=kgrad)
    if heads is not None:
        kl, vl = kl[:, :, heads[0]:heads[1]], vl[:, :, heads[0]:heads[1]]
    # the keys the rows [offset, offset + Sq) see
    lo = max(0, offset - window + 1) if window else 0
    hi = offset + ql.shape[1]
    o = attend(ql, kl[:, lo:hi], vl[:, lo:hi], offset - lo).contiguous()
    shape = q.shape[:3] + o.shape[3:]
    return DTensor.from_local(o, mesh, qp, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


# decode over a DeviceMesh: a cache (B, S, ...) is a DTensor split over
# its sequence (kv_seq).  The step's entry is written by the rank whose
# slice holds its position; each rank attends over the valid positions of
# its slice, and the partial softmaxes are merged by their log-sum-exps
# (a flash-decode combine over the mesh axes that split the sequence).


def _seq_slice(cache):
    """(first position, length) of this rank's slice of a DTensor cache's
    sequence (dim 1), and the mesh dims that split it."""
    from torch.distributed.tensor import Shard
    mesh = cache.device_mesh
    coord = mesh.get_coordinate()
    dims = [md for md, p in enumerate(cache.placements)
            if isinstance(p, Shard) and p.dim == 1]
    n = cache.to_local().shape[1]
    lo = 0
    for md in dims:                       # split major to minor
        lo = lo * mesh.size(md) + coord[md]
    return lo * n, n, dims


def _write_on_mesh(cache, new, idx: int):
    """``cache[:, idx:idx + S] = new`` on a DTensor cache, in place."""
    from torch.distributed.tensor import Replicate, Shard
    lo, n, _ = _seq_slice(cache)
    pls = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
           for p in cache.placements]
    new = new.redistribute(cache.device_mesh, pls).to_local()
    a, b = max(idx, lo), min(idx + new.shape[1], lo + n)
    if a < b:
        cache.to_local()[:, a - lo:b - lo] = new[:, a - idx:b - idx]


def _span_on_mesh(local, queries, caches, span):
    """``local(queries, caches)`` -> (out (B, 1, H, Dv) f32, lse (B, H, 1))
    on each rank's slice of the DTensor caches, cut to the global position
    span [span[0], span[1]), merged over the mesh dims that split the
    sequence.  Queries (B, 1, H, ...) follow the caches' batch split (and
    head split, dim 2); the output is a DTensor placed as they are."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from ..parallel.spmd import pmax, psum
    mesh = caches[0].device_mesh
    lo, n, seq_dims = _seq_slice(caches[0])
    pls = [p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
           for p in caches[0].placements]
    ql = [q.redistribute(mesh, pls).to_local() for q in queries]
    a, b = max(span[0], lo), min(span[1], lo + n)
    if a < b:
        o, lse = local(ql, [c.to_local()[:, a - lo:b - lo] for c in caches])
        o = o.float()
    else:
        o, lse = local(ql, [c.to_local()[:, :1] for c in caches])
        o, lse = torch.zeros_like(o, dtype=torch.float32), torch.full_like(
            lse, -math.inf)
    groups = [mesh.get_group(md) for md in seq_dims]
    m = lse
    for g in groups:
        m = pmax(m, g)
    w = torch.exp(lse - m).transpose(1, 2)[..., None]      # (B, 1, H, 1)
    num, den = o * w, w
    for g in groups:
        num, den = psum(num, g), psum(den, g)
    o = (num / den).to(queries[0].dtype).contiguous()
    shape = queries[0].shape[:3] + o.shape[3:]
    return DTensor.from_local(o, mesh, pls, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


def decode_attention(q, k_cache, v_cache, *, window=None, cur_idx: int):
    """One-token decode: q (B, 1, H, D) against a (B, S, Hkv, D) cache.
    The reference masks every slot but ``cur_idx - window < j <= cur_idx``
    at -1e30; those slots get exactly zero weight, so K4's decode form
    runs over that span alone, a view of the cache."""
    lo = 0 if window is None else max(0, cur_idx - window + 1)
    return flash_decode(q, k_cache[:, lo:cur_idx + 1],
                        v_cache[:, lo:cur_idx + 1])


class _GradPlacedAsOutput(torch.autograd.Function):
    """The identity on a DTensor; its backward redistributes the gradient
    to the value's placements (replicated where the value is a partial
    sum), so the product's backward meets the layout its forward had
    (DTensor cannot fold a gradient's batch split over two axes and
    sequence split over a third into a product's rows)."""

    @staticmethod
    def forward(ctx, y):
        from torch.distributed.tensor import Replicate
        # a partial sum's gradient is the same on every rank
        ctx.placements = tuple(Replicate() if p.is_partial() else p
                               for p in y.placements)
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g


def mm(x, w):
    """``x @ w`` for activations x (..., D) and a weight w (D, F).  On
    DTensors whose leading dims are split over two mesh axes (batch over
    data and sequence over model: context-parallel attention) a per-rank
    product: DTensor cannot fold such dims into a matrix product's rows, so
    each rank multiplies its rows by the gathered weight (the weight's
    gradient: each rank's part, summed over the axes that split the
    rows).  Other DTensor products get their gradient in their output's
    placements (``_GradPlacedAsOutput``)."""
    if not _is_dtensor(x):
        return x @ w
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    rows = {p.dim for p in x.placements
            if isinstance(p, Shard) and p.dim < x.ndim - 1}
    if len(rows) < 2:
        return _GradPlacedAsOutput.apply(x @ w)
    mesh = x.device_mesh
    xp = [p if isinstance(p, Shard) and p.dim < x.ndim - 1 else Replicate()
          for p in x.placements]
    xl = x.redistribute(mesh, xp).to_local()
    wl = w.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=[Partial() if isinstance(p, Shard) else Replicate()
                         for p in xp])
    shape = x.shape[:-1] + w.shape[1:]
    return DTensor.from_local(xl @ wl, mesh, xp, run_check=False,
                              shape=shape, stride=torch.empty(
                                  shape, device="meta").stride())


def _gather_uneven(t, dim: int, first: int):
    """A DTensor about to have ``dim`` unflattened into (first, ...): a split
    of ``dim`` over a mesh axis that ``first`` does not divide is gathered
    (DTensor cannot unflatten it)."""
    if not _is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard
    mesh = t.device_mesh
    pls = [Replicate() if isinstance(p, Shard) and p.dim == dim
           and first % mesh.size(md) else p
           for md, p in enumerate(t.placements)]
    return t if pls == list(t.placements) else t.redistribute(mesh, pls)


class _Merged(torch.autograd.Function):
    """A weight's dims merged into ``dim`` of ``shape``; the backward
    unflattens the gradient's ``dim`` into dims of ``first`` and more,
    gathering a split that ``first`` does not divide (_gather_uneven)."""

    @staticmethod
    def forward(ctx, w, shape, dim, first):
        ctx.args = (w.shape, dim, first)
        return w.reshape(shape)

    @staticmethod
    def backward(ctx, g):
        old, dim, first = ctx.args
        return _gather_uneven(g, dim, first).reshape(old), None, None, None


def _merged(w, shape, dim: int, first: int):
    """``w.reshape(shape)``; on a DTensor through ``_Merged``."""
    if not _is_dtensor(w):
        return w.reshape(shape)
    return _Merged.apply(w, shape, dim, first)


def _proj(x, w):
    """einsum("bsd,d...->bs...", x, w) as one matrix product."""
    D = x.shape[-1]
    y = mm(x, _merged(w, (D, -1), 1, w.shape[1]))
    return _gather_uneven(y, y.ndim - 1, w.shape[1]).reshape(
        x.shape[:-1] + w.shape[1:])


def _decode_on_mesh(q, k, v, cache, idx: int, cache_pos: int, window):
    """attention_block's decode step on DTensor caches: the write, then K4
    (its prefill form with the lse, no mask) over each rank's valid span,
    merged.  The span is decode_attention's: [idx - window + 1, idx], or
    every written slot of a rolling window cache."""
    from ..kernels.flash import flash_attention
    cache_len = cache["k"].shape[1]
    _write_on_mesh(cache["k"], k, idx)
    _write_on_mesh(cache["v"], v, idx)
    if window is not None and cache_len <= window:
        span = (0, cache_len if cache_pos >= cache_len else idx + 1)
    else:
        span = (0 if window is None else max(0, idx - window + 1), idx + 1)

    def local(qs, kv):
        return flash_attention(qs[0], kv[0], kv[1], causal=False,
                               return_lse=True)

    return _span_on_mesh(local, [q], [cache["k"], cache["v"]], span)


def attention_block(x, p, cfg, *, positions, window, cache=None,
                    cache_pos: Optional[int] = None,
                    shard: Shard = _noshard):
    """GQA / MQA attention with optional QKV bias and sliding window.

    Prefill (``cache`` None) runs K4 (``attn_impl="blocked"``) or the naive
    oracle.  Decode writes this step's k and v into ``cache`` in place at
    ``cache_pos`` (the host-side decode position, read once per step by
    the caller) modulo the cache length, and attends over the valid span.
    Returns (out, cache)."""
    B, S, _ = x.shape
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = shard(q, ("act_batch", "act_seq", "act_heads", None))
    k = shard(k, ("act_batch", "act_seq", "act_kv", None))
    mrope = cfg.mrope_sections
    q = apply_rope(q, positions, cfg.rope_theta, mrope)
    k = apply_rope(k, positions, cfg.rope_theta, mrope)
    if cache is None:
        if cfg.attn_impl == "naive":
            def attend(q, k, v, q_offset=0):
                return naive_attention(q, k, v, causal=True, window=window,
                                       q_offset=q_offset)
        else:
            def attend(q, k, v, q_offset=0):
                return prefill_attention(q, k, v, cfg, window=window,
                                         q_offset=q_offset)
        o = _on_mesh(attend, q, k, v, window) if _is_dtensor(q) else \
            attend(q, k, v)
    else:
        # rolling window caches (cache length <= window) wrap the write
        # index; every resident entry is then within the window, so no
        # window applies
        cache_len = cache["k"].shape[1]
        idx = cache_pos % cache_len
        if _is_dtensor(cache["k"]):
            o = _decode_on_mesh(q, k, v, cache, idx, cache_pos, window)
        else:
            cache["k"][:, idx:idx + S] = k
            cache["v"][:, idx:idx + S] = v
            if window is not None and cache_len <= window:
                eff_idx = cache_len - 1 if cache_pos >= cache_len else idx
                o = decode_attention(q, cache["k"], cache["v"], window=None,
                                     cur_idx=eff_idx)
            else:
                o = decode_attention(q, cache["k"], cache["v"],
                                     window=window, cur_idx=idx)
    o = shard(o, ("act_batch", "act_seq", "act_heads", None))
    H, hd, D = p["wo"].shape
    out = mm(o.reshape(B, S, H * hd), _merged(p["wo"], (H * hd, D), 0, H))
    return out, cache


def attention_prefill_cache(x, p, cfg, *, positions,
                            shard: Shard = _noshard):
    """A prompt's keys and values in the KV cache's layout: ``{"k", "v"}``,
    each (B, S, Hkv, hd), projected from x (B, S, D) with the qkv bias
    where ``cfg.qkv_bias`` is set, and k rotated by RoPE (M-RoPE with
    ``cfg.mrope_sections``, positions (3, B, S)) as ``attention_block``
    rotates it.  The reference's counterpart, which nothing in either
    package calls."""
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if cfg.qkv_bias:
        k = k + p["bk"]
        v = v + p["bv"]
    k = shard(k, ("act_batch", "act_seq", "act_kv", None))
    v = shard(v, ("act_batch", "act_seq", "act_kv", None))
    k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    return {"k": k, "v": v}


# --------------------------------------------------------------------------
# MLA (DeepSeek-V2 §2.1): low-rank KV compression; the cache holds only the
# latent c_kv (and the shared rope key), and decode absorbs the
# up-projections


def _is_dtensor(t) -> bool:
    """A DTensor (only once ``torch.distributed.tensor`` is loaded)."""
    dt = sys.modules.get("torch.distributed.tensor")
    return dt is not None and isinstance(t, dt.DTensor)


def k4_head_dims(dk: int, dv: int) -> Tuple[int, int]:
    """The smallest (Dk, Dv) pair K4 is built for
    (``ATTENTION_HEAD_DIMS``) at or above (dk, dv) in both: (dk, dv)
    itself at DeepSeek-V2's full width (192, 128), (64, 64) for a reduced
    config's (32, 16)."""
    for pk, pv in ATTENTION_HEAD_DIMS:           # in increasing order
        if pk >= dk and pv >= dv:
            return pk, pv
    raise ValueError(f"head dims {(dk, dv)} are above every pair K4 is "
                     f"built for, {ATTENTION_HEAD_DIMS}")


def mla_block(x, p, cfg, *, positions, cache=None,
              cache_pos: Optional[int] = None, shard: Shard = _noshard):
    """Prefill (``cache`` None) builds q and k at dn + dr and v at dv and
    runs K4 (``attn_impl="blocked"``) or the naive oracle.  At full width
    K4 takes them as they are, (192, 128); a reduced config's dims that
    are no pair K4 is built for go into zero buffers of the smallest pair
    above them (``k4_head_dims``), as ``_mla_attend`` says.

    Decode writes this step's latent and rope key into ``cache`` in place
    at ``cache_pos`` modulo the cache length and attends in latent space
    (score = (q_nope W_uk) . c_kv, plain matmuls) over the slots [0, idx],
    the ones the reference's -1e30 mask leaves.  Returns (out, cache)."""
    B, S, _ = x.shape
    H = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    if cfg.q_lora_rank:
        q = _proj(mm(x, p["wq_a"]), p["wq_b"])
    else:
        q = _proj(x, p["wq_b"])
    q_nope = q[..., :dn]
    q_rope = apply_rope(q[..., dn:], positions, cfg.rope_theta)
    ckv = mm(x, p["wkv_a"])                                # (B, S, rank)
    k_rope = apply_rope(mm(x, p["wk_rope"])[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0]           # (B, S, dr)
    if cache is None:
        k_nope = _proj(ckv, p["wk_b"])
        v = _proj(ckv, p["wv_b"])
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(
            B, S, H, dr)], dim=-1)
        if _is_dtensor(q_full):
            o = _on_mesh(lambda q, k, v, off: _mla_attend(q, k, v, cfg, off),
                         q_full, k_full, v)
        else:
            o = _mla_attend(q_full, k_full, v, cfg)
    else:
        idx = cache_pos % cache["ckv"].shape[1]
        q_abs = torch.einsum("bshk,rhk->bshr", q_nope, p["wk_b"])
        if _is_dtensor(cache["ckv"]):
            _write_on_mesh(cache["ckv"], ckv, idx)
            _write_on_mesh(cache["k_rope"], k_rope, idx)
            o_lat = _span_on_mesh(
                lambda qs, cs: _latent_attend(*qs, *cs, dn + dr, lse=True),
                [q_abs, q_rope], [cache["ckv"], cache["k_rope"]],
                (0, idx + 1))
        else:
            cache["ckv"][:, idx:idx + S] = ckv
            cache["k_rope"][:, idx:idx + S] = k_rope
            o_lat = _latent_attend(q_abs, q_rope, cache["ckv"][:, :idx + 1],
                                   cache["k_rope"][:, :idx + 1], dn + dr)
        o = torch.einsum("bshr,rhk->bshk", o_lat, p["wv_b"])
    out = mm(o.reshape(B, S, H * dv), _merged(p["wo"], (H * dv, -1), 0, H))
    return out, cache


def _latent_attend(q_abs, q_rope, ckv_c, kr_c, dk: int, lse: bool = False):
    """MLA's absorbed decode over a latent cache: score = q_abs . c_kv +
    q_rope . k_rope, scaled by 1/sqrt(dk), softmax over the cache, the
    weights (in the cache's type) times c_kv: (B, 1, H, rank); with
    ``lse`` also the scores' log-sum-exp (B, H, 1)."""
    # f32 scores of the activation-type operands (the reference's
    # preferred_element_type)
    s = (torch.einsum("bshr,btr->bhst", q_abs.float(), ckv_c.float())
         + torch.einsum("bshk,btk->bhst", q_rope.float(), kr_c.float()))
    s = s / math.sqrt(dk)
    w = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhst,btr->bshr", w.to(ckv_c.dtype), ckv_c)
    return (o_lat, torch.logsumexp(s, dim=-1)) if lse else o_lat


def _mla_attend(q, k, v, cfg, q_offset: int = 0):
    """MLA's prefill attention on q, k at dn + dr and v at dv, query i at
    position i + ``q_offset``: the naive oracle, or K4.  K4 takes (dk, dv)
    as they are when it is built for them (full width); otherwise q and k
    go into zero buffers of ``k4_head_dims``' Dk and v of its Dv: the zero
    columns add exactly 0 to every q . k and give zero output columns past
    dv, which are sliced off.  The scale is 1/sqrt(dk) either way."""
    dk, dv = q.shape[-1], v.shape[-1]
    if cfg.attn_impl == "naive":
        return naive_attention(q, k, v, causal=True, q_offset=q_offset)
    pk, pv = k4_head_dims(dk, dv)
    if pk != dk:
        q, k = F.pad(q, (0, pk - dk)), F.pad(k, (0, pk - dk))
    if pv != dv:
        v = F.pad(v, (0, pv - dv))
    o = prefill_attention(q, k, v, cfg, scale=1.0 / math.sqrt(dk),
                          q_offset=q_offset)
    return o if pv == dv else o[..., :dv]


# --------------------------------------------------------------------------
# feed-forward: the gated MLP and the dropping MoE


def _act(g, act: str):
    """SwiGLU's silu or GeGLU's gelu.  jax.nn.gelu defaults to the tanh
    approximation, torch's gelu to erf: the port asks for tanh."""
    return F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")


def mlp(x, p, cfg, act: Optional[str] = None):
    """Gated MLP: SwiGLU (``"silu"``) or GeGLU (``"gelu"``)."""
    g = _act(mm(x, p["w_gate"]), act or cfg.mlp_act)
    return mm(g * mm(x, p["w_up"]), p["w_down"])


def moe_ffn(x, p, cfg, *, n_experts_padded: int, shard: Shard = _noshard):
    """Token-dropping MoE (top-k, capacity-bounded) with scatter dispatch,
    as the reference computes it on one device.  Per batch row each expert
    has C = ceil(S * K / E * capacity_factor) slots; a (token, expert)
    pair's rank within its expert is a cumsum of one-hots, and pairs
    ranked C or later drop (``keep`` 0).  The router is f32, so the
    logits are f32.  The kept tokens are scattered into an (E, B, C, D)
    buffer, the experts run as three batched matrix products, and each
    token gathers its K outputs weighted by its renormalized gates; the
    shared expert's MLP is added.  The buffer and the experts' output are
    constrained to the expert-split layout (``shard``), as in the
    reference: the exchange between the token-split and the expert-split
    layouts is the MoE's collective on a mesh."""
    B, S, Dm = x.shape
    E, K = n_experts_padded, cfg.moe_top_k
    C = max(1, int(math.ceil(S * K / E * cfg.moe_capacity_factor)))
    gates = torch.softmax(mm(x.float(), p["router"]), dim=-1)
    top_g, top_i = torch.topk(gates, K, dim=-1)           # (B, S, K)
    top_g = top_g / top_g.sum(-1, keepdim=True).clamp_min(1e-9)

    flat_e = top_i.reshape(B, S * K)
    # int32 one-hots, as the reference's, scanned along a contiguous last
    # dim (torch scans any other dim one thread a column, serially); a
    # pair's rank is its expert's count before it
    oh = F.one_hot(flat_e, E).to(torch.int32).transpose(1, 2).contiguous()
    pos = oh.cumsum(-1, dtype=torch.int32).gather(
        1, flat_e[:, None]).squeeze(1).long() - 1         # (B, S*K)
    keep = (pos < C).to(x.dtype)
    slot = pos.clamp(0, C - 1)
    bidx = torch.arange(B, device=x.device)[:, None].expand(B, S * K)
    buf = x.new_zeros((E, B, C, Dm))
    buf.index_put_((flat_e, bidx, slot),
                   x.repeat_interleave(K, dim=1) * keep[..., None],
                   accumulate=True)
    buf = shard(buf, ("expert", "act_batch", None, None))
    h = buf.reshape(E, B * C, Dm)
    g = _act(torch.bmm(h, p["w_gate"]), cfg.mlp_act)
    y = torch.bmm(g * torch.bmm(h, p["w_up"]), p["w_down"])
    y = shard(y.reshape(E, B, C, Dm), ("expert", "act_batch", None, None))
    out_tok = y[flat_e, bidx, slot] * keep[..., None]
    out = (out_tok.reshape(B, S, K, Dm)
           * top_g.to(x.dtype)[..., None]).sum(dim=2)
    if cfg.moe_shared_ff:
        out = out + mlp(x, p["shared"], cfg)
    return out


# --------------------------------------------------------------------------
# Mamba2: the causal depthwise conv and the SSD (state-space duality) scan
# in its chunked matmul form


def causal_conv1d(x, w, cache=None):
    """Depthwise causal conv: x (B, S, C), w (K, C).  With ``cache`` (the
    last K - 1 inputs, (B, K - 1, C)) the window continues from it, and
    the cache is shifted in place to end at this call's last input.
    Returns (y, cache)."""
    K = w.shape[0]
    if cache is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([cache, x], dim=1)
        cache.copy_(xp[:, -(K - 1):])
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(K))
    return y, cache


def ssd_chunked(xh, a_log, Bm, Cm, chunk: int):
    """Chunked SSD scan.

    xh:    (b, S, H, P)  discretized input (x * dt)
    a_log: (b, S, H)     per-step log decay (A * dt, negative), f32
    Bm,Cm: (b, S, G, N)  input/output projections (G groups, broadcast to H)
    Returns y (b, S, H, P) in xh's type, with the reference's casts: f32
    scores and decays, rounded to xh's type before they meet x; the scan
    over chunks is a loop."""
    b, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc = S // chunk
    dt = xh.dtype
    xc = xh.reshape(b, nc, chunk, H, P)
    ac = a_log.reshape(b, nc, chunk, H)
    Bh = Bm.reshape(b, nc, chunk, G, N).repeat_interleave(H // G, dim=3)
    Ch = Cm.reshape(b, nc, chunk, G, N).repeat_interleave(H // G, dim=3)

    cum = ac.cumsum(dim=2)                               # (b,nc,l,H)
    # intra-chunk: L[i, j] = exp(cum_i - cum_j) for i >= j.  The mask goes
    # inside the exp (-inf above the diagonal): the same L, but no
    # exp(cum_i - cum_j) of i < j, which overflows to inf once the decay
    # over a chunk passes e^88 and then makes the gradient 0 * inf = NaN
    # (the reference masks after the exp)
    mask = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=xh.device).tril()
    L = torch.exp(torch.where(mask[None, None, :, :, None],
                              cum[:, :, :, None, :] - cum[:, :, None, :, :],
                              -math.inf))                # (b,nc,i,j,H)
    scores = torch.einsum("bcihn,bcjhn->bcijh", Ch.float(), Bh.float()) * L
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores.to(dt), xc)

    # chunk states: S_c = sum_j exp(cum_last - cum_j) B_j x_j^T
    decay_tail = torch.exp(cum[:, :, -1:, :] - cum)      # (b,nc,l,H)
    states = torch.einsum("bclhn,bclhp->bchnp",
                          Bh * decay_tail.to(dt)[..., None], xc)
    chunk_decay = torch.exp(cum[:, :, -1, :])            # (b,nc,H)
    st = xh.new_zeros((b, H, N, P))
    prev = []
    for c in range(nc):
        prev.append(st)
        st = st * chunk_decay[:, c, :, None, None].to(dt) + states[:, c]
    prev_states = torch.stack(prev, dim=1)               # (b,nc,H,N,P)

    inter_decay = torch.exp(cum)                         # (b,nc,l,H)
    y_inter = torch.einsum("bclhn,bchnp->bclhp",
                           Ch * inter_decay.to(dt)[..., None], prev_states)
    return (y_intra + y_inter).reshape(b, S, H, P)


def _ssd_on_mesh(xh, a_log, Bm, Cm, chunk: int):
    """``ssd_chunked`` on DTensors, a per-rank body: the scan is
    independent per batch row and per head, so each rank scans its batch
    rows (over the batch axes) and its heads (over the model axis, where
    it divides them); B and C are replicated over the model axis."""
    from ..parallel.mapper import PartitionSpec as P
    from ..parallel.spmd import batch_axes, shard_map
    mesh = xh.device_mesh
    names = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    b = batch_axes(mesh)
    nb = 1
    for a in (b if isinstance(b, tuple) else (b,)):
        nb *= names[a]
    b = b if xh.shape[0] % nb == 0 else None
    h = "model" if xh.shape[2] % names.get("model", 1) == 0 else None
    return shard_map(lambda *a: ssd_chunked(*a, chunk), mesh,
                     (P(b, None, h, None), P(b, None, h),
                      P(b, None, None, None), P(b, None, None, None)),
                     P(b, None, h, None))(xh, a_log, Bm, Cm)


def ssd_reference(xh, a_log, Bm, Cm):
    """The per-step recurrence in f32, the tests' oracle: state_t =
    exp(a_t) state_{t-1} + B_t x_t^T; y_t = C_t . state_t."""
    b, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Bh = Bm.repeat_interleave(H // G, dim=2).float()
    Ch = Cm.repeat_interleave(H // G, dim=2).float()
    xf, af = xh.float(), a_log.float()
    st = torch.zeros((b, H, N, P), device=xh.device)
    ys = []
    for t in range(S):
        st = st * torch.exp(af[:, t])[:, :, None, None] + torch.einsum(
            "bhn,bhp->bhnp", Bh[:, t], xf[:, t])
        ys.append(torch.einsum("bhn,bhnp->bhp", Ch[:, t], st))
    return torch.stack(ys, dim=1)


def mamba_block(x, p, cfg, *, cache=None):
    """Mamba2 block: in_proj -> conv -> SSD -> gate -> out_proj.

    Prefill (``cache`` None) zero-pads the sequence to a multiple of the
    chunk (a padded step has decay 1 and no input, so the real positions
    are unchanged).  Decode takes one step from ``cache`` = {"conv":
    (B, K-1, conv_ch), "state": (B, H, N, P)} and writes both in place.
    Returns (out, cache)."""
    B, S, _ = x.shape
    di, N, Pd, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_heads
    G = 1
    z, xbc, dt = torch.split(mm(x, p["w_in"]), [di, di + 2 * G * N, H],
                             dim=-1)
    xbc, _ = causal_conv1d(xbc, p["conv_w"],
                           None if cache is None else cache["conv"])
    xbc = F.silu(xbc)
    xs, Bm, Cm = torch.split(xbc, [di, G * N, G * N], dim=-1)
    xs = xs.reshape(B, S, H, Pd)
    Bm = Bm.reshape(B, S, G, N)
    Cm = Cm.reshape(B, S, G, N)
    dt = F.softplus(dt.float() + p["dt_bias"].float())   # (B, S, H)
    a_log = dt * -torch.exp(p["a_log"].float())
    xh = xs * dt.to(xs.dtype)[..., None]

    if cache is None:
        chunk = min(cfg.ssm_chunk, S)
        pad = (-S) % chunk
        scan = _ssd_on_mesh if _is_dtensor(xh) else ssd_chunked
        y = scan(F.pad(xh, (0, 0, 0, 0, 0, pad)),
                 F.pad(a_log, (0, 0, 0, pad)),
                 F.pad(Bm, (0, 0, 0, 0, 0, pad)),
                 F.pad(Cm, (0, 0, 0, 0, 0, pad)), chunk)[:, :S]
    else:
        st = cache["state"]
        dec = torch.exp(a_log[:, 0])                      # (B, H)
        st_new = st * dec.to(st.dtype)[:, :, None, None] + torch.einsum(
            "bgn,bhp->bhnp", Bm[:, 0], xh[:, 0])
        y = torch.einsum("bgn,bhnp->bhp", Cm[:, 0], st_new)[:, None]
        st.copy_(st_new)
    # d_skip is f32: the skip term and the gate promote to f32
    y = y.reshape(B, S, di) + xs.reshape(B, S, di) * p["d_skip"]
    y = (y * F.silu(z)).to(x.dtype)
    return mm(y, p["w_out"]).to(x.dtype), cache
