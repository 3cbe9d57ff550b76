"""Model layers: norms, RoPE / M-RoPE, attention (prefill through K4 or
the naive oracle; under a gradient K4 with its log-sum-exp and the
reference's block-recompute backward; decode through K4 over the valid
span of a KV cache), the attention block, MLA (DeepSeek-V2: prefill
through K4 at a padded head dim, absorbed decode over the latent cache),
the gated MLP, the dropping top-k MoE, and the Mamba2 mixer (causal conv
and the chunked SSD scan).

The counterpart of ``repro.models.layers``.  Parameters are plain dicts
of tensors.  Unlike the reference, a decode step writes
its cache (KV, latent, conv window, SSM state) in place.  The reference's
``norm_dist`` is a ``shard_map`` body over a named mesh axis, taken only
when a mesh is given; the port has no mesh and takes ``norm``, as the
reference does without one.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels._checks import ATTENTION_HEAD_DIMS
from ..kernels.flash import flash_attention, flash_decode
from ..kernels.flash.ref import MASK_VALUE

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
                        scale: float, block_kv: int):
    """dq, dk, dv of softmax(q k^T * scale + mask) v, over key blocks of
    ``block_kv``: each block's scores recomputed in f32, p = exp(s - lse),
    dv = p^T do, dp = do v^T, ds = p (dp - dsum) scale with dsum =
    sum(do * out), dq accumulated in f32, dk = ds^T q.  GQA sums dk and dv
    over the g query heads of a kv head.  lse is (B, H, Sq), f32.  Returns
    the three in q's dtype."""
    B, Sq, H, D = q.shape
    _, Skv, Hkv, Dv = v.shape
    G = H // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    dog = do.reshape(B, Sq, Hkv, G, Dv).float()
    og = out.reshape(B, Sq, Hkv, G, Dv).float()
    dsum = (dog * og).sum(-1).permute(0, 2, 3, 1)          # (B,Hkv,G,Sq)
    lse = lse.reshape(B, Hkv, G, Sq)
    q_pos = torch.arange(Sq, device=q.device)
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
    def forward(ctx, q, k, v, causal, window, scale, block_kv):
        out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window,
                    1.0 / math.sqrt(q.shape[-1]) if scale is None else scale,
                    block_kv)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, scale, block_kv = ctx.args
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do,
                                         causal=causal, window=window,
                                         scale=scale, block_kv=block_kv)
        return dq, dk, dv, None, None, None, None


def prefill_attention(q, k, v, cfg, *, window=None, scale=None):
    """K4's prefill (``attn_impl="blocked"``): through ``FlashAttention``
    when grad mode is on and an operand requires grad, else the plain call
    that serving makes."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, True, window, scale,
                                    cfg.attn_block_kv)
    return flash_attention(q, k, v, causal=True, window=window, scale=scale)


def decode_attention(q, k_cache, v_cache, *, window=None, cur_idx: int):
    """One-token decode: q (B, 1, H, D) against a (B, S, Hkv, D) cache.
    The reference masks every slot but ``cur_idx - window < j <= cur_idx``
    at -1e30; those slots get exactly zero weight, so K4's decode form
    runs over that span alone, a view of the cache."""
    lo = 0 if window is None else max(0, cur_idx - window + 1)
    return flash_decode(q, k_cache[:, lo:cur_idx + 1],
                        v_cache[:, lo:cur_idx + 1])


def _proj(x, w):
    """einsum("bsd,d...->bs...", x, w) as one matrix product."""
    D = x.shape[-1]
    return (x @ w.reshape(D, -1)).reshape(x.shape[:-1] + w.shape[1:])


def attention_block(x, p, cfg, *, positions, window, cache=None,
                    cache_pos: Optional[int] = None):
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
    mrope = cfg.mrope_sections
    q = apply_rope(q, positions, cfg.rope_theta, mrope)
    k = apply_rope(k, positions, cfg.rope_theta, mrope)
    if cache is None:
        if cfg.attn_impl == "naive":
            o = naive_attention(q, k, v, causal=True, window=window)
        else:
            o = prefill_attention(q, k, v, cfg, window=window)
    else:
        # rolling window caches (cache length <= window) wrap the write
        # index; every resident entry is then within the window, so no
        # window applies
        cache_len = cache["k"].shape[1]
        idx = cache_pos % cache_len
        cache["k"][:, idx:idx + S] = k
        cache["v"][:, idx:idx + S] = v
        if window is not None and cache_len <= window:
            eff_idx = cache_len - 1 if cache_pos >= cache_len else idx
            o = decode_attention(q, cache["k"], cache["v"], window=None,
                                 cur_idx=eff_idx)
        else:
            o = decode_attention(q, cache["k"], cache["v"], window=window,
                                 cur_idx=idx)
    H, hd, D = p["wo"].shape
    out = o.reshape(B, S, H * hd) @ p["wo"].reshape(H * hd, D)
    return out, cache


# --------------------------------------------------------------------------
# MLA (DeepSeek-V2 §2.1): low-rank KV compression; the cache holds only the
# latent c_kv (and the shared rope key), and decode absorbs the
# up-projections


def padded_head_dim(d: int) -> int:
    """The smallest head dim of K4's (ATTENTION_HEAD_DIMS) at or above d."""
    for h in ATTENTION_HEAD_DIMS:
        if h >= d:
            return h
    raise ValueError(f"head dim {d} is above K4's largest, "
                     f"{ATTENTION_HEAD_DIMS[-1]}")


def mla_block(x, p, cfg, *, positions, cache=None,
              cache_pos: Optional[int] = None):
    """Prefill (``cache`` None) builds q and k at dn + dr and v at dv and
    runs K4 (``attn_impl="blocked"``) or the naive oracle.  K4 takes one
    head dim of ATTENTION_HEAD_DIMS for q, k and v, so they are written
    into zero buffers of the smallest at or above max(dn + dr, dv): the
    zero columns add exactly 0 to every q . k and give zero output columns
    past dv, which are sliced off; the scale stays 1/sqrt(dn + dr).

    Decode writes this step's latent and rope key into ``cache`` in place
    at ``cache_pos`` modulo the cache length and attends in latent space
    (score = (q_nope W_uk) . c_kv, plain matmuls) over the slots [0, idx],
    the ones the reference's -1e30 mask leaves.  Returns (out, cache)."""
    B, S, _ = x.shape
    H = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    if cfg.q_lora_rank:
        q = _proj(x @ p["wq_a"], p["wq_b"])
    else:
        q = _proj(x, p["wq_b"])
    q_nope = q[..., :dn]
    q_rope = apply_rope(q[..., dn:], positions, cfg.rope_theta)
    ckv = x @ p["wkv_a"]                                   # (B, S, rank)
    k_rope = apply_rope((x @ p["wk_rope"])[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0]           # (B, S, dr)
    if cache is None:
        k_nope = _proj(ckv, p["wk_b"])
        v = _proj(ckv, p["wv_b"])
        if cfg.attn_impl == "naive":
            q_full = torch.cat([q_nope, q_rope], dim=-1)
            k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(
                B, S, H, dr)], dim=-1)
            o = naive_attention(q_full, k_full, v, causal=True)
        else:
            dp = padded_head_dim(max(dn + dr, dv))
            q_full = x.new_zeros((B, S, H, dp))
            q_full[..., :dn] = q_nope
            q_full[..., dn:dn + dr] = q_rope
            k_full = x.new_zeros((B, S, H, dp))
            k_full[..., :dn] = k_nope
            k_full[..., dn:dn + dr] = k_rope[:, :, None, :]
            v_full = x.new_zeros((B, S, H, dp))
            v_full[..., :dv] = v
            o = prefill_attention(q_full, k_full, v_full, cfg,
                                  scale=1.0 / math.sqrt(dn + dr))[..., :dv]
    else:
        idx = cache_pos % cache["ckv"].shape[1]
        cache["ckv"][:, idx:idx + S] = ckv
        cache["k_rope"][:, idx:idx + S] = k_rope
        ckv_c = cache["ckv"][:, :idx + 1]
        kr_c = cache["k_rope"][:, :idx + 1]
        q_abs = torch.einsum("bshk,rhk->bshr", q_nope, p["wk_b"])
        # f32 scores of the activation-type operands (the reference's
        # preferred_element_type)
        s = (torch.einsum("bshr,btr->bhst", q_abs.float(), ckv_c.float())
             + torch.einsum("bshk,btk->bhst", q_rope.float(),
                            kr_c.float()))
        w = torch.softmax(s / math.sqrt(dn + dr), dim=-1)
        o_lat = torch.einsum("bhst,btr->bshr", w.to(ckv_c.dtype), ckv_c)
        o = torch.einsum("bshr,rhk->bshk", o_lat, p["wv_b"])
    out = o.reshape(B, S, H * dv) @ p["wo"].reshape(H * dv, -1)
    return out, cache


# --------------------------------------------------------------------------
# feed-forward: the gated MLP and the dropping MoE


def _act(g, act: str):
    """SwiGLU's silu or GeGLU's gelu.  jax.nn.gelu defaults to the tanh
    approximation, torch's gelu to erf: the port asks for tanh."""
    return F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")


def mlp(x, p, cfg, act: Optional[str] = None):
    """Gated MLP: SwiGLU (``"silu"``) or GeGLU (``"gelu"``)."""
    g = _act(x @ p["w_gate"], act or cfg.mlp_act)
    return (g * (x @ p["w_up"])) @ p["w_down"]


def moe_ffn(x, p, cfg, *, n_experts_padded: int):
    """Token-dropping MoE (top-k, capacity-bounded) with scatter dispatch,
    as the reference computes it on one device.  Per batch row each expert
    has C = ceil(S * K / E * capacity_factor) slots; a (token, expert)
    pair's rank within its expert is a cumsum of one-hots, and pairs
    ranked C or later drop (``keep`` 0).  The router is f32, so the
    logits are f32.  The kept tokens are scattered into an (E, B, C, D)
    buffer, the experts run as three batched matrix products, and each
    token gathers its K outputs weighted by its renormalized gates; the
    shared expert's MLP is added."""
    B, S, Dm = x.shape
    E, K = n_experts_padded, cfg.moe_top_k
    C = max(1, int(math.ceil(S * K / E * cfg.moe_capacity_factor)))
    gates = torch.softmax(x.float() @ p["router"], dim=-1)
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
    h = buf.reshape(E, B * C, Dm)
    g = _act(torch.bmm(h, p["w_gate"]), cfg.mlp_act)
    y = torch.bmm(g * torch.bmm(h, p["w_up"]), p["w_down"])
    out_tok = y.reshape(E, B, C, Dm)[flat_e, bidx, slot] * keep[..., None]
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
    z, xbc, dt = torch.split(x @ p["w_in"], [di, di + 2 * G * N, H], dim=-1)
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
        y = ssd_chunked(F.pad(xh, (0, 0, 0, 0, 0, pad)),
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
    return (y @ p["w_out"]).to(x.dtype), cache
