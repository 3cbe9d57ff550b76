"""Model layers of the dense attention family: norms, RoPE / M-RoPE,
attention (prefill through K4 or the naive oracle, decode through K4 over
the valid span of a KV cache), the attention block and the gated MLP.

The counterpart of ``repro.models.layers`` for the forward half of its
dense attention family.  Parameters are plain dicts of tensors.  Unlike
the reference, a decode step writes the KV cache in place.  Not ported in
this slice: ``mla_block``, ``moe_ffn``, the Mamba2/SSD mixer and
``norm_dist`` (ROADMAP Queue 1 item 5); models.model refuses configs that
need them.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

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
            o = flash_attention(q, k, v, causal=True, window=window)
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
# feed-forward


def mlp(x, p, cfg, act: Optional[str] = None):
    """Gated MLP: SwiGLU (``"silu"``) or GeGLU (``"gelu"``).  jax.nn.gelu
    defaults to the tanh approximation, torch's gelu to erf: the port
    asks for tanh."""
    a = act or cfg.mlp_act
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    g = F.silu(g) if a == "silu" else F.gelu(g, approximate="tanh")
    return (g * u) @ p["w_down"]
