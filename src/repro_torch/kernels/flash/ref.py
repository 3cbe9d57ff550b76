"""Plain PyTorch version of the flash-attention kernel (K4,
csrc/flash_attn.cu and csrc/flash_decode.cu): full-softmax GQA attention with an optional causal
mask and sliding window, f32 math.  The counterpart of
``repro.kernels.flash.ref.attention_ref``.

q: (B, Sq, H, D); k/v: (B, Skv, Hkv, D); q head h reads kv head h // g
with g = H // Hkv; query i sits at position i + ``q_offset`` for the
causal and window masks.  The scores are scaled by ``scale``, 1/sqrt(D)
unless given.  Masked scores are set to -1e30, never -inf, so a row with
no key in its band averages every key uniformly.  Returns f32, and with
``return_lse`` also each row's log-sum-exp of the scaled, masked scores,
f32 (B, H, Sq) (-1e30 + log(Skv), which is -1e30 in f32, for a row with
no key in its band).
"""
from __future__ import annotations

import math

import torch

MASK_VALUE = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window=None, scale=None,
                  return_lse: bool = False, q_offset: int = 0):
    B, Sq, H, D = q.shape
    _, Skv, Hkv, _ = k.shape
    G = H // Hkv
    qg = q.float().reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    s = s / math.sqrt(D) if scale is None else s * scale
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Skv, device=q.device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None] <= q_pos[:, None]
    if window is not None:
        mask &= k_pos[None] > q_pos[:, None] - window
    s = torch.where(mask, s, torch.full((), MASK_VALUE, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    o = o.reshape(B, Sq, H, v.shape[-1])
    if return_lse:
        return o, torch.logsumexp(s, dim=-1).reshape(B, H, Sq)
    return o
