"""Adafactor (factored second moments): the memory-lean optimizer, whose
second-moment state is O(rows + cols) instead of O(n).  The counterpart of
``repro.optim.adafactor``, with its signature and arithmetic."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..models.model import tree_leaves, tree_map, tree_unflatten


class AdafactorState(NamedTuple):
    step: torch.Tensor      # 0-d int32
    vr: Any                 # row statistics (or the full ones for rank < 2)
    vc: Any                 # column statistics


def _factored(p) -> bool:
    return p.dim() >= 2


def adafactor_init(params) -> AdafactorState:
    def vr(p):
        shape = p.shape[:-1] if _factored(p) else p.shape
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    def vc(p):
        shape = (p.shape[:-2] + p.shape[-1:]) if _factored(p) else (1,)
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    first = next(tree_leaves(params))
    return AdafactorState(
        torch.zeros((), dtype=torch.int32, device=first.device),
        tree_map(vr, params), tree_map(vc, params))


@torch.no_grad()
def adafactor_update(params, grads, state: AdafactorState, *, lr=1e-4,
                     decay=0.8, eps=1e-30, clip_norm=1.0):
    """One Adafactor step: factored row and column statistics for rank >= 2
    (full ones below), relative update clipping to ``clip_norm``.  Returns
    (new params, new state)."""
    step = state.step + 1
    beta = 1.0 - step.float() ** (-decay)

    def upd(p, g, vr, vc):
        g = g.float()
        g2 = g.square() + eps
        if _factored(p):
            vr_n = beta * vr + (1 - beta) * g2.mean(dim=-1)
            vc_n = beta * vc + (1 - beta) * g2.mean(dim=-2)
            denom = (vr_n[..., None] * vc_n[..., None, :]
                     / torch.clamp(vr_n.mean(dim=-1)[..., None, None],
                                   min=eps))
            u = g * torch.rsqrt(torch.clamp(denom, min=eps))
        else:
            vr_n = beta * vr + (1 - beta) * g2
            vc_n = vc
            u = g * torch.rsqrt(torch.clamp(vr_n, min=eps))
        # relative update clipping
        rms = torch.sqrt(u.square().mean() + 1e-12)
        u = u / torch.clamp(rms / clip_norm, min=1.0)
        return (p.float() - lr * u).to(p.dtype), vr_n, vc_n

    out = [upd(*t) for t in zip(tree_leaves(params), tree_leaves(grads),
                                tree_leaves(state.vr), tree_leaves(state.vc))]
    return (tree_unflatten(params, [o[0] for o in out]),
            AdafactorState(step, tree_unflatten(params, [o[1] for o in out]),
                           tree_unflatten(params, [o[2] for o in out])))
