"""AdamW with f32 moments over (possibly bf16) parameters: the
counterpart of ``repro.optim.adamw``, with its signature and arithmetic.

A parameter tree is the port's (nested dicts and lists of tensors,
``models.model.tree_leaves`` order).  ``adamw_update`` returns new trees;
a trainer may write them into the old leaves, as the reference's
``jax.jit(..., donate_argnums=(0, 1))`` reuses the old buffers.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..models.model import tree_leaves, tree_map, tree_unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor      # 0-d int32
    mu: Any
    nu: Any


def adamw_init(params) -> AdamWState:
    def z(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    first = next(tree_leaves(params))
    return AdamWState(torch.zeros((), dtype=torch.int32, device=first.device),
                      tree_map(z, params), tree_map(z, params))


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, *, lr=1e-4, b1=0.9,
                 b2=0.95, eps=1e-8, weight_decay=0.1, clip_norm=1.0):
    """One AdamW step after a global grad-norm clip: bias-corrected f32
    moments, decoupled weight decay, each new parameter rounded once to its
    dtype.  Returns (new params, new state, the gradient's global norm)."""
    flat_g = list(tree_leaves(grads))
    gsq = sum(g.float().square().sum() for g in flat_g)
    gnorm = torch.sqrt(gsq)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)

    step = state.step + 1
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()

    def upd(p, g, m, v):
        g = g.float() * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g.square()
        mh, vh = m / c1, v / c2
        delta = mh / (torch.sqrt(vh) + eps) + weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    out = [upd(p, g, m, v) for p, g, m, v in zip(
        tree_leaves(params), flat_g, tree_leaves(state.mu),
        tree_leaves(state.nu))]
    return (tree_unflatten(params, [o[0] for o in out]),
            AdamWState(step, tree_unflatten(params, [o[1] for o in out]),
                       tree_unflatten(params, [o[2] for o in out])),
            gnorm)
