"""AdamW with f32 moments over (possibly bf16) parameters: the
counterpart of ``repro.optim.adamw``, with its signature and arithmetic.

A parameter tree is the port's (nested dicts and lists of tensors,
``models.model.tree_leaves`` order).  ``adamw_update_`` writes the step
into the given parameters and moments, as the reference's
``jax.jit(..., donate_argnums=(0, 1))`` reuses the old buffers (the
train step's update); ``adamw_update`` returns new trees.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..models.model import tree_leaves, tree_map


# elements a slice of an in-place update (f32 temporaries of 256 MiB)
_SLICE = 1 << 26


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
def adamw_update_(params, grads, state: AdamWState, *, lr=1e-4, b1=0.9,
                  b2=0.95, eps=1e-8, weight_decay=0.1, clip_norm=1.0):
    """One AdamW step after a global grad-norm clip: bias-corrected f32
    moments, decoupled weight decay, each new parameter rounded once to its
    dtype.  The update is written into ``params`` and the state's moments
    (the reference's ``donate_argnums``): no second copy of them is alive.
    It is elementwise, so a leaf is done a slice at a time, with f32
    temporaries of one slice (a DTensor leaf: its shard at once).  Returns
    (params, new state, the gradient's global norm)."""
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

    for p, g, m, v in zip(tree_leaves(params), flat_g,
                          tree_leaves(state.mu), tree_leaves(state.nu)):
        if hasattr(p, "placements"):        # a DTensor: its shard is one
            parts = [(p, g, m, v)]
        else:
            p1, g1, m1, v1 = (p.view(-1), g.reshape(-1), m.view(-1),
                              v.view(-1))
            parts = [(p1[j], g1[j], m1[j], v1[j]) for j in (
                slice(i, i + _SLICE) for i in range(0, p1.numel(), _SLICE))]
        for part in parts:
            for old, t in zip((part[0], part[2], part[3]), upd(*part)):
                old.copy_(t)
    return params, AdamWState(step, state.mu, state.nu), gnorm


def adamw_update(params, grads, state: AdamWState, **kw):
    """``adamw_update_`` on copies: new trees, the given ones untouched
    (the reference's functional signature)."""
    def copy(t):
        return t.detach().clone()
    return adamw_update_(tree_map(copy, params), grads,
                         AdamWState(state.step, tree_map(copy, state.mu),
                                    tree_map(copy, state.nu)), **kw)
