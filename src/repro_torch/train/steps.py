"""Step builders: train_step (forward, backward, AdamW), and the prefill
and decode steps; the counterpart of ``repro.train.steps``.

Options, as the reference's:
  - microbatch gradient accumulation: the batch split along its first
    axis, each chunk's loss and gradient summed in f32, then divided;
  - int8 gradient compression: each gradient leaf quantized to int8 by its
    absolute maximum and dequantized (the round trip that brackets a
    reduction; torch.round and jnp.round both round half to even).

The reference's ``input_specs`` (ShapeDtypeStructs for its dry run) has
no counterpart: the port has no dry run.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models import build_forward
from ..models.config import ModelConfig
from ..models.model import tree_leaves, tree_map, tree_unflatten
from ..optim import adamw_update


@dataclass(frozen=True)
class StepOptions:
    microbatch: int = 1              # gradient-accumulation chunks
    grad_compress_int8: bool = False


def _int8_compress_grads(grads):
    """Quantize-dequantize every gradient leaf: scale = max|g| / 127,
    round(g / scale) clipped to [-127, 127] as int8, back to f32."""
    def q(g):
        a = g.abs().max() + 1e-9
        scale = a / 127.0
        qg = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        return qg.float() * scale
    return tree_map(q, grads)


def value_and_grad(loss_fn, params, batch):
    """(loss, grads) of ``loss_fn(params, batch)``: the gradient of every
    leaf, in its dtype, zeros for a leaf the loss does not read (as
    ``jax.value_and_grad`` gives).  ``params`` is not marked: the leaves
    are differentiated through detached aliases."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), tree_unflatten(params, list(grads))


def build_train_step(cfg: ModelConfig, opts: StepOptions = StepOptions()):
    """train_step(params, opt_state, batch) -> (new params, new AdamW state,
    {"loss", "gnorm"}), each metric a 0-d f32 tensor."""
    loss_fn = build_forward(cfg)[0]

    def train_step(params, opt_state, batch):
        if opts.microbatch > 1:
            mb = opts.microbatch
            chunks = {k: v.reshape((mb, v.shape[0] // mb) + v.shape[1:])
                      for k, v in batch.items()}
            loss_sum = grads = None
            for i in range(mb):
                l, g = value_and_grad(loss_fn, params,
                                      {k: v[i] for k, v in chunks.items()})
                if grads is None:           # f32 accumulators
                    loss_sum, grads = l.float(), tree_map(
                        lambda a: a.float(), g)
                else:
                    loss_sum = loss_sum + l.float()
                    grads = tree_map(lambda a, b: a + b, grads, g)
            loss = loss_sum / mb
            grads = tree_map(lambda a: a / mb, grads)
        else:
            loss, grads = value_and_grad(loss_fn, params, batch)
        if opts.grad_compress_int8:
            grads = _int8_compress_grads(grads)
        new_params, new_opt, gnorm = adamw_update(params, grads, opt_state)
        return new_params, new_opt, {"loss": loss, "gnorm": gnorm}

    return train_step


def build_serve_steps(cfg: ModelConfig):
    """(prefill_fn, decode_fn) of ``cfg``."""
    _, prefill_fn, decode_fn = build_forward(cfg)
    return prefill_fn, decode_fn
