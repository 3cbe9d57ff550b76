"""Step builders: train_step (forward, backward, AdamW), and the prefill
and decode steps; the counterpart of ``repro.train.steps``.

Options, as the reference's:
  - microbatch gradient accumulation: the batch split along its first
    axis, each chunk's loss and gradient summed in f32, then divided;
  - int8 gradient compression: each gradient leaf quantized to int8 by its
    absolute maximum and dequantized (the round trip that brackets a
    reduction; torch.round and jnp.round both round half to even).

``shard`` and ``mesh`` go to ``build_forward`` as in the reference.
``input_specs`` gives every model input of one (arch x shape) dry-run cell
as a ``meta`` tensor (the reference's ShapeDtypeStructs).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch

from ..models import build_forward
from ..models.config import ModelConfig
from ..models.layers import _noshard
from ..models.model import (DTYPES, cache_specs, tree_leaves, tree_map,
                            tree_unflatten)
from ..optim import adamw_update_


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


def _microbatches(v, mb: int):
    """``v`` split along its first axis into ``mb`` equal chunks (the
    reference's reshape).  A DTensor split over its first axis is split on
    each rank instead: chunk i holds every rank's i-th part of its rows, so
    no row moves; the chunks are the same rows in another grouping, and
    the mean of equal chunks' mean losses (and its gradient) is the
    batch's."""
    from ..models.layers import _is_dtensor
    if not _is_dtensor(v) or not any(
            getattr(p, "dim", None) == 0 for p in v.placements):
        return v.reshape((mb, v.shape[0] // mb) + v.shape[1:])
    from torch.distributed.tensor import DTensor
    local = v.to_local()
    parts = local.reshape((mb, local.shape[0] // mb) + local.shape[1:])
    shape = (v.shape[0] // mb,) + tuple(v.shape[1:])
    return [DTensor.from_local(t, v.device_mesh, v.placements,
                               run_check=False, shape=torch.Size(shape),
                               stride=torch.empty(shape, device="meta")
                               .stride()) for t in parts]


def _placed_as(g, p):
    """A DTensor gradient redistributed to its parameter's placements (the
    data-parallel reduction of the gradient: a reduce-scatter or an
    all-reduce of its partial sums)."""
    if hasattr(g, "redistribute") and tuple(g.placements) != tuple(
            p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def build_train_step(cfg: ModelConfig, shard=_noshard,
                     opts: StepOptions = StepOptions(), mesh=None):
    """train_step(params, opt_state, batch) -> (params, new AdamW state,
    {"loss", "gnorm"}), each metric a 0-d f32 tensor.  The update is
    written into the given parameter and moment tensors, which are
    returned (``adamw_update_``, the reference's ``donate_argnums=(0,
    1)``): no second copy of them is alive during the update."""
    loss_fn = build_forward(cfg, shard=shard, mesh=mesh)[0]

    def train_step(params, opt_state, batch):
        if opts.microbatch > 1:
            mb = opts.microbatch
            chunks = {k: _microbatches(v, mb) for k, v in batch.items()}
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
        if mesh is not None:
            grads = tree_map(_placed_as, grads, params)
        if opts.grad_compress_int8:
            grads = _int8_compress_grads(grads)
        new_params, new_opt, gnorm = adamw_update_(params, grads, opt_state)
        return new_params, new_opt, {"loss": loss, "gnorm": gnorm}

    return train_step


def build_serve_steps(cfg: ModelConfig, shard=_noshard, mesh=None):
    """(prefill_fn, decode_fn) of ``cfg``."""
    _, prefill_fn, decode_fn = build_forward(cfg, shard=shard, mesh=mesh)
    return prefill_fn, decode_fn


# --------------------------------------------------------------------------
# dry-run input specs (meta tensors; no allocation)


def input_specs(cfg: ModelConfig, shape_name: str, seq: int, batch: int,
                kind: str) -> Dict[str, Any]:
    """Stand-ins for every model input of one (arch x shape) cell, on the
    ``meta`` device: int32 tokens (or activation-type embeddings), labels,
    M-RoPE's (3, B, S) positions, and for decode the (B, 1) positions and
    the cache."""
    i32 = torch.int32

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    def tok(b, s):
        if cfg.input_mode == "embeddings":
            return meta((b, s, cfg.d_model), DTYPES[cfg.dtype])
        return meta((b, s), i32)

    if kind in ("train", "prefill"):
        batch_spec = {"tokens": tok(batch, seq)}
        if kind == "train":
            batch_spec["labels"] = meta((batch, seq), i32)
        if cfg.mrope_sections:
            batch_spec["positions"] = meta((3, batch, seq), i32)
        return {"batch": batch_spec}
    if kind == "decode":
        batch_spec = {"tokens": tok(batch, 1),
                      "positions": meta((3, batch, 1) if cfg.mrope_sections
                                        else (batch, 1), i32)}
        cache = tree_map(lambda p: meta(p.shape, DTYPES[p.dtype]),
                         cache_specs(cfg, batch, seq))
        return {"batch": batch_spec, "cache": cache}
    raise ValueError(kind)
