"""Model assembly: parameter specs, periodic layer stacking (a loop over
repeating periods, then the tail), the train / prefill / decode forwards,
and memory-bounded chunked cross-entropy.

The counterpart of ``repro.models.model``, for every family: attention
(GQA / MQA, or MLA) or Mamba2 mixers, and a gated MLP or a dropping MoE.
The forwards take the reference's ``shard`` hook (an activation layout
constraint: ``parallel.ShardingMapper.shard``, which redistributes a
DTensor) and ``mesh`` (a ``DeviceMesh``): on a mesh with a model axis
(of any size, one rank too), ``cfg.dist_norm`` takes ``norm_dist`` and
``cfg.moe_impl == "a2a"`` takes ``moe_ffn_a2a`` (``models/moe_a2a.py``),
where the axis divides the features, or the sequence and the experts, as
in the reference.  With no mesh and no hook they compute what they did
without them.
Parameters are described by a spec tree of ``P`` leaves (shape, logical
axes, init), and the parameter tree has the reference's layout exactly:
``period_slots`` (one dict per slot of the period, each leaf stacked over
the periods) and ``tail_slots``, so the reference's parameters carry over
leaf by leaf (models.convert).  ``init_params`` draws the reference's
numbers bit for bit.  Gradients are torch autograd's: ``loss_fn`` under
``torch.autograd`` is the reference's ``jax.value_and_grad(loss_fn)``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from ..core.lowering import resolve_device
from ..parallel.mapper import axis_sizes
from . import layers as L
from .config import ModelConfig
from .layers import Shard, _noshard

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class P:
    """One parameter leaf: shape + logical sharding axes + init."""
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    dtype: str = "bfloat16"
    init: str = "normal"           # normal | zeros | ones | a_log | conv

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"P: shape {self.shape} and axes {self.axes} "
                             f"differ in length")


# --------------------------------------------------------------------------
# trees: nested dicts and lists of leaves, walked as jax.tree walks them
# (dict keys in sorted order, lists in order)


def tree_leaves(tree) -> Iterator[Any]:
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from tree_leaves(tree[key])
    elif isinstance(tree, (list, tuple)):
        for item in tree:
            yield from tree_leaves(item)
    else:
        yield tree


def tree_map(f: Callable, tree, *rest):
    """``f`` over the leaves of ``tree`` (and the same leaves of ``rest``),
    keeping the structure: dicts, lists, tuples and NamedTuples."""
    if isinstance(tree, dict):
        return {k: tree_map(f, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return _like(tree, [tree_map(f, t, *(r[i] for r in rest))
                            for i, t in enumerate(tree)])
    return f(tree, *rest)


def _like(seq, items):
    """``items`` as a sequence of ``seq``'s type (list, tuple, NamedTuple)."""
    if isinstance(seq, list):
        return items
    return type(seq)(*items) if hasattr(seq, "_fields") else tuple(items)


def tree_unflatten(tree, leaves):
    """A tree of ``tree``'s structure whose leaves, in ``tree_leaves``'
    order, are ``leaves``."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            done = {k: build(t[k]) for k in sorted(t)}
            return {k: done[k] for k in t}
        if isinstance(t, (list, tuple)):
            return _like(t, [build(e) for e in t])
        return next(it)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("tree_unflatten: more leaves than the tree holds")
    return out


# --------------------------------------------------------------------------
# per-slot specs


def _attn_specs(cfg: ModelConfig) -> Dict[str, P]:
    D, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = cfg.dtype
    s = {
        "wq": P((D, H, hd), ("embed", "heads", None), dt),
        "wk": P((D, Hkv, hd), ("embed", "kv_heads", None), dt),
        "wv": P((D, Hkv, hd), ("embed", "kv_heads", None), dt),
        "wo": P((H, hd, D), ("heads", None, "embed"), dt),
    }
    if cfg.qkv_bias:
        s["bq"] = P((H, hd), ("heads", None), dt, "zeros")
        s["bk"] = P((Hkv, hd), ("kv_heads", None), dt, "zeros")
        s["bv"] = P((Hkv, hd), ("kv_heads", None), dt, "zeros")
    return s


def _mla_specs(cfg: ModelConfig) -> Dict[str, P]:
    D, H = cfg.d_model, cfg.n_heads
    dn, dr, dv, rank = (cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim,
                        cfg.kv_lora_rank)
    dt = cfg.dtype
    s = {
        "wkv_a": P((D, rank), ("embed", None), dt),
        "wk_rope": P((D, dr), ("embed", None), dt),
        "wk_b": P((rank, H, dn), (None, "heads", None), dt),
        "wv_b": P((rank, H, dv), (None, "heads", None), dt),
        "wo": P((H, dv, D), ("heads", None, "embed"), dt),
    }
    if cfg.q_lora_rank:
        s["wq_a"] = P((D, cfg.q_lora_rank), ("embed", None), dt)
        s["wq_b"] = P((cfg.q_lora_rank, H, dn + dr), (None, "heads", None),
                      dt)
    else:
        s["wq_b"] = P((D, H, dn + dr), ("embed", "heads", None), dt)
    return s


def _mamba_specs(cfg: ModelConfig) -> Dict[str, P]:
    D, di, N, H, K = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                      cfg.ssm_heads, cfg.ssm_conv)
    G = 1
    dt = cfg.dtype
    conv_ch = di + 2 * G * N
    return {
        "w_in": P((D, 2 * di + 2 * G * N + H), ("embed", "inner"), dt),
        "conv_w": P((K, conv_ch), (None, "inner"), dt, "conv"),
        "dt_bias": P((H,), (None,), "float32", "zeros"),
        "a_log": P((H,), (None,), "float32", "a_log"),
        "d_skip": P((di,), ("inner",), "float32", "ones"),
        "w_out": P((di, D), ("inner", "embed"), dt),
    }


def _mlp_specs(cfg: ModelConfig, ff: int) -> Dict[str, P]:
    D, dt = cfg.d_model, cfg.dtype
    return {
        "w_gate": P((D, ff), ("embed", "ff"), dt),
        "w_up": P((D, ff), ("embed", "ff"), dt),
        "w_down": P((ff, D), ("ff", "embed"), dt),
    }


# the reference's expert axis: it pads the expert count to a multiple
EXPERT_AXIS = 16


def moe_experts_padded(cfg: ModelConfig) -> int:
    """The reference's meets-or-exceeds rule (paper §2.4): the expert count
    rounded up to a multiple of its 16-way expert axis, so the parameter
    trees stay leaf for leaf equal (granite's 40 experts are 48)."""
    return int(math.ceil(cfg.moe_experts / EXPERT_AXIS) * EXPERT_AXIS)


def _moe_specs(cfg: ModelConfig) -> Dict[str, Any]:
    D, F, dt = cfg.d_model, cfg.d_ff, cfg.dtype
    E = moe_experts_padded(cfg)
    s: Dict[str, Any] = {
        "router": P((D, E), ("embed", None), "float32"),
        "w_gate": P((E, D, F), ("expert", "embed", None), dt),
        "w_up": P((E, D, F), ("expert", "embed", None), dt),
        "w_down": P((E, F, D), ("expert", None, "embed"), dt),
    }
    if cfg.moe_shared_ff:
        s["shared"] = _mlp_specs(cfg, cfg.moe_shared_ff)
    return s


def _slot_specs(cfg: ModelConfig, i: int) -> Dict[str, Any]:
    s: Dict[str, Any] = {"norm1": P((cfg.d_model,), (None,), "float32",
                                    "zeros")}
    if cfg.layer_kind(i) == "attn":
        s["attn"] = _mla_specs(cfg) if cfg.mla else _attn_specs(cfg)
    else:
        s["mamba"] = _mamba_specs(cfg)
    s["norm2"] = P((cfg.d_model,), (None,), "float32", "zeros")
    if cfg.layer_is_moe(i):
        s["moe"] = _moe_specs(cfg)
    elif cfg.d_ff > 0:
        s["mlp"] = _mlp_specs(cfg, cfg.d_ff)
    return s


def _stacked(n: int, spec: P) -> P:
    return P((n,) + spec.shape, (None,) + spec.axes, spec.dtype, spec.init)


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    per = cfg.period
    n_per = cfg.n_layers // per
    tail = cfg.n_layers % per
    V, D = cfg.padded_vocab, cfg.d_model
    specs: Dict[str, Any] = {}
    if cfg.input_mode == "tokens":
        specs["embed"] = P((V, D), ("vocab", None), cfg.dtype)
    if not cfg.tie_embeddings:
        specs["head"] = P((D, V), (None, "vocab"), cfg.dtype)
    specs["norm_f"] = P((D,), (None,), "float32", "zeros")
    if n_per > 0:
        specs["period_slots"] = [
            tree_map(lambda p: _stacked(n_per, p), _slot_specs(cfg, s))
            for s in range(per)]
    specs["tail_slots"] = [_slot_specs(cfg, n_per * per + i)
                           for i in range(tail)]
    return specs


# --------------------------------------------------------------------------
# materialization


def abstract_params(cfg: ModelConfig):
    """The parameter tree as tensors on the ``meta`` device: shapes and
    dtypes, no storage (the reference's ShapeDtypeStructs)."""
    return tree_map(lambda p: torch.empty(p.shape, dtype=DTYPES[p.dtype],
                                          device="meta"), param_specs(cfg))


def _draw(p: P, rng: np.random.RandomState) -> np.ndarray:
    """The reference's draw for one leaf (repro.models.model.init_params),
    float64 (or float32 for zeros/ones) before the cast to its dtype.
    ``a_log`` (log(1..8), evenly spaced) draws nothing; ``conv`` draws
    normal(0, 0.2)."""
    if p.init == "zeros":
        return np.zeros(p.shape, np.float32)
    if p.init == "ones":
        return np.ones(p.shape, np.float32)
    if p.init == "a_log":
        return np.log(np.linspace(1.0, 8.0, int(np.prod(p.shape)))).reshape(
            p.shape)
    if p.init == "conv":
        return rng.normal(0, 0.2, p.shape)
    fan_in = p.shape[0] if len(p.shape) == 1 else int(np.prod(p.shape[:-1]))
    return rng.normal(0, 1.0 / math.sqrt(max(1, fan_in)), p.shape)


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda"):
    """The reference's initialization, bit for bit: one RandomState(seed)
    drawn leaf by leaf in jax.tree's order (sorted dict keys), each draw
    rounded once to its dtype.  Leaves go to ``device`` one at a time."""
    device = resolve_device(device)
    specs = param_specs(cfg)
    rng = np.random.RandomState(seed)
    drawn = {id(p): torch.from_numpy(_draw(p, rng)).to(
        DTYPES[p.dtype]).to(device) for p in tree_leaves(specs)}
    return tree_map(lambda p: drawn[id(p)], specs)


# a leaf of more elements is drawn a slice at a time (draw_params), so a
# bf16 leaf's f32 draw stays below 4.3 GB
DRAW_ELEMS = 1 << 30


def draw_params(cfg: ModelConfig, seed: int = 0, device="cuda"):
    """A parameter tree of ``cfg`` drawn on ``device`` from a seeded
    torch.Generator, with init_params's kinds and scales (normal over the
    fan-in, normal(0, 0.2) for the conv, log(1..8) for a_log, zeros and
    ones); not the reference's numbers, which init_params draws.  numpy
    draws about 30 M normals a second on a host: minutes for a model of
    billions of parameters, which the card draws in a second.  A normal
    leaf is drawn in f32 and rounded to its type; a bf16 one of more than
    DRAW_ELEMS elements a slice at a time along its first axes, so no more
    than one slice is held in f32 beside the bf16 tree."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def normal(t, std):
        if t.dtype == torch.float32:
            t.normal_(0.0, std, generator=gen)
        elif t.dim() > 1 and t.numel() > DRAW_ELEMS:
            for part in t.unbind(0):
                normal(part, std)
        else:
            t.copy_(torch.empty(t.shape, device=device).normal_(
                0.0, std, generator=gen))

    def draw(p):
        if p.init in ("zeros", "ones"):
            t = (torch.zeros if p.init == "zeros" else torch.ones)(
                p.shape, device=device)
        elif p.init == "a_log":
            t = torch.log(torch.linspace(
                1.0, 8.0, math.prod(p.shape), dtype=torch.float64,
                device=device)).reshape(p.shape)
        elif p.init in ("normal", "conv"):
            fan_in = p.shape[0] if len(p.shape) == 1 else math.prod(
                p.shape[:-1])
            t = torch.empty(p.shape, dtype=DTYPES[p.dtype], device=device)
            normal(t, 0.2 if p.init == "conv" else 1.0 / math.sqrt(
                max(1, fan_in)))
        else:
            raise ValueError(f"draw_params: no draw for init kind "
                             f"{p.init!r}")
        return t.to(DTYPES[p.dtype])

    return tree_map(draw, param_specs(cfg))


# --------------------------------------------------------------------------
# cache specs (decode)


def cache_slot_specs(cfg: ModelConfig, i: int, batch: int, seq: int
                     ) -> Dict[str, P]:
    """An attention layer's KV cache (MLA's: the latent and the rope key),
    or a Mamba layer's conv window and SSM state."""
    dt = cfg.dtype
    if cfg.layer_kind(i) == "attn":
        w = cfg.layer_window(i)
        if cfg.window_cache and w is not None:
            # rolling window cache: local-attention layers never need more
            # than `window` KV entries
            seq = min(seq, w)
        if cfg.mla:
            return {
                "ckv": P((batch, seq, cfg.kv_lora_rank),
                         ("act_batch", "kv_seq", None), dt),
                "k_rope": P((batch, seq, cfg.qk_rope_dim),
                            ("act_batch", "kv_seq", None), dt),
            }
        spec = P((batch, seq, cfg.n_kv_heads, cfg.hd),
                 ("act_batch", "kv_seq", "act_kv", None), dt)
        return {"k": spec, "v": spec}
    G = 1
    conv_ch = cfg.d_inner + 2 * G * cfg.ssm_state
    return {
        "conv": P((batch, cfg.ssm_conv - 1, conv_ch),
                  ("act_batch", None, "inner"), dt),
        "state": P((batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim),
                   ("act_batch", "act_heads", None, None), dt),
    }


def cache_specs(cfg: ModelConfig, batch: int, seq: int) -> Dict[str, Any]:
    per = cfg.period
    n_per = cfg.n_layers // per
    tail = cfg.n_layers % per
    out: Dict[str, Any] = {}
    if n_per:
        out["period_slots"] = [
            tree_map(lambda p: _stacked(n_per, p),
                     cache_slot_specs(cfg, s, batch, seq))
            for s in range(per)]
    out["tail_slots"] = [cache_slot_specs(cfg, n_per * per + i, batch, seq)
                         for i in range(tail)]
    return out


def zero_cache(cfg: ModelConfig, batch: int, seq: int, device="cuda"):
    """A zero cache (KV, latent, conv and SSM state) for ``batch``
    sequences of up to ``seq`` tokens."""
    device = resolve_device(device)
    return tree_map(lambda p: torch.zeros(p.shape, dtype=DTYPES[p.dtype],
                                          device=device),
                    cache_specs(cfg, batch, seq))


# --------------------------------------------------------------------------
# forward

def _model_axis(mesh) -> int:
    return 0 if mesh is None else axis_sizes(mesh).get("model", 0)


def _norm(x, scale, cfg: ModelConfig, mesh):
    """Norm dispatch, the reference's: the distributed (all-reduced
    statistics) norm when the residual is model-sharded on D."""
    if cfg.dist_norm and x.ndim == 3:
        msize = _model_axis(mesh)
        if msize and x.shape[-1] % msize == 0:
            return L.norm_dist(x, scale, cfg, mesh)
    return L.norm(x, scale, cfg)


def _block(x, slot_params, cfg: ModelConfig, slot_idx: int, *, positions,
           cache=None, cache_pos: Optional[int] = None,
           shard: Shard = _noshard, mesh=None):
    """One layer: the mixer its kind names (attention, MLA or Mamba2),
    then the MoE or the MLP.  A cache is written in place."""
    h = _norm(x, slot_params["norm1"], cfg, mesh)
    if cfg.layer_kind(slot_idx) != "attn":
        y, _ = L.mamba_block(h, slot_params["mamba"], cfg, cache=cache)
    elif cfg.mla:
        y, _ = L.mla_block(h, slot_params["attn"], cfg, positions=positions,
                           cache=cache, cache_pos=cache_pos, shard=shard)
    else:
        y, _ = L.attention_block(h, slot_params["attn"], cfg,
                                 positions=positions,
                                 window=cfg.layer_window(slot_idx),
                                 cache=cache, cache_pos=cache_pos,
                                 shard=shard)
    # the mixer output constrained to the residual layout before the add
    # (a reduce-scatter of the partial sums rather than an all-reduce)
    x = x + shard(y, ("act_batch", "act_seq", "act_embed"))
    if "moe" in slot_params or "mlp" in slot_params:
        h2 = _norm(x, slot_params["norm2"], cfg, mesh)
        if "mlp" in slot_params:
            f = L.mlp(h2, slot_params["mlp"], cfg)
        elif (cfg.moe_impl == "a2a" and _model_axis(mesh)
              and h2.shape[1] % _model_axis(mesh) == 0
              and moe_experts_padded(cfg) % _model_axis(mesh) == 0):
            from .moe_a2a import moe_ffn_a2a
            f = moe_ffn_a2a(h2, slot_params["moe"], cfg,
                            n_experts_padded=moe_experts_padded(cfg),
                            mesh=mesh)
            if cfg.moe_shared_ff:
                f = f + L.mlp(h2, slot_params["moe"]["shared"], cfg)
        else:
            f = L.moe_ffn(h2, slot_params["moe"], cfg,
                          n_experts_padded=moe_experts_padded(cfg),
                          shard=shard)
        x = x + shard(f, ("act_batch", "act_seq", "act_embed"))
    return shard(x, ("act_batch", "act_seq", "act_embed"))


def _period(x, slots, cfg: ModelConfig, positions, shard: Shard = _noshard,
            mesh=None):
    """One period's slots, without a cache."""
    for s, slot in enumerate(slots):
        x = _block(x, slot, cfg, s, positions=positions, shard=shard,
                   mesh=mesh)
    return x


def _stack_forward(params, x, cfg: ModelConfig, *, positions, cache=None,
                   cache_pos: Optional[int] = None, shard: Shard = _noshard,
                   mesh=None):
    """Run all layers: the periods (period j's slot s reads index j of the
    stacked leaves, where the reference scans), then the tail.  A cache is
    written in place.  Under a gradient (no cache, a stacked leaf that
    requires grad) each stacked leaf is unbound once instead, so its
    gradient is stacked once rather than scattered into a zero stack per
    period; with ``cfg.remat`` each period is then checkpointed, as the
    reference's ``jax.checkpoint`` (nothing saveable): only its input is
    kept, and its forward runs again in the backward."""
    per = cfg.period
    n_per = cfg.n_layers // per
    if n_per and cache is None and torch.is_grad_enabled() and any(
            t.requires_grad for t in tree_leaves(params["period_slots"])):
        periods = [[] for _ in range(n_per)]
        for tree in params["period_slots"]:
            unbound = [t.unbind(0) for t in tree_leaves(tree)]
            for j in range(n_per):
                periods[j].append(
                    tree_unflatten(tree, [u[j] for u in unbound]))
        for slots in periods:
            if cfg.remat:
                x = torch.utils.checkpoint.checkpoint(
                    _period, x, slots, cfg, positions, shard, mesh,
                    use_reentrant=False)
            else:
                x = _period(x, slots, cfg, positions, shard, mesh)
    else:
        for j in range(n_per):
            for s in range(per):
                slot = tree_map(lambda t: t[j], params["period_slots"][s])
                c = (tree_map(lambda t: t[j], cache["period_slots"][s])
                     if cache is not None else None)
                x = _block(x, slot, cfg, s, positions=positions, cache=c,
                           cache_pos=cache_pos, shard=shard, mesh=mesh)
    for i, slot in enumerate(params["tail_slots"]):
        c = cache["tail_slots"][i] if cache is not None else None
        x = _block(x, slot, cfg, n_per * per + i, positions=positions,
                   cache=c, cache_pos=cache_pos, shard=shard, mesh=mesh)
    return x


def _embed(params, cfg: ModelConfig, tokens_or_emb):
    if cfg.input_mode == "tokens":
        x = params["embed"][tokens_or_emb]        # gather
        # sqrt(d_model) rounded to the activation type first, as the
        # reference does (34.0, not 33.94, in bf16 for d_model 1152)
        return x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                                device=x.device)
    return tokens_or_emb.to(DTYPES[cfg.dtype])


def _head(params, cfg: ModelConfig, h):
    if cfg.tie_embeddings:
        return L.mm(h, params["embed"].T)
    return L.mm(h, params["head"])


def _xent_chunk(params, cfg: ModelConfig, hh, ll, shard: Shard = _noshard):
    """sum(logsumexp(logits) - logits[label]) over one chunk, f32."""
    logits = shard(_head(params, cfg, hh).float(),
                   ("act_batch", None, "vocab"))
    if L._is_dtensor(logits):
        return _xent_on_mesh(logits, ll)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, ll[..., None].long())[..., 0]
    return (lse - gold).sum()


def _xent_on_mesh(logits, labels):
    """``_xent_chunk``'s sum for DTensor logits (B, c, V), vocab-parallel:
    each rank takes its logits' rows and vocab slice; the row maximum,
    the sum of exponentials and the label's logit (from the rank whose
    slice holds it) are reduced over the mesh axes that split the vocab.
    The chunk's sum is counted once over those axes (by the rank at their
    origin) and summed over the axes that split the rows; returned
    replicated."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from ..parallel.spmd import pmax, psum
    mesh = logits.device_mesh
    pls = [Replicate() if isinstance(p, Partial) else p
           for p in logits.placements]
    lg = logits.redistribute(mesh, pls).to_local()
    vocab = [md for md, p in enumerate(pls)
             if isinstance(p, Shard) and p.dim == 2]
    ll = labels.redistribute(mesh, [
        p if isinstance(p, Shard) and p.dim < 2 else Replicate()
        for p in pls]).to_local().long()
    coord = mesh.get_coordinate()
    lo = 0
    for md in vocab:                       # split major to minor
        lo = lo * mesh.size(md) + coord[md]
    n = lg.shape[-1]
    lo *= n
    groups = [mesh.get_group(md) for md in vocab]
    m = lg.detach().amax(-1, keepdim=True)
    for g in groups:
        m = pmax(m, g)
    se = (lg - m).exp().sum(-1)
    rel = ll - lo
    inside = (rel >= 0) & (rel < n)
    gold = torch.where(inside, lg.gather(-1, rel.clamp(0, n - 1)[..., None])
                       [..., 0], 0.0)
    for g in groups:
        se, gold = psum(se, g), psum(gold, g)
    total = (m[..., 0] + se.log() - gold).sum()
    if any(coord[md] for md in vocab):
        total = total * 0.0
    out = DTensor.from_local(total, mesh, [
        Partial() if isinstance(p, Shard) else Replicate() for p in pls],
        run_check=False)
    return out.redistribute(mesh, [Replicate()] * mesh.ndim)


def chunked_xent(params, cfg: ModelConfig, h, labels, chunk: int = 256,
                 shard: Shard = _noshard):
    """Cross-entropy without materializing (B, S, V) logits: a loop over
    sequence chunks, each chunk's f32 logits recomputed in the backward
    (``torch.utils.checkpoint``), so one chunk's logits are alive at a
    time."""
    B, S, D = h.shape
    nch = max(1, S // chunk)
    hc = h.reshape(B, nch, S // nch, D)
    lc = labels.reshape(B, nch, S // nch)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(nch):
        total = total + torch.utils.checkpoint.checkpoint(
            _xent_chunk, params, cfg, hc[:, c], lc[:, c], shard,
            use_reentrant=False)
    return total / (B * S)


def _positions(batch, x):
    pos = batch.get("positions")
    if pos is None:
        B, S = x.shape[0], x.shape[1]
        pos = torch.arange(S, device=x.device)[None].expand(B, S)
    return pos


def build_forward(cfg: ModelConfig, shard: Shard = _noshard, mesh=None):
    """Returns (loss_fn, prefill_fn, decode_fn), the reference's forwards.
    f32 runs want TF32 off for matrix products on the card
    (torch.backends.cuda.matmul.allow_tf32, False by default).  ``shard``
    and ``mesh`` as the reference's: the activation layout hook, and the
    ``DeviceMesh`` that ``norm_dist`` and ``moe_ffn_a2a`` run on."""
    act = ("act_batch", "act_seq", "act_embed")

    def loss_fn(params, batch):
        """Mean next-token cross-entropy of ``batch["labels"]`` (f32, 0-d);
        its gradient is autograd's."""
        x = shard(_embed(params, cfg, batch["tokens"]), act)
        h = _stack_forward(params, x, cfg, positions=_positions(batch, x),
                           shard=shard, mesh=mesh)
        h = L.norm(h, params["norm_f"], cfg)
        return chunked_xent(params, cfg, h, batch["labels"], shard=shard)

    def prefill_fn(params, batch):
        """Full-sequence forward returning last-token logits (B, 1, V)."""
        x = shard(_embed(params, cfg, batch["tokens"]), act)
        h = _stack_forward(params, x, cfg, positions=_positions(batch, x),
                           shard=shard, mesh=mesh)
        h = L.norm(h[:, -1:], params["norm_f"], cfg)
        return _head(params, cfg, h)

    def decode_fn(params, cache, batch, index: Optional[int] = None):
        """One decode step against a cache, written in place.
        ``batch["positions"]`` (B, 1), or (3, B, 1) for M-RoPE, carries the
        current decode index; ``index`` is the same index on the host,
        read from the positions (one device read) when not given.  Returns
        (logits (B, 1, V), cache)."""
        x = shard(_embed(params, cfg, batch["tokens"]),   # (B,1) or (B,1,D)
                  ("act_batch", None, "act_embed"))
        pos = batch["positions"]
        if index is None:
            index = int(pos.reshape(-1)[0])
        h = _stack_forward(params, x, cfg, positions=pos, cache=cache,
                           cache_pos=index, shard=shard, mesh=mesh)
        h = L.norm(h, params["norm_f"], cfg)
        return _head(params, cfg, h), cache

    return loss_fn, prefill_fn, decode_fn
