"""Expert-parallel MoE with explicit all-to-all dispatch; the counterpart
of ``repro.models.moe_a2a``.

Letting the partitioner place the token->expert scatter replicates the
(B, E, C, D) dispatch buffer across the model axis.  The least it needs is
an all-to-all of the selected token payloads (T_local * K * D bytes each
way).  This module does that directly, as a per-rank body
(``parallel.spmd.shard_map``) over a ``DeviceMesh``:

  tokens (batch -> data, seq -> model)   [SP layout]
    -> local top-k routing (replicated router)
    -> local scatter into per-destination-rank send buffers
    -> all_to_all_single over 'model' (payload, and routing metadata)
    -> local scatter into per-expert capacity buffers, expert FFN
    -> gather + reverse all_to_all_single + gated combine

Everything but the all-to-alls is local to a rank.  They are
differentiable (``parallel.spmd.all_to_all``: the backward is the reverse
all-to-all), so the same path serves train steps.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import _act


def _ranks_within(dest: torch.Tensor, n: int, cap: int):
    """Position of each assignment within its destination bucket, and
    whether it is below ``cap``: int32 one-hots counted along a contiguous
    last dim (as ``layers.moe_ffn``)."""
    oh = F.one_hot(dest, n).to(torch.int32).t().contiguous()     # (n, A)
    pos = oh.cumsum(-1, dtype=torch.int32).gather(
        0, dest[None]).squeeze(0).long() - 1                     # (A,)
    keep = pos < cap
    return pos.clamp(0, cap - 1), keep


def moe_ffn_a2a(x, p, cfg, *, n_experts_padded: int, mesh,
                axis: str = "model"):
    """x: (B, S, D), split (batch -> data, seq -> model) on entry, a
    DTensor or the global value.  Parameters: router (D, E) replicated,
    expert weights (E -> model, D, F): each rank holds E / n experts."""
    from ..parallel.mapper import PartitionSpec as P
    from ..parallel.spmd import all_to_all, batch_axes, shard_map

    E = n_experts_padded
    group = mesh.get_group(axis)
    n_sh = mesh.size(mesh.mesh_dim_names.index(axis))
    E_loc = E // n_sh
    K = cfg.moe_top_k
    cf = cfg.moe_capacity_factor

    def local(xb, router, w_gate, w_up, w_down):
        B_l, S_l, D = xb.shape
        T = B_l * S_l
        xt = xb.reshape(T, D)
        logits = (xt @ router).float()                        # (T, E)
        gates = torch.softmax(logits, dim=-1)
        top_g, top_i = torch.topk(gates, K, dim=-1)           # (T, K)
        top_g = top_g / top_g.sum(-1, keepdim=True).clamp_min(1e-9)

        A = T * K
        flat_e = top_i.reshape(A)
        flat_g = top_g.reshape(A).to(xb.dtype)
        dest = flat_e // E_loc                                # target rank
        e_loc = flat_e % E_loc
        cap = max(1, int(math.ceil(T * K / n_sh * cf)))
        slot, keep = _ranks_within(dest, n_sh, cap)
        keepf = keep.to(xb.dtype)

        x_rep = xt.repeat_interleave(K, dim=0) * keepf[:, None]  # (A, D)
        send_x = xb.new_zeros((n_sh, cap, D)).index_put(
            (dest, slot), x_rep, accumulate=True)
        # metadata: local-expert id + 1 (0 = empty slot)
        send_m = torch.zeros((n_sh, cap), dtype=torch.int32,
                             device=xb.device).index_put(
            (dest, slot), ((e_loc + 1) * keep).to(torch.int32),
            accumulate=True)

        recv_x = all_to_all(send_x, group)
        recv_m = all_to_all(send_m, group)

        # local per-expert capacity buffers
        Tr = n_sh * cap
        rx = recv_x.reshape(Tr, D)
        rm = recv_m.reshape(Tr)                               # 0 = empty
        valid = rm > 0
        eids = (rm - 1).clamp(0, E_loc - 1).long()
        C2 = max(1, int(math.ceil(Tr / E_loc * cf)))
        # bucket by local expert, invalid slots routed to a throwaway rank
        slot2, keep2 = _ranks_within(
            torch.where(valid, eids, E_loc - 1), E_loc, C2)
        ok = (valid & keep2).to(xb.dtype)
        buf = xb.new_zeros((E_loc, C2, D)).index_put(
            (eids, slot2), rx * ok[:, None], accumulate=True)

        g = _act(torch.bmm(buf, w_gate), cfg.mlp_act)
        y = torch.bmm(g * torch.bmm(buf, w_up), w_down)       # (E_loc, C2, D)

        yr = y[eids, slot2] * ok[:, None]                     # (Tr, D)
        back = all_to_all(yr.reshape(n_sh, cap, D), group)
        out_tok = back[dest, slot] * keepf[:, None] * flat_g[:, None]
        out = out_tok.reshape(T, K, D).sum(dim=1)
        return out.reshape(B_l, S_l, D)

    bspec = batch_axes(mesh)
    fn = shard_map(local, mesh,
                   (P(bspec, axis, None), P(None, None),
                    P(axis, None, None), P(axis, None, None),
                    P(axis, None, None)),
                   P(bspec, axis, None))
    return fn(x, p["router"].to(x.dtype), p["w_gate"], p["w_up"],
              p["w_down"])
