"""Meets-or-exceeds sharding mapper; the counterpart of
``repro.parallel.mapper``.

This is the paper's §5.3 discipline applied to SPMD partitioning: every
tensor dimension carries a *logical axis* name that requests a mesh mapping;
if the requested mapping is illegal (the dim does not divide the mesh axes),
the mapper walks a fallback chain — alternate axis combination, then
replication — rather than failing, exactly like HWTool's vector-width
round-up / interface-conversion rules (fig. 6). Padded dims (vocab, experts)
are the round-up case. Every decision is logged for the Controllability goal
(§1): the dry-run prints the mapping report.

``resolve`` reads only the mesh's axis names and sizes (a ``DeviceMesh``, or
``launch.mesh.MeshShape`` with no process group) and returns the port's own
``PartitionSpec``.  ``placements`` turns a spec into DTensor placements on a
``DeviceMesh``; ``shard`` (the reference's ``with_sharding_constraint``)
redistributes a DTensor to the spec, and gives any other tensor back as it
is, as the reference's ``_noshard`` does.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

AxisChain = List[Tuple[str, ...]]   # candidates in preference order

# parameter logical axes
PARAM_RULES: Dict[str, AxisChain] = {
    "vocab": [("model",)],
    "embed": [("data",)],            # FSDP / ZeRO-3 weight sharding
    "ff": [("model",)],
    "inner": [("model",)],           # mamba d_inner
    "heads": [("model",)],
    "kv_heads": [("model",)],
    "expert": [("model",)],          # EP
}

# activation logical axes
ACT_RULES: Dict[str, AxisChain] = {
    "act_batch": [("pod", "data"), ("data",)],
    "act_seq": [()],                 # context-parallel variants override
    "act_heads": [("model",)],
    "act_kv": [("model",)],
    # residual stream sharded over model between layers (Megatron-SP style:
    # an all-gather before qkv/mlp and a reduce-scatter after wo/w_down)
    # keeps saved layer boundaries at D/16 per device
    "act_embed": [("model",)],
    "act_cap": [("data",)],          # MoE capacity dim
    "kv_seq": [("pod", "model"), ("model",)],   # decode cache sequence
    "vocab": [("model",)],
}


class PartitionSpec:
    """One entry per tensor dim: None (replicated), a mesh axis name, or a
    tuple of axis names (major to minor), as ``jax.sharding.PartitionSpec``.
    A leaf of the port's trees (not a tuple), as jax's is of jax's."""

    def __init__(self, *entries):
        self.entries = tuple(entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other):
        return isinstance(other, PartitionSpec) and \
            self.entries == other.entries

    def __hash__(self):
        return hash(self.entries)

    def __repr__(self):
        return f"PartitionSpec{self.entries!r}"


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a ``MeshShape``."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def placements(spec: PartitionSpec, mesh) -> list:
    """DTensor placements (one per mesh dim) of ``spec``: ``Shard(d)`` on
    every mesh axis that tensor dim d is split over, ``Replicate()`` on the
    rest.  A dim split over several axes is split major to minor in the
    spec's order; DTensor splits a dim over mesh dims in mesh order, so
    the spec's axes must come in mesh order (the rules' chains do)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"placements: dim {d} split over {axes}, not in "
                             f"the mesh's order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return out


@dataclass
class ShardingMapper:
    mesh: Any                        # DeviceMesh or MeshShape
    rules: Dict[str, AxisChain]
    decisions: List[str] = field(default_factory=list)
    _seen: set = field(default_factory=set)

    def _log(self, msg: str):
        if msg not in self._seen:
            self._seen.add(msg)
            self.decisions.append(msg)

    def resolve(self, shape: Sequence[int],
                axes: Sequence[Optional[str]]) -> PartitionSpec:
        """Pick a legal PartitionSpec for `shape` given logical `axes`."""
        mesh_sizes = axis_sizes(self.mesh)
        used: set = set()
        out = []
        for dim, name in zip(shape, axes):
            if name is None or name not in self.rules:
                out.append(None)
                continue
            chosen = None
            for cand in self.rules[name]:
                cand = tuple(a for a in cand if a in mesh_sizes)
                if not cand:
                    chosen = ()
                    break
                size = 1
                for a in cand:
                    size *= mesh_sizes[a]
                if dim % size == 0 and not (set(cand) & used):
                    chosen = cand
                    break
            if chosen is None:
                self._log(f"{name}: dim {dim} !% any of "
                          f"{self.rules[name]} -> replicate "
                          f"(meets-or-exceeds fallback)")
                out.append(None)
            elif chosen == ():
                out.append(None)
            else:
                if chosen != tuple(a for a in self.rules[name][0]
                                   if a in mesh_sizes):
                    self._log(f"{name}: dim {dim} -> fallback {chosen}")
                used |= set(chosen)
                out.append(chosen if len(chosen) > 1 else chosen[0])
        return PartitionSpec(*out)

    def placements(self, shape, axes) -> list:
        return placements(self.resolve(shape, axes), self.mesh)

    def shard(self, x, axes):
        """Activation constraint hook (the reference's
        ``with_sharding_constraint``): a DTensor redistributed to the
        resolved spec; any other tensor as it is."""
        from torch.distributed.tensor import DTensor
        if not isinstance(x, DTensor):
            return x
        want = self.placements(x.shape, axes)
        if tuple(want) == tuple(x.placements):
            return x
        return x.redistribute(x.device_mesh, want)


def choose_rules(cfg, mesh) -> Tuple[Dict[str, AxisChain], List[str]]:
    """Arch-aware rule selection (the 'mapping function' for an arch):
    if attention heads do not divide the model axis, fall back to
    context-parallel attention (shard sequence instead of heads) — the
    analog of 'a more complex signaling protocol' (§2.4)."""
    rules = {**PARAM_RULES, **ACT_RULES}
    notes: List[str] = []
    msize = axis_sizes(mesh).get("model", 1)
    if cfg.layer_kind(0) == "attn" or "attn" in cfg.pattern:
        if cfg.n_heads % msize != 0 and not cfg.mla:
            rules = dict(rules)
            rules["act_seq"] = [("model",)]
            rules["act_heads"] = [()]
            notes.append(
                f"{cfg.name}: {cfg.n_heads} heads !% model({msize}) -> "
                f"context-parallel attention (act_seq -> model)")
    return rules, notes


def spec_shardings(mapper: ShardingMapper, spec_tree):
    """Map a model P-spec tree to PartitionSpecs (the reference's
    NamedShardings: with the mapper's mesh, ``placements`` gives each
    leaf's DTensor placements)."""
    from ..models.model import tree_leaves, tree_unflatten
    # resolved in jax.tree's order (sorted dict keys), as the decision log is
    return tree_unflatten(spec_tree, [mapper.resolve(p.shape, p.axes)
                                      for p in tree_leaves(spec_tree)])


def param_shardings(cfg, mesh):
    """Convenience: (PartitionSpec tree, mapper) for a model config."""
    from ..models.model import param_specs
    rules, notes = choose_rules(cfg, mesh)
    mapper = ShardingMapper(mesh, rules)
    mapper.decisions.extend(notes)
    return spec_shardings(mapper, param_specs(cfg)), mapper
