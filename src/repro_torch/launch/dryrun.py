"""Dry-run of one (arch x shape x mesh) cell on a fake process group of 256
(or 512) ranks: the step run once on DTensors over fake tensors, with its
per-device flops, bytes, collective bytes and memory, and the roofline
terms; the counterpart of ``repro.launch.dryrun``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b \\
      --shape train_4k [--multipod] [--out artifacts/]

Nothing is allocated and no card is needed.  A fake process group
(``torch.testing._internal.distributed.fake_pg``) stands for the mesh's
ranks, and the script is one of them, the last: its collectives return
at once.  The last rank's shard holds the sequence's last positions, so
under causal context-parallel attention and a decode over a
sequence-split cache it has the most work of any rank (rank 0 the
least); a step takes as long as its slowest rank.  Parameters, AdamW
state, the batch and the decode cache are DTensors placed by the sharding
mapper, each holding a ``FakeTensorMode`` tensor of its rank's shard.
The step (build_train_step's, or build_serve_steps' prefill or decode)
runs once, eagerly, with the mapper's ``shard`` hook and the mesh.  K4's prefill on a fake tensor is
the operator ``repro_torch::flash_attention``'s fake: its outputs (out and
the row log-sum-exp, no S x S scores) and K4's flops (the unmasked pairs,
``kernels.flash.ops.prefill_flops``), so attention counts as K4 runs it
on the card; its backward is plain PyTorch on the card too (blocked over
``attn_block_kv`` keys) and counts as its ops.  A context-parallel rank
runs its rows at their offset against the keys before them.  What each
artifact field is:

  flops_per_device    the flops of the rank's local ops (the formulas of
                      ``torch.utils.flop_counter``), the backward and its
                      remat recompute included
  bytes_per_device    every local op's tensor inputs and outputs, eager
                      and unfused (XLA's "bytes accessed" counts after
                      fusion: this is an upper bound of the same thing)
  collectives         ``parallel.collective_bytes``: the rank's result
                      bytes per kind.  On this CPU mesh DTensor runs a
                      shard-to-shard redistribution as an all-gather and a
                      local chunk, counted as the all-gather it is here
  memory_analysis     argument bytes: the rank's shards of the step's
                      inputs; temp bytes: the peak of the local tensors the
                      step makes and holds at once (the outputs of local
                      ops, one count per storage, from the op that made it
                      until its last tensor is freed); output bytes: the
                      step's outputs' shards; alias bytes: the inputs the
                      step writes in place (parameters and AdamW state, a
                      decode cache)
  t_lower_s           seconds to place the fake state
  t_compile_s         seconds of the step's one eager run (nothing is
                      compiled)
  extrapolation       {"mode": "exact"}: eager counts see every layer (the
                      reference extrapolates over 1 and 2 periods because
                      XLA counts a loop body once)

A cell that fails writes no artifact and exits nonzero with the error,
as the reference's does.  Roofline constants are the H100's
(``launch.mesh``).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import weakref
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import ARCHS, LONG_CONTEXT_ARCHS, SHAPES
from ..models.config import ModelConfig
from ..models.model import (DTYPES, cache_specs, param_specs, tree_leaves,
                            tree_map)
from ..optim import AdamWState
from ..parallel.comm import collective_bytes
from ..parallel.mapper import (ShardingMapper, choose_rules, placements,
                               spec_shardings)
from ..train.steps import (StepOptions, build_serve_steps, build_train_step,
                           input_specs)
from .mesh import (HBM_BW, HBM_BYTES, NVLINK_BW, PEAK_FLOPS_BF16,
                   make_production_mesh, production_shape)


def fake_group(n: int):
    """A fake process group of ``n`` ranks, this process the last, n - 1
    (made, or remade at another size, as needed): its collectives return
    at once."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized() and dist.get_world_size() != n:
        dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=n - 1,
                                world_size=n)


def fake_mesh(shape: Tuple[int, ...], names: Tuple[str, ...]):
    """A CPU ``DeviceMesh`` of ``shape`` over a fake process group of as
    many ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    fake_group(int(torch.Size(shape).numel()))
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class _LocalCounts(TorchDispatchMode):
    """Flops, bytes touched and live bytes of the local ops (under DTensor:
    a DTensor op comes back as its local ops).  Live bytes count each
    storage once, from the op that made it until its last tensor dies.

    Not counted: ops on the ``meta`` device (shapes and strides only), and
    DTensor's sharding propagation, which derives an op's global output
    shape by running the op once on global-shape fake tensors (in the
    dry run's fake mode, so through this mode): that is not the rank's
    work.  ``uncounted_propagation`` marks it."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.paused = 0
        self._owners: Dict[int, set] = {}

    @contextlib.contextmanager
    def uncounted_propagation(self):
        """Counting off inside DTensor's sharding propagation
        (``ShardingPropagator._propagate_tensor_meta_non_cached``, every
        op's first run on a new signature)."""
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator as SP
        orig = SP._propagate_tensor_meta_non_cached

        def propagate(prop, op_schema):
            self.paused += 1
            try:
                return orig(prop, op_schema)
            finally:
                self.paused -= 1

        SP._propagate_tensor_meta_non_cached = propagate
        try:
            yield self
        finally:
            SP._propagate_tensor_meta_non_cached = orig

    def _forget(self, key: int, tid: int, n: int):
        owners = self._owners.get(key)
        if owners is None:
            return
        owners.discard(tid)
        if not owners:
            del self._owners[key]
            self.live -= n

    def _track(self, t):
        st = t.untyped_storage()
        key = st._cdata
        owners = self._owners.get(key)
        if owners is None:
            owners = self._owners[key] = set()
            self.live += st.nbytes()
            self.peak = max(self.peak, self.live)
        if id(t) not in owners:
            owners.add(id(t))
            weakref.finalize(t, self._forget, key, id(t), st.nbytes())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = [o for o in torch.utils._pytree.tree_leaves(out)
                if isinstance(o, torch.Tensor)]
        if self.paused or any(o.device.type == "meta" for o in outs):
            return out
        packet = func._overloadpacket
        if packet in self.registry:
            self.flops += self.registry[packet](*args, **kwargs, out_val=out)
        ins = [a for a in torch.utils._pytree.tree_leaves((args, kwargs))
               if isinstance(a, torch.Tensor)]
        if not func.is_view:
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        for o in outs:
            self._track(o)
        return out


def _placed(fake_mode, mesh, shape, dtype, pls):
    """A DTensor of global ``shape`` placed by ``pls``, holding a fake
    tensor of this rank's shard."""
    from torch.distributed.tensor import DTensor, Shard
    local = list(shape)
    for md, pl in enumerate(pls):
        if isinstance(pl, Shard):
            local[pl.dim] //= mesh.size(md)
    with fake_mode:
        t = torch.empty(local, dtype=dtype)
    return DTensor.from_local(t, mesh, pls, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


def _batch_axes(spec: torch.Tensor):
    if spec.ndim == 3 and spec.shape[0] == 3 and spec.dtype == torch.int32:
        return (None, "act_batch", None)           # M-RoPE (3, B, S)
    return ("act_batch",) + (None,) * (spec.ndim - 1)


def run_cell(cfg: ModelConfig, kind: str, seq: int, batch: int, mesh,
             opts: StepOptions = StepOptions()) -> Dict[str, Any]:
    """One step of ``kind`` on DTensors over fake tensors on ``mesh``:
    the per-device counts, memory, mapper and seconds."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    rules, notes = choose_rules(cfg, mesh)
    mapper = ShardingMapper(mesh, rules)
    mapper.decisions.extend(notes)
    fake = FakeTensorMode()

    def place(tree_specs, dtype=None):
        """A spec tree's leaves, placed by the mapper (resolved in the
        reference's order, so the decision log is its)."""
        return tree_map(lambda p, sp: _placed(
            fake, mesh, p.shape, dtype or DTYPES[p.dtype],
            placements(sp, mesh)), tree_specs,
            spec_shardings(mapper, tree_specs))

    t0 = time.time()
    pspecs = param_specs(cfg)
    params = place(pspecs)
    specs = input_specs(cfg, "", seq, batch, kind)
    bt = {k: _placed(fake, mesh, v.shape, v.dtype,
                     mapper.placements(v.shape, _batch_axes(v)))
          for k, v in specs["batch"].items()}
    args = [params, bt]
    if kind == "train":
        step0 = _placed(fake, mesh, (), torch.int32, placements(
            mapper.resolve((), ()), mesh))
        opt = AdamWState(step0, place(pspecs, torch.float32),
                         place(pspecs, torch.float32))
        args = [params, opt, bt]
    elif kind == "decode":
        cache = place(cache_specs(cfg, batch, seq))
        args = [params, cache, bt]
    arg_bytes = sum(_nbytes(t.to_local()) for t in tree_leaves(args))
    t_setup = time.time() - t0

    counts = _LocalCounts()
    t0 = time.time()
    with fake, implicit_replication(), collective_bytes() as rec, \
            counts.uncounted_propagation(), counts:
        if kind == "train":
            out = build_train_step(cfg, shard=mapper.shard, opts=opts,
                                   mesh=mesh)(*args)
        elif kind == "prefill":
            prefill_fn, _ = build_serve_steps(cfg, shard=mapper.shard,
                                              mesh=mesh)
            with torch.no_grad():
                out = prefill_fn(*args)
        else:
            _, decode_fn = build_serve_steps(cfg, shard=mapper.shard,
                                             mesh=mesh)
            with torch.no_grad():
                out = decode_fn(*args, index=seq - 1)
        out_bytes = sum(_nbytes(t.to_local()) for t in tree_leaves(out)
                        if hasattr(t, "to_local"))
    t_run = time.time() - t0
    del out
    # donated inputs (params and AdamW state, a decode cache) are written
    # in place: they alias outputs
    alias = 0 if kind == "prefill" else sum(
        _nbytes(t.to_local()) for t in tree_leaves(args[:-1]))
    return {"flops": float(counts.flops), "bytes": float(counts.bytes),
            "coll": {k: float(v) for k, v in rec.counts.items()},
            "coll_calls": dict(rec.calls),
            "memory": {"argument_size_in_bytes": arg_bytes,
                       "output_size_in_bytes": out_bytes,
                       "temp_size_in_bytes": counts.peak,
                       "generated_code_size_in_bytes": None,
                       "alias_size_in_bytes": alias},
            "mapper": mapper, "t_setup": t_setup, "t_run": t_run}


def lower_cell(cfg: ModelConfig, shape_name: str, multi_pod: bool,
               opts: StepOptions = StepOptions(),
               cfg_overrides: Optional[Dict[str, Any]] = None, *,
               mesh=None, shape: Optional[Tuple[int, int, str]] = None
               ) -> Dict[str, Any]:
    """The artifact of one cell: ``SHAPES[shape_name]`` (or ``shape``, a
    (seq, batch, kind)) on the production mesh (or ``mesh``)."""
    seq, batch, kind = shape or SHAPES[shape_name]
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    if mesh is None:
        fake_group(torch.Size(production_shape(multi_pod=multi_pod)
                              .shape).numel())
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    n_chips = mesh.size()
    m = run_cell(cfg, kind, seq, batch, mesh, opts)
    flops, bytes_acc = m["flops"], m["bytes"]
    coll_b = m["coll"].get("total", 0.0)
    compute_s = flops / PEAK_FLOPS_BF16
    memory_s = bytes_acc / HBM_BW
    collective_s = coll_b / NVLINK_BW
    dominant = max(("compute", compute_s), ("memory", memory_s),
                   ("collective", collective_s), key=lambda kv: kv[1])[0]
    model_flops = 6 * cfg.param_count(active_only=True) * batch * (
        seq if kind != "decode" else 1)
    if kind != "train":
        model_flops //= 3  # forward only
    mem = m["memory"]
    hbm = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    return {
        "arch": cfg.name, "shape": shape_name, "kind": kind,
        "mesh": "x".join(str(s) for s in tuple(mesh.shape)),
        "mesh_axes": list(mesh.mesh_dim_names),
        "n_chips": n_chips, "seq": seq, "batch": batch,
        "t_lower_s": round(m["t_setup"], 1),
        "t_compile_s": round(m["t_run"], 1),
        "flops_per_device": flops, "bytes_per_device": bytes_acc,
        "collective_bytes_per_device": coll_b,
        "collectives": m["coll"], "collective_calls": m["coll_calls"],
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": collective_s, "dominant": dominant,
        "model_flops_global": float(model_flops),
        "useful_flops_ratio": (float(model_flops) / (flops * n_chips)
                               if flops else None),
        "memory_analysis": mem,
        "hbm_gb": round(hbm / 1e9, 2),
        "fits_hbm_80g": hbm <= HBM_BYTES,
        "roofline_constants": {
            "card": "NVIDIA H100 80GB HBM3, 700.00 W (datasheet)",
            "peak_flops_bf16": PEAK_FLOPS_BF16, "hbm_bytes_per_s": HBM_BW,
            "nvlink_bytes_per_s": NVLINK_BW, "hbm_bytes": HBM_BYTES},
        "mapper_decisions": m["mapper"].decisions,
        "params_global": cfg.param_count(),
        "params_active": cfg.param_count(active_only=True),
        "extrapolation": {"mode": "exact"},
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--shape", required=True, choices=sorted(SHAPES))
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--out", default="artifacts")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg override key=value (e.g. remat=False)")
    args = ap.parse_args(argv)

    cfg = ARCHS[args.arch]
    if args.shape == "long_500k" and args.arch not in LONG_CONTEXT_ARCHS:
        print(f"SKIP {args.arch} x long_500k (full attention)")
        return None

    overrides: Dict[str, Any] = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        overrides[k] = json.loads(v) if v not in ("True", "False") \
            else (v == "True")

    opts = StepOptions(microbatch=args.microbatch,
                       grad_compress_int8=args.grad_compress)
    art = lower_cell(cfg, args.shape, args.multipod, opts,
                     overrides or None)
    art["tag"] = args.tag
    os.makedirs(args.out, exist_ok=True)
    mesh_tag = "multipod" if args.multipod else "pod"
    path = os.path.join(
        args.out, f"{args.arch}__{args.shape}__{mesh_tag}__{args.tag}.json")
    with open(path, "w") as f:
        json.dump(art, f, indent=1)
    print(f"OK {args.arch} x {args.shape} x {mesh_tag}: "
          f"compute={art['compute_s']:.3e}s memory={art['memory_s']:.3e}s "
          f"collective={art['collective_s']:.3e}s dominant={art['dominant']} "
          f"(setup {art['t_lower_s']}s run {art['t_compile_s']}s)")
    print(f"   -> {path}")
    return art


if __name__ == "__main__":
    main()
