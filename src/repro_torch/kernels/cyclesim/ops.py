"""Wrapper of the cycle kernel (``csrc/cyclesim.cu``): whole cycle-level
simulations of one packed netlist, one thread block per design.

A CUDA ``caps`` launches the kernel once for all its rows (or raises); a
CPU ``caps`` takes the plain version in ref.py; any other device raises.
The kernel replaces the reference's two XLA loops,
``hwsim/vector.py::_segment_impl`` and ``hwsim/population.py::_pop_impl``
(no ``pl.pallas_call``: they are ``lax.while_loop`` programs).

The netlist is packed once per ``VectorSim`` and device into int64
tensors: per-module constants, per-edge constants, CSR lists of each
module's out-edges and in-edges, and the need tables of the profiled
edges (Pad / Crop / Downsample consumers).  A proportional edge's need is
computed in the kernel, ``min(tpf, ceil(k * tpf / ot))``, which is what
its table holds, so a 1080p netlist ships tens of megabytes of tables
instead of about a gigabyte.  A table set on the ``VectorSim`` by hand
(``need_buf``) is shipped whole.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import _build, _checks
from .ref import cycle_sim_ref

MAX_THREADS = 256
# field orders of the packed per-module / per-edge constants and of the
# per-design scalars the kernel writes back (csrc/cyclesim.cu)
MOD_FIELDS = ("rnum", "rden", "throt", "leff", "has_out", "active",
              "is_sink", "tot")
EDGE_FIELDS = ("src", "dst", "need_off", "tpf", "ot")
STATE_EDGE = ("occ", "consumed", "kf", "fr", "hwm", "hwm_cycle")
STATE_MOD = ("launched", "pushed", "credit")
SCALARS = ("t", "last_progress", "skipped", "saved", "code", "nfe")
_DONE = 2

_ARGTYPES = ((ctypes.c_void_p,) * 12 + (ctypes.c_int,) * 3
             + (ctypes.c_longlong,) * 7 + (ctypes.c_int,) * 2
             + (ctypes.c_void_p,))


def threads_for(M: int, E: int) -> int:
    """Threads per block: one per module or edge, in whole warps, at most
    ``MAX_THREADS`` (larger netlists loop with a block stride)."""
    return min(MAX_THREADS, max(32, -(-max(M, E) // 32) * 32))


def smem_bytes(M: int, E: int) -> int:
    """Dynamic shared memory of one block: six int64 counters per edge,
    three per module, one event slot, and an int flag per module and per
    edge."""
    return 8 * (6 * E + 3 * M + 1) + 4 * (M + E)


def _csr(owner: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    counts = np.bincount(owner, minlength=n) if len(owner) else \
        np.zeros(n, np.int64)
    ptr = np.zeros(n + 1, np.int64)
    ptr[1:] = np.cumsum(counts)
    return ptr, np.argsort(owner, kind="stable").astype(np.int64)


def _need_tables(sim) -> Tuple[np.ndarray, np.ndarray]:
    """(per-edge table offset or -1 for a computed need, tables)."""
    if sim.need_by_hand:                   # ship a hand-set table whole
        return sim.need_off, sim.need_buf
    off = np.full(sim.E, -1, np.int64)
    tables, n = [], 0
    for e, spec in enumerate(sim.specs):
        if spec.profile is not None:
            off[e] = n
            tables.append(spec.need_array())
            n += len(tables[-1])
    buf = np.concatenate(tables).astype(np.int64) if tables else \
        np.zeros(1, np.int64)
    return off, buf


def pack(sim, device: torch.device) -> dict:
    """``sim``'s netlist as the kernel's int64 tensors on ``device``,
    cached on ``sim``."""
    cache = sim.__dict__.setdefault("_kernel_pack", {})
    key = (str(device), sim.need_by_hand)
    if key not in cache:
        need_off, need_buf = _need_tables(sim)
        cols = dict(src=sim.src, dst=sim.dst, need_off=need_off,
                    tpf=sim.tpf, ot=sim.ot)
        mod = np.stack([getattr(sim, f).astype(np.int64)
                        for f in MOD_FIELDS], axis=1) if sim.M else \
            np.zeros((0, len(MOD_FIELDS)), np.int64)
        edge = np.stack([cols[f] for f in EDGE_FIELDS],
                        axis=1).astype(np.int64) if sim.E else \
            np.zeros((0, len(EDGE_FIELDS)), np.int64)
        out_ptr, out_idx = _csr(sim.src, sim.M)
        in_ptr, in_idx = _csr(sim.dst, sim.M)
        arrays = dict(mod=mod, edge=edge, out_ptr=out_ptr, out_idx=out_idx,
                      in_ptr=in_ptr, in_idx=in_idx, need_buf=need_buf)
        cache[key] = {k: torch.from_numpy(np.ascontiguousarray(a)).to(device)
                      for k, a in arrays.items()}
    return cache[key]


def cycle_sim(sim, caps: torch.Tensor, horizon: int, stall_limit: int,
              event_jump: bool = True
              ) -> List[Tuple[dict, List[int], Optional[int]]]:
    """Simulate every row of ``caps`` ((K, E) int64 per-edge capacities)
    over ``sim``'s packed netlist (a ``hwsim.vector.VectorSim``) to its
    stop code: done, the ``horizon`` or a stall past ``stall_limit``, with
    event jumps over no-op plateaus unless ``event_jump`` is False.
    Returns per design its final state (numpy counters and int scalars),
    its frame-end cycles and its stop code (None when done).

    On a CUDA ``caps`` this is one launch: a block per design, each with
    its own clock, event jumps and launch-history ring."""
    if not isinstance(caps, torch.Tensor) or caps.dtype != torch.int64 \
            or caps.dim() != 2 or caps.shape[1] != sim.E:
        raise ValueError(f"cycle_sim: caps must be an int64 (K, {sim.E}) "
                         f"tensor, got {caps!r:.80}")
    if _checks.route("cyclesim", caps) == "cpu":
        return cycle_sim_ref(sim, caps, horizon, stall_limit, event_jump)
    dev = caps.device
    K, M, E, H = caps.shape[0], sim.M, sim.E, sim.H
    F = max(sim.frames, 1)
    if K == 0:
        return []
    net = pack(sim, dev)
    i64 = torch.int64
    hist = torch.zeros((K, H, M), dtype=i64, device=dev)
    state = torch.empty((K, 6 * E + 3 * M), dtype=i64, device=dev)
    scal = torch.empty((K, len(SCALARS)), dtype=i64, device=dev)
    fe = torch.full((K, F), -1, dtype=i64, device=dev)
    fn = _build.function("cyclesim", "cyclesim_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch(
            "cyclesim", fn, net["mod"].data_ptr(), net["edge"].data_ptr(),
            net["out_ptr"].data_ptr(), net["out_idx"].data_ptr(),
            net["in_ptr"].data_ptr(), net["in_idx"].data_ptr(),
            net["need_buf"].data_ptr(), caps.data_ptr(), hist.data_ptr(),
            state.data_ptr(), scal.data_ptr(), fe.data_ptr(), K, M, E, H,
            sim.frames, horizon, stall_limit, sim.sink0, sim.frame_tokens,
            F, int(bool(event_jump)), threads_for(M, E), stream)
    state, scal, fe = state.cpu().numpy(), scal.cpu().numpy(), \
        fe.cpu().numpy()
    out = []
    for k in range(K):
        s = {name: state[k, i * E:(i + 1) * E].copy()
             for i, name in enumerate(STATE_EDGE)}
        base = 6 * E
        s.update({name: state[k, base + i * M:base + (i + 1) * M].copy()
                  for i, name in enumerate(STATE_MOD)})
        s.update({name: int(scal[k, i]) for i, name in enumerate(SCALARS)})
        code = s.pop("code")
        frame_ends = [int(x) for x in fe[k, :min(s.pop("nfe"), F)]]
        out.append((s, frame_ends, None if code == _DONE else code))
    return out
