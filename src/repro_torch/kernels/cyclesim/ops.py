"""Wrapper of the cycle kernel (``csrc/cyclesim.cu``): whole cycle-level
simulations of one packed netlist, one design a block.

A CUDA ``caps`` launches the kernel once for all its rows (or raises); a
CPU ``caps`` takes the plain version in ref.py; any other device raises.
The kernel replaces the reference's two XLA loops,
``hwsim/vector.py::_segment_impl`` and ``hwsim/population.py::_pop_impl``
(no ``pl.pallas_call``: they are ``lax.while_loop`` programs).

The netlist is packed once per ``VectorSim`` and device: int64 per-module
constants (with each module's launch-history ring offset: word-aligned
prefix sums of ``leff + 1`` bits), int64 per-edge constants (with a
proportional edge's need step, ``tpf div ot`` and ``tpf mod ot``), int32
CSR lists of each module's out-edges and in-edges, and the need tables of
the profiled edges (Pad / Crop / Downsample consumers).  A proportional
edge's need, ``min(tpf, ceil(k * tpf / ot))``, is stepped in the kernel,
which is what its table holds, so a 1080p netlist ships tens of megabytes
of tables instead of about a gigabyte.  A table set on the ``VectorSim``
by hand (``need_buf``) is shipped whole.

Forms (``form_for``): the warp form, one warp a design, where the netlist
fits one of ``WARP_SLOTS`` (modules and edges a lane); the block form,
modules over a block's threads, otherwise.  The rings go in shared memory
when ``smem_bytes`` fits ``SMEM_LIMIT``, else in global memory (bits
either way).
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import _build, _checks
from .ref import cycle_sim_ref

MAX_THREADS = 256
# the warp form's instantiations (csrc/cyclesim.cu cyclesim_launch):
# (modules, edges) a lane, smallest first; up to 96 modules and edges.
# The block form takes larger netlists: on an H100 the warp form was
# faster on chains of 8-96 modules and slower at 128, where a lane's four
# modules and four edges spill (PERF.md, launch/cycle_profile.py
# --crossover)
WARP_SLOTS = ((1, 1), (2, 2), (2, 3), (3, 3))
SMEM_LIMIT = 232_448          # dynamic shared memory a block on an H100
# field orders of the packed per-module / per-edge constants and of the
# per-design scalars the kernel writes back (csrc/cyclesim.cu)
MOD_FIELDS = ("rnum", "rden", "throt", "leff", "has_out", "active",
              "is_sink", "tot", "ring")
EDGE_FIELDS = ("src", "dst", "need_off", "tpf", "ot", "qstep", "rstep")
STATE_EDGE = ("occ", "consumed", "kf", "fr", "hwm", "hwm_cycle")
STATE_MOD = ("launched", "pushed", "credit")
SCALARS = ("t", "last_progress", "skipped", "saved", "code", "nfe")
_DONE = 2

_ARGTYPES = ((ctypes.c_void_p,) * 12 + (ctypes.c_int,) * 3
             + (ctypes.c_longlong,) * 7 + (ctypes.c_int,) * 4
             + (ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p))
_INT32_MAX = 2 ** 31 - 1


def warp_slots(M: int, E: int) -> Optional[Tuple[int, int]]:
    """The warp form's (modules, edges) a lane for this netlist, or None
    (the block form)."""
    need = (-(-M // 32), -(-E // 32))
    for ms, es in WARP_SLOTS:
        if ms >= need[0] and es >= need[1]:
            return ms, es
    return None


def form_for(M: int, E: int) -> str:
    return "warp" if warp_slots(M, E) else "block"


def threads_for(M: int, E: int, form: Optional[str] = None) -> int:
    """Threads per block: one warp in the warp form; in the block form one
    per module, in whole warps, at most ``MAX_THREADS`` (larger netlists
    loop with a block stride)."""
    if (form or form_for(M, E)) == "warp":
        return 32
    return min(MAX_THREADS, max(32, -(-M // 32) * 32))


def ring_offsets(leff: np.ndarray) -> Tuple[np.ndarray, int]:
    """Each module's ring offset in 64-bit words (word-aligned prefix sums
    of ``leff + 1`` bits) and the words of one design's rings."""
    words = -(-(np.asarray(leff, np.int64) + 1) // 64)
    off = np.zeros(len(words), np.int64)
    if len(words):
        off[1:] = np.cumsum(words)[:-1]
    return off, int(words.sum())


def smem_bytes(M: int, E: int, ring_words: int, form: str,
               shared_ring: bool) -> int:
    """Dynamic shared memory of one block: in the block form twelve int64
    counters an edge, four a module, an event slot, then two vote slots,
    the frame-end count (two ints) and a ring position a module; in both
    forms the rings after that when they are in shared memory."""
    state = 0 if form == "warp" else 8 * (12 * E + 4 * M + 1 + (M + 5) // 2)
    return state + (8 * ring_words if shared_ring else 0)


def counter_bits(sim) -> int:
    """32 where every count of a run fits an int32 (a module's launches,
    pushes and maturations at most its ``tot``; an edge's occupancy at
    most its producer's pushes; its need and consumed at most ``frames``
    frames of ``tpf`` plus a table entry), else 64.  The warp form keeps
    its counters in that many bits; capacities past the run's counts are
    never reached, so the kernel clips them."""
    tot = int(sim.tot.max()) if sim.M else 0
    need = sim.frames * (int(sim.tpf.max()) if sim.E else 0)
    if sim.need_by_hand and sim.need_buf.size:
        need += int(sim.need_buf.max())
    elif sim.E:
        need += int(sim.tpf.max())
    return 32 if max(tot, need) < _INT32_MAX else 64


def layout(sim, form: Optional[str] = None) -> dict:
    """The launch's form, threads, slots, ring placement, shared bytes and
    counter bits for ``sim``'s netlist (``form`` forces "warp" or
    "block"; the block form counts in 64 bits)."""
    M, E = sim.M, sim.E
    form = form or form_for(M, E)
    slots = warp_slots(M, E) if form == "warp" else (0, 0)
    if slots is None:
        raise ValueError(f"cycle_sim: {M} modules and {E} edges do not fit "
                         f"the warp form's {WARP_SLOTS[-1]} a lane")
    words = ring_offsets(sim.leff)[1]
    shared = smem_bytes(M, E, words, form, True) <= SMEM_LIMIT
    return {"form": form, "slots": list(slots),
            "threads": threads_for(M, E, form), "ring_words": words,
            "ring": "shared" if shared else "global",
            "smem_bytes": smem_bytes(M, E, words, form, shared),
            "counters": counter_bits(sim) if form == "warp" else 64}


def _csr(owner: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    counts = np.bincount(owner, minlength=n) if len(owner) else \
        np.zeros(n, np.int64)
    ptr = np.zeros(n + 1, np.int32)
    ptr[1:] = np.cumsum(counts)
    return ptr, np.argsort(owner, kind="stable").astype(np.int32)


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
    """``sim``'s netlist as the kernel's tensors on ``device``, cached on
    ``sim``."""
    cache = sim.__dict__.setdefault("_kernel_pack", {})
    key = (str(device), sim.need_by_hand)
    if key not in cache:
        if sim.E and max(sim.tpf.max(), sim.ot.max()) >= 2 ** 31:
            raise ValueError("cycle_sim: the kernel steps an edge's need "
                             "in 32 bits; an edge carries 2**31 tokens a "
                             "frame or more")
        if sim.M and max(sim.rnum.max(), sim.rden.max()) >= 2 ** 30:
            raise ValueError("cycle_sim: the kernel keeps rates' credit in "
                             "32 bits; a rate's terms reach 2**30")
        need_off, need_buf = _need_tables(sim)
        ot = np.maximum(sim.ot, 1)
        cols = dict(src=sim.src, dst=sim.dst, need_off=need_off,
                    tpf=sim.tpf, ot=sim.ot, qstep=sim.tpf // ot,
                    rstep=sim.tpf % ot)
        ring = ring_offsets(sim.leff)[0]
        mod = np.stack([ring if f == "ring" else
                        getattr(sim, f).astype(np.int64)
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
    its own clock, event jumps and launch-history rings."""
    _check_caps(sim, caps)
    if _checks.route("cyclesim", caps) == "cpu":
        return cycle_sim_ref(sim, caps, horizon, stall_limit, event_jump)
    return run_kernel(sim, caps, horizon, stall_limit, event_jump)


def _check_caps(sim, caps) -> None:
    if not isinstance(caps, torch.Tensor) or caps.dtype != torch.int64 \
            or caps.dim() != 2 or caps.shape[1] != sim.E:
        raise ValueError(f"cycle_sim: caps must be an int64 (K, {sim.E}) "
                         f"tensor, got {caps!r:.80}")


def run_kernel(sim, caps: torch.Tensor, horizon: int, stall_limit: int,
               event_jump: bool = True, form: Optional[str] = None,
               launcher=None
               ) -> List[Tuple[dict, List[int], Optional[int]]]:
    """The kernel on every row of ``caps`` (``cycle_sim``'s results) in
    the form ``layout`` picks, or ``form``.  ``launcher``: a
    ``cyclesim_launch`` to call in place of the built library's, on the
    default stream and uncounted: the host build of the source in the
    tests (on CPU tensors), the profiling build in
    ``launch/cycle_profile.py``."""
    _check_caps(sim, caps)
    dev = caps.device
    K, M, E = caps.shape[0], sim.M, sim.E
    F = max(sim.frames, 1)
    if K == 0:
        return []
    lay = layout(sim, form)
    shared = lay["ring"] == "shared"
    net = pack(sim, dev)
    i64 = torch.int64
    gring = torch.empty((0 if shared else K * lay["ring_words"],),
                        dtype=i64, device=dev)
    state = torch.empty((K, 6 * E + 3 * M), dtype=i64, device=dev)
    scal = torch.empty((K, len(SCALARS)), dtype=i64, device=dev)
    fe = torch.full((K, F), -1, dtype=i64, device=dev)
    ms, es = lay["slots"]
    args = (net["mod"].data_ptr(), net["edge"].data_ptr(),
            net["out_ptr"].data_ptr(), net["out_idx"].data_ptr(),
            net["in_ptr"].data_ptr(), net["in_idx"].data_ptr(),
            net["need_buf"].data_ptr(), caps.data_ptr(), gring.data_ptr(),
            state.data_ptr(), scal.data_ptr(), fe.data_ptr(), K, M, E,
            lay["ring_words"], sim.frames, horizon, stall_limit, sim.sink0,
            sim.frame_tokens, F, int(bool(event_jump)), ms, es,
            lay["threads"], lay["smem_bytes"], int(shared),
            int(lay["counters"] == 32))
    if launcher is not None:
        err = launcher(*args, None)
        if err:
            raise RuntimeError(f"cyclesim_launch: error {err}")
    else:
        fn = _build.function("cyclesim", "cyclesim_launch", _ARGTYPES)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            _build.launch("cyclesim", fn, *args, stream, form=lay["form"])
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
