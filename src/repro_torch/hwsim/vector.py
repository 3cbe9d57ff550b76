"""Packed-state cycle engine: the scalar simulator's update rule over
whole vectors of modules and edges.

``sim.CycleSim`` steps every module with Python-level bookkeeping: exact,
but tens of microseconds a cycle, a minute or more for a 1080p frame
(about 2 M cycles).  This module packs the whole simulation state into
flat integer vectors (per-edge occupancy and consumed counters, per-module
launch, push and credit counters, a ring-buffer launch history for latency
maturation, and one concatenated per-edge need lookup table) and advances
all modules and edges each cycle with one fixed sequence of operations.

The per-cycle recurrence is a faithful transcription of the scalar
engine's two phases; both engines produce bit-identical per-FIFO
high-water marks, stamps and cycle counts (``SimResult.edge_signature``).

Two routes run the recurrence, chosen by ``device``:

  - ``"cuda"`` (the default, as for every entry point of the port):
    ``csrc/cyclesim.cu`` runs the whole simulation, every cycle and every
    event jump, to its stop code inside one kernel launch
    (``kernels/cyclesim``).  It raises without a card.
  - ``"cpu"``: the plain version, the same step as per-cycle torch
    operations on int64 CPU tensors (``_step``, ``_next_event``, ``_jump``,
    ``_run_plain``).  It is slow, and it is the oracle the kernel is held
    against.

Key equivalence facts the packing relies on (all hold in the scalar
engine):

  - each edge has exactly one producer and one consumer, and phase A
    (pushes) completes before phase B (pops + launches), so neither phase
    has intra-phase ordering effects: module order inside a phase cannot
    matter, which is what makes a data-parallel update exact;
  - a module pushes at most one matured token per cycle, so the inflight
    deque can be replaced by counts: a token is pushable at cycle t iff
    ``pushed < launched_as_of(t - max(L, 1))`` (the max accounts for phase
    ordering: a latency-0 launch in phase B is first visible to phase A on
    the following cycle);
  - an edge's ``popped`` equals its ``consumed`` counter and its ``pushed``
    equals its producer's push count, so neither needs separate state.
"""
from __future__ import annotations

import copy
import math
from fractions import Fraction
from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..core.buffers import Edge
from ..core.rigel import RModule
from .occupancy import EdgeOccupancy, OccupancyTrace
from .sim import PROFILED, EdgeKey, NeedSpec, SimResult, need_spec

_INF = 2 ** 62

# stop codes of a run (the kernel reports the same numbers)
_RUNNING, _DONE, _HORIZON, _STALL = 0, 2, 3, 4


def is_cpu(device) -> bool:
    """True iff ``device`` names the host (``"cpu"`` or a CPU
    ``torch.device``); None means the card."""
    return device is not None and str(device).split(":")[0] == "cpu"


def resolve_device(device=None) -> str:
    """The device a cycle engine runs on, by the port's one rule
    (``core.lowering.resolve_device``): ``"cuda"`` unless the caller names
    ``"cpu"``; any other device, or ``"cuda"`` without a card, raises."""
    if is_cpu(device):
        return "cpu"
    from ..core.lowering import resolve_device as resolve
    return str(resolve(device))


class VectorSim:
    """Packed-state cycle simulation over a mapped module netlist.

    Construction mirrors ``sim.build_sim``: ``depths`` maps (src, dst) to
    FIFO depths (capacity = depth + 1), ``unbounded`` lifts all caps, and
    ``frames`` runs back-to-back frames with per-frame need offsets.
    ``device`` is ``"cuda"`` (None, the kernel) or ``"cpu"`` (the plain
    version)."""

    def __init__(self, modules: Sequence[RModule], edges: Sequence[Edge],
                 depths: Mapping[EdgeKey, int], unbounded: bool = False,
                 frames: int = 1, device=None):
        if frames < 1:
            raise ValueError("frames must be >= 1")
        self.device = resolve_device(device)
        self.frames = frames
        self.keys = [(e.src, e.dst) for e in edges]
        self.token_bits = [e.token_bits for e in edges]
        M, E = len(modules), len(edges)
        self.M, self.E = M, E

        i64 = np.int64
        self.src = np.array([e.src for e in edges], i64)
        self.dst = np.array([e.dst for e in edges], i64)
        self.cap = np.array(
            [_INF if unbounded else int(depths.get((e.src, e.dst), 0)) + 1
             for e in edges], i64)
        self.unbounded = unbounded

        rates = [Fraction(m.rate) if m.rate > 0 else Fraction(1)
                 for m in modules]
        self.rnum = np.array([r.numerator for r in rates], i64)
        self.rden = np.array([r.denominator for r in rates], i64)
        self.throt = np.array(
            [m.kind not in PROFILED and 0 < rates[i] < 1
             for i, m in enumerate(modules)], bool)
        self.latency = np.array([m.latency for m in modules], i64)
        self.leff = np.maximum(self.latency, 1)

        has_in = np.zeros(M, bool)
        has_out = np.zeros(M, bool)
        has_in[self.dst] = True
        has_out[self.src] = True
        self.has_out = has_out
        active = has_in | has_out
        self.active = active
        self.is_sink = active & has_in & ~has_out
        # inactive modules (Const register banks) never step: zero their
        # token budget so they are born "done"
        out_frame = np.array([m.iface_out.sched.tokens_per_frame
                              for m in modules], i64)
        self.out_frame = np.where(active, out_frame, 0)
        self.tot = self.out_frame * frames

        self.names = [m.name for m in modules]
        sink_idx = np.flatnonzero(self.is_sink)
        self.sink0 = int(sink_idx[0]) if len(sink_idx) else -1
        self.frame_tokens = (int(self.out_frame[self.sink0])
                             if self.sink0 >= 0 else 0)

        # adjacency for the plain version's two reductions: blocked (any
        # full out-edge) and unmet (any in-edge short of its need); the
        # kernel walks CSR lists instead (kernels/cyclesim)
        self.out_adj = np.zeros((M, E), i64)
        self.in_adj = np.zeros((M, E), i64)
        self.out_adj[self.src, np.arange(E)] = 1
        self.in_adj[self.dst, np.arange(E)] = 1

        # per-edge need lookup: one concatenated within-frame table, offsets
        # per edge; multi-frame needs are offset arithmetically.  The table
        # is built on first use: at 1080p it holds about 2 M entries per
        # edge, and neither the kernel (which reads only the profiled
        # edges' tables) nor the diagnosis builds it.  A table set by hand
        # (``need_buf = ...``) replaces every edge's need, on every route
        self.specs: List[NeedSpec] = [
            need_spec(modules[e.dst], modules[e.src],
                      int(out_frame[e.src])) for e in edges]
        self.need_off = np.zeros(E, i64)
        if E:
            lens = np.array([s.out_total for s in self.specs], i64)
            self.need_off[1:] = np.cumsum(lens)[:-1]
        self._need_buf: Optional[np.ndarray] = None
        self.need_by_hand = False
        self.tpf = np.array([s.tpf for s in self.specs], i64) \
            if E else np.zeros(0, i64)
        self.ot = np.array([s.out_total for s in self.specs], i64) \
            if E else np.zeros(0, i64)

        # history ring: row t % H holds the cumulative launch counts as of
        # the end of cycle t; matured(t) = row (t - leff) % H
        self.H = int(self.leff.max()) + 2 if M else 2

    @property
    def need_buf(self) -> np.ndarray:
        if self._need_buf is None:
            tables = [s.need_array() for s in self.specs]
            self._need_buf = (np.concatenate(tables).astype(np.int64)
                              if tables else np.zeros(1, np.int64))
        return self._need_buf

    @need_buf.setter
    def need_buf(self, table) -> None:
        self._need_buf = np.asarray(table, np.int64)
        self.need_by_hand = True

    def _need_at(self, e: int, kf: int) -> int:
        """Edge ``e``'s within-frame need before output ``kf``: the hand-set
        table's entry, else the edge's spec (what its table row holds)."""
        if self.need_by_hand:
            return int(self._need_buf[self.need_off[e] + kf - 1])
        return self.specs[e].need_frame(kf)

    # -- scalar-engine formulas, verbatim ------------------------------
    def _stall_limit(self) -> int:
        act = self.active
        if not act.any():
            return 65
        gaps = -(-self.rden[act] // np.maximum(1, self.rnum[act]))
        return int(self.latency[act].max()) + int(gaps.max()) + 64

    def _default_horizon(self) -> int:
        est = 0
        for m in np.flatnonzero(self.active):
            rate = Fraction(int(self.rnum[m]), int(self.rden[m]))
            est = max(est, int(self.latency[m])
                      + math.ceil(int(self.tot[m]) / rate))
        return 8 * est + 16 * self._stall_limit()

    # -- state ----------------------------------------------------------
    def _initial_state(self):
        import torch
        i64 = torch.int64

        def z(n):
            return torch.zeros(n, dtype=i64)

        return dict(
            t=0, last_progress=0,
            occ=z(self.E), consumed=z(self.E),
            kf=torch.ones(self.E, dtype=i64), fr=z(self.E),
            launched=z(self.M), pushed=z(self.M), credit=z(self.M),
            hist=torch.zeros((self.H, self.M), dtype=i64),
            hwm=z(self.E), hwm_cycle=z(self.E),
            skipped=0, saved=0,
        )

    def _plain_consts(self) -> dict:
        """The packed netlist as CPU tensors for the plain version."""
        import torch
        c = {k: torch.from_numpy(np.ascontiguousarray(getattr(self, k)))
             for k in ("src", "dst", "cap", "rnum", "rden", "throt",
                       "leff", "has_out", "active", "is_sink", "tot",
                       "out_adj", "in_adj", "need_buf", "need_off", "tpf",
                       "ot")}
        c["arange_m"] = torch.arange(self.M)
        return c

    @staticmethod
    def _need(s: dict, c: dict):
        return s["fr"] * c["tpf"] + c["need_buf"][c["need_off"] + s["kf"] - 1]

    # -- one cycle, the plain version ----------------------------------
    def _step(self, s: dict, c: dict) -> bool:
        """Advance one cycle in place; returns True if any token moved."""
        import torch
        t = s["t"]
        # --- phase A: matured tokens push downstream ---
        full = s["occ"] >= c["cap"]
        blocked = (c["out_adj"] @ full.long()) > 0
        matured = s["hist"][(t - c["leff"]) % self.H, c["arange_m"]]
        can_push = (s["pushed"] < matured) & ~blocked & c["has_out"]
        s["pushed"] = s["pushed"] + can_push
        s["occ"] = s["occ"] + can_push[c["src"]]
        new_hwm = s["occ"] > s["hwm"]
        s["hwm_cycle"] = torch.where(new_hwm, t, s["hwm_cycle"])
        s["hwm"] = torch.maximum(s["hwm"], s["occ"])
        # --- phase B: consume toward the next output, then launch ---
        done_m = s["launched"] >= c["tot"]
        done_dst = s["fr"] >= self.frames
        need = self._need(s, c)
        pop = ~done_dst & (s["consumed"] < need) & (s["occ"] > 0)
        s["occ"] = s["occ"] - pop.long()
        s["consumed"] = s["consumed"] + pop
        unmet = (s["consumed"] < need) & ~done_dst
        ready = (c["in_adj"] @ unmet.long()) == 0
        cr = s["credit"] + c["rnum"]
        launch = ready & ~done_m & c["active"] \
            & (~c["throt"] | (cr >= c["rden"]))
        s["credit"] = torch.where(
            c["throt"],
            torch.where(launch, cr - c["rden"],
                        torch.minimum(cr, c["rden"])),
            s["credit"])
        s["launched"] = s["launched"] + launch
        s["pushed"] = s["pushed"] + (launch & c["is_sink"])  # sinks absorb
        launch_e = launch[c["dst"]]
        wrap = launch_e & (s["kf"] == c["ot"])
        s["kf"] = torch.where(wrap, 1, s["kf"] + launch_e)
        s["fr"] = s["fr"] + wrap
        s["hist"][t % self.H] = s["launched"]
        s["t"] = t + 1
        return bool(can_push.any() or pop.any() or launch.any())

    # -- event-jump batching -------------------------------------------
    # During a stall plateau (a cycle with no token movement) the only
    # state that evolves is the cycle counter, the launch-history ring
    # (rewriting unchanged counts), and the throttle credit buckets
    # (min(credit + rnum, rden) per cycle).  Every enabling condition —
    # blocked, ready, pop eligibility — is therefore static until one of
    # exactly two event kinds fires:
    #
    #   * maturation: a non-blocked producer with pushed < launched becomes
    #     pushable at the first future cycle x where the ring row
    #     (x - leff) % H exceeds its push count.  Guaranteed within
    #     leff - 1 cycles: cycle t-1's row holds `launched` > pushed.
    #   * credit refill: a ready throttled module launches once its bucket
    #     reaches rden; credit after d no-op cycles is the closed form
    #     min(credit + d*rnum, rden), so the launch lands at
    #     d = max(0, ceil((rden - credit) / rnum) - 1).
    #
    # Jumping to the earliest such event (clamped to the stall-detect and
    # horizon boundaries so reported cycle counts stay bit-identical) and
    # backfilling the skipped ring rows reproduces per-cycle execution
    # exactly.
    def _next_event(self, s: dict, c: dict) -> int:
        t = s["t"]
        te = _INF
        full = s["occ"] >= c["cap"]
        blocked = (c["out_adj"] @ full.long()) > 0
        cand = c["active"] & c["has_out"] & ~blocked \
            & (s["pushed"] < s["launched"])
        for j in cand.nonzero().flatten().tolist():
            leff_j = int(self.leff[j])
            pj = int(s["pushed"][j])
            for d in range(leff_j):
                if int(s["hist"][(t + d - leff_j) % self.H, j]) > pj:
                    te = min(te, t + d)
                    break
        need = self._need(s, c)
        done_dst = s["fr"] >= self.frames
        unmet = (s["consumed"] < need) & ~done_dst
        ready = (c["in_adj"] @ unmet.long()) == 0
        done_m = s["launched"] >= c["tot"]
        cred = c["throt"] & ready & ~done_m & c["active"]
        for j in cred.nonzero().flatten().tolist():
            gap = int(self.rden[j]) - int(s["credit"][j])
            d = max(0, -(-gap // int(self.rnum[j])) - 1)
            te = min(te, t + d)
        return te

    def _jump(self, s: dict, c: dict, horizon: int, stall_limit: int
              ) -> None:
        import torch
        t = s["t"]
        ev = self._next_event(s, c)
        te = min(ev, s["last_progress"] + stall_limit + 1, horizon)
        te = max(te, t)
        dt = te - t
        if dt == 0:
            return
        if ev > te:
            # no future event before the clamp: a provably dead state —
            # these skipped cycles are the deadlock early-abort's win
            s["saved"] += dt
        # ring slot r's most recent cycle <= te-1; rows belonging to the
        # skipped cycles [t, te-1] are rewritten with the frozen counts
        r = torch.arange(self.H)
        x_r = (te - 1) - ((te - 1 - r) % self.H)
        s["hist"][x_r >= t] = s["launched"]
        s["credit"] = torch.where(
            c["throt"], torch.minimum(s["credit"] + dt * c["rnum"],
                                      c["rden"]),
            s["credit"])
        s["t"] = te
        s["skipped"] += dt

    def _run_plain(self, horizon: int, stall_limit: int,
                   event_jump: bool = True
                   ) -> Tuple[dict, List[int], Optional[int]]:
        c = self._plain_consts()
        s = self._initial_state()
        sink_done = c["is_sink"]
        frame_ends: List[int] = []
        code: Optional[int] = None
        while True:
            if bool((s["launched"] >= c["tot"])[sink_done].all()):
                break
            if s["t"] >= horizon:
                code = _HORIZON
                break
            if s["t"] - s["last_progress"] > stall_limit:
                code = _STALL
                break
            if self._step(s, c):
                s["last_progress"] = s["t"] - 1
            elif event_jump:
                # skipped cycles have no movement, so the frame-boundary
                # bookkeeping below cannot be crossed by a jump
                self._jump(s, c, horizon, stall_limit)
            if self.sink0 >= 0 and self.frame_tokens:
                while (len(frame_ends) <
                       int(s["launched"][self.sink0]) // self.frame_tokens):
                    frame_ends.append(s["t"] - 1)
        state = {k: (v.numpy() if hasattr(v, "numpy") else v)
                 for k, v in s.items() if k != "hist"}
        return state, frame_ends, code

    # -- diagnosis (stalled runs) --------------------------------------
    def _diagnose(self, s: dict, cap: Optional[np.ndarray] = None) -> str:
        """``cap`` overrides the per-edge capacities (PopulationSim runs
        many capacity vectors over this one packed netlist)."""
        if cap is None:
            cap = self.cap
        why = []
        need = s["fr"] * self.tpf + np.array(
            [self._need_at(e, int(s["kf"][e])) for e in range(self.E)],
            np.int64)
        inflight = s["launched"] - s["pushed"]
        for m in range(self.M):
            if not self.active[m]:
                continue
            if s["launched"][m] >= self.tot[m] and inflight[m] <= 0:
                continue
            starved = [self.keys[e] for e in np.flatnonzero(self.dst == m)
                       if s["launched"][m] < self.tot[m]
                       and s["consumed"][e] < need[e] and s["occ"][e] == 0]
            full = [self.keys[e] for e in np.flatnonzero(self.src == m)
                    if inflight[m] > 0 and not self.unbounded
                    and s["occ"][e] >= cap[e]]
            if starved or full:
                why.append(f"{self.names[m]}[{m}]"
                           + (f" starved on {starved}" if starved else "")
                           + (f" blocked on full {full}" if full else ""))
        return "; ".join(why) or "no token movement"

    # -- entry ----------------------------------------------------------
    def run(self, max_cycles: Optional[int] = None,
            event_jump: bool = True) -> SimResult:
        """Simulate to completion, the horizon (``max_cycles``, default a
        generous multiple of the analytic run time) or a stall, on the
        card (one kernel launch) or, for ``device="cpu"``, by the plain
        version."""
        import torch
        from ..kernels.cyclesim import cycle_sim
        horizon = max_cycles or self._default_horizon()
        stall_limit = self._stall_limit()
        caps = torch.from_numpy(self.cap[None].copy()).to(self.device)
        ((s, frame_ends, code),) = cycle_sim(
            self, caps, horizon, stall_limit, event_jump)
        return self._result(s, frame_ends, code, horizon)

    def _result(self, s: dict, frame_ends: List[int], code: Optional[int],
                horizon: int, cap: Optional[np.ndarray] = None,
                engine: str = "vector") -> SimResult:
        """The SimResult of one final state (``cap``: the run's capacities
        when they are not this netlist's own)."""
        if cap is None:
            cap = self.cap
        t = int(s["t"])
        deadlock = None
        if code == _HORIZON:
            deadlock = f"horizon exceeded ({horizon} cycles)"
        elif code == _STALL:
            deadlock = self._diagnose(s, cap=cap)
        fe = np.asarray(frame_ends, np.int64)
        # frame stamp of a mark = frames drained at the sink when it was
        # reached (same definition the scalar engine tracks inline)
        hwm_frame = np.searchsorted(fe, s["hwm_cycle"], side="left") \
            if len(fe) else np.zeros(self.E, np.int64)
        pushed_e = s["pushed"][self.src]
        per_edge = [EdgeOccupancy(
            self.keys[e], None if self.unbounded else int(cap[e]) - 1,
            int(s["hwm"][e]), int(s["hwm_cycle"][e]), int(pushed_e[e]),
            int(s["consumed"][e]), self.token_bits[e],
            hwm_frame=int(hwm_frame[e])) for e in range(self.E)]
        occ = OccupancyTrace(per_edge, t)
        sink_tokens = int(s["launched"][self.is_sink].sum())
        return SimResult(t, sink_tokens, deadlock, occ, frames=self.frames,
                         frame_ends=[int(x) for x in frame_ends],
                         engine=engine,
                         cycles_skipped=int(s["skipped"]),
                         cycles_saved=int(s["saved"]))

    def with_caps(self, cap: np.ndarray) -> "VectorSim":
        """A VectorSim sharing this packed netlist with the per-edge
        capacities ``cap`` (no need tables re-derived)."""
        vs = copy.copy(self)
        vs.cap = np.asarray(cap, np.int64)
        return vs
