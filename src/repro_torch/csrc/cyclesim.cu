// The cycle kernel: whole cycle-level dataflow simulations of one packed
// module netlist, one design (a FIFO capacity vector) a block.
//
// Replaces the reference's two XLA loops, not a Pallas kernel:
// src/repro/hwsim/vector.py::_segment_impl (one design, run in per-frame
// segments) and src/repro/hwsim/population.py::_pop_impl (K designs on
// one global clock).  Here every design keeps its own clock and makes its
// own event jumps, inside one launch, to its stop code; frame ends are
// recorded in the kernel at the crossing cycle.  The recurrence is the
// plain version's (hwsim/vector.py: _step, _next_event, _jump, _run_plain),
// and the results are bit-identical to it and to the scalar engine.
//
// What bounds it: a simulated cycle is a chain of dependent phases (push,
// pop, launch, the vote that ends the cycle) over tens of modules and
// edges.  There is no roofline: the floor is the chain's latency (four
// ballots a cycle in the warp form) and the instructions one warp issues
// a cycle.  Measured on an H100 (launch/cycle_profile.py), the earlier
// block-per-design kernel spent about 4,400 SM clocks a cycle behind five
// block barriers, a launch-history ring of int64 counts in global memory
// (an L2 round trip, ~290 clocks) and emulated 64-bit divisions (~200
// clocks each).  This design:
//
//   - Launch history as per-module bit rings.  `launched` grows by at most
//     one a cycle, so module m's matured count (launches as of cycle
//     t - leff) is a running count plus a ring of leff + 1 launch bits.
//     Rings start at word-aligned offsets (packed on the host) and live in
//     shared memory, or in global memory when they do not fit (the
//     kSharedRing template parameter; the host picks it by size).  Ring
//     positions are wrapped counters; the event jump's maturation search
//     is a find-first-set over the ring's words, and a jump clears the
//     skipped cycles' bits (they had no launches).
//   - No 64-bit division on a cycle's chain.  A proportional edge's need,
//     ceil(kf * tpf / ot), is stepped by a quotient and remainder (tpf div
//     ot, tpf mod ot, packed on the host) when its consumer launches; a
//     profiled edge reads its table entry then, one launch ahead.  Frame
//     ends compare the sink's launches with a next-boundary counter.  Only
//     the jump's credit refill divides.
//   - The warp form (cyclesim_warp_kernel): one warp a design wherever the
//     netlist fits MS modules and ES edges a lane.  Each lane keeps its
//     modules' and edges' state in registers; phases exchange 32-bit
//     ballots (pushes, pops, unmet needs, full FIFOs, launches, the done
//     flag), no barrier.  A module reads its blocked and ready conditions
//     from masks of its out- and in-edges built once at the start.  Ring
//     words are loaded a phase ahead of their use, the need step has no
//     branch, and the counters are 32 bits wide wherever a run's counts
//     fit (the template's C; 64 bits otherwise).
//   - The block form (cyclesim_block_kernel), for larger netlists: modules
//     over the block's threads with a block stride, state in shared memory,
//     two barriers a cycle.  Each module lands its pushes on its out-edges
//     in the first phase, and pops its in-edges and steps their needs in
//     the second (an edge has one producer and one consumer).
//
// Python's % and // are not C's: floor_div below gives Python's result
// for the credit refill.  Cycle counts are int64: 2^62 is the sentinel of
// an absent event, and sums like last_progress + stall_limit + 1 stay far
// below overflow.
#include <cuda_runtime.h>

#include "cyc_profile.cuh"

#ifndef CYC_LAUNCH
#define CYC_LAUNCH(kern, grid, block, smem, stream, ...) \
  kern<<<grid, block, smem, stream>>>(__VA_ARGS__)
#endif

namespace {

typedef long long i64;
typedef unsigned long long u64;
typedef unsigned int u32;

constexpr i64 kInf = 1LL << 62;
constexpr u32 kAll = 0xffffffffu;
enum : int { kRunning = 0, kDone = 2, kHorizon = 3, kStall = 4 };
// packed constants, in kernels/cyclesim/ops.py's field order
enum : int { MF_RNUM, MF_RDEN, MF_THROT, MF_LEFF, MF_HAS_OUT, MF_ACTIVE,
             MF_IS_SINK, MF_TOT, MF_RING, MF_N };
enum : int { EF_SRC, EF_DST, EF_NEED_OFF, EF_TPF, EF_OT, EF_QSTEP, EF_RSTEP,
             EF_N };
enum : int { S_T, S_LAST, S_SKIPPED, S_SAVED, S_CODE, S_NFE, S_N };
// a module's flags
enum : int { F_THROT = 1, F_HAS_OUT = 2, F_ACTIVE = 4, F_SINK = 8 };

struct Net {
  const i64* mod;        // M x MF_N
  const i64* edge;       // E x EF_N
  const int* out_ptr;    // M + 1: module m's out-edges are
  const int* out_idx;    //   out_idx[out_ptr[m] .. out_ptr[m+1])
  const int* in_ptr;     // M + 1, the same for in-edges
  const int* in_idx;
  const i64* need_buf;   // the profiled edges' within-frame need tables
  int M, E;
  i64 ring_words, frames, horizon, stall_limit, sink0, frame_tokens, F;
  int jump;
};

__device__ __forceinline__ i64 floor_div(i64 a, i64 b) {
  i64 q = a / b;
  return ((a % b) != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ i64 ceil_div(i64 a, i64 b) {
  return -floor_div(-a, b);
}

__device__ __forceinline__ i64 mf(const Net& n, int m, int f) {
  return __ldg(n.mod + (i64)m * MF_N + f);
}

__device__ __forceinline__ i64 ef(const Net& n, int e, int f) {
  return __ldg(n.edge + (i64)e * EF_N + f);
}

__device__ __forceinline__ int flags_of(const Net& n, int m) {
  return (mf(n, m, MF_THROT) ? F_THROT : 0)
      | (mf(n, m, MF_HAS_OUT) ? F_HAS_OUT : 0)
      | (mf(n, m, MF_ACTIVE) ? F_ACTIVE : 0)
      | (mf(n, m, MF_IS_SINK) ? F_SINK : 0);
}

// ---- the launch-history bit rings -------------------------------------
// Module m's ring holds R = leff + 1 bits from word MF_RING.  With p the
// position of cycle t's bit, cycle t - leff sits at p + 1 (mod R), and at
// the top of cycle t `matured` counts the launches of cycles <= t - leff.

// Calls f(word, mask, first bit, offset in the range) for each word piece
// of the circular range [start, start + len) of an R-bit ring (start < R,
// len <= R), in order; stops when f returns true.
template <typename F>
__device__ __forceinline__ void ring_pieces(int R, int start, int len, F f) {
  int pos = start, off = 0;
  while (off < len) {
    const int run = min(len - off, R - pos);       // bits before the wrap
    for (int b = pos; b < pos + run;) {
      const int sh = b & 63;
      const int take = min(pos + run - b, 64 - sh);
      const u64 mask = (take == 64 ? ~0ULL : ((1ULL << take) - 1)) << sh;
      if (f(b >> 6, mask, sh, off + (b - pos))) return;
      b += take;
    }
    off += run;
    pos = 0;
  }
}

// offset of the first set bit in the range, or -1
__device__ __forceinline__ int ring_ffs(const u64* w, int R, int start,
                                        int len) {
  int found = -1;
  ring_pieces(R, start, len, [&](int wi, u64 mask, int sh, int off) {
    const u64 bits = w[wi] & mask;
    if (bits) found = off + (__ffsll((long long)bits) - 1 - sh);
    return bits != 0;
  });
  return found;
}

// cycle t's launch bit goes in at p; p moves to cycle t + 1, and the bit
// of cycle t + 1 - leff (p + 1) matures
__device__ __forceinline__ void ring_step(u64* w, int R, int& p, int bit,
                                          i64& matured) {
  const u64 b = 1ULL << (p & 63);
  u64& word = w[p >> 6];
  word = bit ? (word | b) : (word & ~b);
  p = p + 1 == R ? 0 : p + 1;
  const int q = p + 1 == R ? 0 : p + 1;
  matured += (i64)((w[q >> 6] >> (q & 63)) & 1);
}

// an event jump over dt cycles with no launch: the bits of cycles up to
// te - leff mature, the skipped cycles' positions are cleared, and p moves
// on (with dt >= R the whole ring is clear and any position serves)
__device__ __forceinline__ void ring_skip(u64* w, int R, int& p, i64 dt,
                                          i64& matured) {
  const int cnt = (int)min(dt, (i64)(R - 2));     // in flight: leff - 1
  if (cnt > 0) {
    int s = p + 2;
    if (s >= R) s -= R;
    int c = 0;
    ring_pieces(R, s, cnt, [&](int wi, u64 mask, int, int) {
      c += __popcll(w[wi] & mask);
      return false;
    });
    matured += c;
  }
  ring_pieces(R, p, (int)min(dt, (i64)R), [&](int wi, u64 mask, int, int) {
    w[wi] &= ~mask;
    return false;
  });
  if (dt < R) {
    p += (int)dt;
    if (p >= R) p -= R;
  }
}

// the offset from cycle t - leff of the first launch among cycles
// t - leff .. t - 1, the ones a candidate has not pushed yet (the plain
// version's scan of the ring, _next_event)
__device__ __forceinline__ int ring_next_maturation(const u64* w, int R,
                                                    int p) {
  return ring_ffs(w, R, p + 1 == R ? 0 : p + 1, R - 1);
}

// ---- needs --------------------------------------------------------------
// Edge e's need before its consumer's kf-th output of frame fr: fr * tpf
// (base) plus the within-frame need, -1 once fr reaches the run's frames
// (nothing more is popped or awaited).  A proportional edge keeps
// kf * tpf as q * ot + r; a profiled edge keeps its next table entry,
// loaded at one launch and used at the next, with the table fetched
// ahead into L1.  Within a frame every count fits 32 bits (the host
// checks tpf and ot); C is the run's counter type (int where every count
// of the run fits, the host's `counters`).
template <typename C>
struct NeedState {
  int kf, q, r, fr;
  C base, nextw;
};

// entries of a profiled edge's table fetched ahead into L1
constexpr int kTableAhead = 64;

__device__ __forceinline__ i64 table_at(const Net& n, i64 off, int kf) {
  return __ldg(n.need_buf + off + kf - 1);
}

__device__ __forceinline__ int next_kf(int kf, int ot) {
  return kf == ot ? 1 : kf + 1;
}

template <typename C>
__device__ __forceinline__ C need_init(const Net& n, NeedState<C>& s,
                                       i64 off, int tpf, int ot, int qs,
                                       int rs) {
  s.kf = 1; s.fr = 0; s.base = 0; s.q = qs; s.r = rs; s.nextw = 0;
  C within;
  if (off >= 0) {
    within = (C)table_at(n, off, 1);
    s.nextw = (C)table_at(n, off, next_kf(1, ot));
  } else {
    within = (C)min(tpf, s.q + (s.r > 0));
  }
  return n.frames > 0 ? within : (C)-1;
}

// the consumer launched (adv): the next output index, wrapping frames;
// returns the new need (the old one without adv).  No branch: the lanes
// of a warp differ in whether their consumer launched, wraps and is
// profiled
template <typename C>
__device__ __forceinline__ C need_select(const Net& n, NeedState<C>& s,
                                        bool adv, C need, i64 off, int tpf,
                                        int ot, int qs, int rs) {
  const bool wrap = s.kf == ot;
  int q = wrap ? qs : s.q + qs;
  int r = wrap ? rs : s.r + rs;
  const bool carry = r >= ot;
  q += carry;
  r -= carry ? ot : 0;
  const int kf = wrap ? 1 : s.kf + 1;
  const int fr = s.fr + wrap;
  const C base = wrap ? s.base + tpf : s.base;
  const C within = off >= 0 ? s.nextw : (C)min(tpf, q + (r > 0));
  if (adv && off >= 0) {
    s.nextw = (C)table_at(n, off, next_kf(kf, ot));
#ifdef __CUDA_ARCH__
    asm volatile("prefetch.global.L1 [%0];"
                 :: "l"(n.need_buf + off + min(kf + kTableAhead, ot) - 1));
#endif
  }
  if (!adv) return need;
  s.kf = kf; s.fr = fr; s.base = base; s.q = q; s.r = r;
  return fr >= n.frames ? (C)-1 : base + within;
}

// ---- warp-wide helpers ----------------------------------------------------
__device__ __forceinline__ u64 warp_min_u64(u64 v) {
  const u32 hi = __reduce_min_sync(kAll, (u32)(v >> 32));
  const u32 lo = __reduce_min_sync(kAll, (u32)(v >> 32) == hi ? (u32)v : kAll);
  return ((u64)hi << 32) | lo;
}

template <int N>
__device__ __forceinline__ u32 pick(const u32 (&w)[N], int i) {
  u32 r = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) r = k == i ? w[k] : r;
  return r;
}

// bit b of a mask spread over words (0 for b < 0)
template <int N>
__device__ __forceinline__ int bit_of(const u32 (&w)[N], int b) {
  return b >= 0 ? (int)((pick(w, b >> 5) >> (b & 31)) & 1) : 0;
}

// the event jump's target (the plain version's _jump), from the warp- or
// block-wide earliest event offset d (~0 for none): advances t, skipped
// and saved; returns the cycles skipped (0 for none)
__device__ __forceinline__ i64 jump_target(const Net& n, u64 d, i64& t,
                                           i64 lastp, i64& skipped,
                                           i64& saved) {
  const i64 ev = d == ~0ULL ? kInf : t + (i64)d;
  i64 te = min(min(ev, lastp + n.stall_limit + 1), n.horizon);
  te = max(te, t);
  const i64 dt = te - t;
  if (dt > 0) {
    if (ev > te) saved += dt;     // no event before the clamp: a dead state
    t = te;
    skipped += dt;
  }
  return dt;
}

// the earliest credit refill of a throttled module that is ready: the
// launch lands after d no-op cycles
__device__ __forceinline__ u64 credit_event(i64 rnum, i64 rden, i64 credit) {
  return (u64)max(0LL, ceil_div(rden - credit, rnum) - 1);
}

// ---- the warp form ------------------------------------------------------
template <int MS, int ES, bool kSharedRing, typename C>
__global__ void __launch_bounds__(32)
cyclesim_warp_kernel(Net n, const i64* __restrict__ caps,
                     u64* __restrict__ gring, i64* __restrict__ state,
                     i64* __restrict__ scal, i64* __restrict__ fe) {
  extern __shared__ __align__(16) unsigned char cyc_smem[];
  const int lane = threadIdx.x;
  const int M = n.M, E = n.E;
  const int k = blockIdx.x;
  u64* ring = kSharedRing ? reinterpret_cast<u64*>(cyc_smem)
                          : gring + (i64)k * n.ring_words;
  for (i64 i = lane; i < n.ring_words; i += 32) ring[i] = 0;
  const i64* cap = caps + (i64)k * E;

  // modules lane, lane + 32, ...: state and constants in registers
  C launched[MS], pushed[MS], matured[MS], tot[MS];
  int credit[MS], rnum[MS], rden[MS];      // rates below 2^30 (the host's)
  int flags[MS], R[MS], p[MS], rb[MS];
  // the ring word holding position p (written through every cycle), and
  // the word and bit of the next cycle's maturing launch, loaded at the
  // end of phase B and added at the top of the next cycle
  u64 wv[MS], rv[MS];
  int rsh[MS];
  u32 outm[MS][ES], inm[MS][ES];
#pragma unroll
  for (int i = 0; i < MS; ++i) {
    const int m = lane + 32 * i;
    const bool ok = m < M;
    launched[i] = 0; pushed[i] = 0; credit[i] = 0; matured[i] = 0;
    tot[i] = ok ? (C)mf(n, m, MF_TOT) : 0;
    rnum[i] = ok ? (int)mf(n, m, MF_RNUM) : 1;
    rden[i] = ok ? (int)mf(n, m, MF_RDEN) : 1;
    flags[i] = ok ? flags_of(n, m) : 0;
    R[i] = ok ? (int)mf(n, m, MF_LEFF) + 1 : 2;
    rb[i] = ok ? (int)mf(n, m, MF_RING) : 0;
    p[i] = 0;
    wv[i] = 0; rv[i] = 0; rsh[i] = 0;
#pragma unroll
    for (int j = 0; j < ES; ++j) { outm[i][j] = 0; inm[i][j] = 0; }
  }
  for (int e = 0; e < E; ++e) {
    const int s = (int)ef(n, e, EF_SRC), d = (int)ef(n, e, EF_DST);
    const u32 b = 1u << (e & 31);
#pragma unroll
    for (int i = 0; i < MS; ++i) {
      const int m = lane + 32 * i;
#pragma unroll
      for (int j = 0; j < ES; ++j) {
        if ((e >> 5) == j && s == m) outm[i][j] |= b;
        if ((e >> 5) == j && d == m) inm[i][j] |= b;
      }
    }
  }
  // edges lane, lane + 32, ...: a slot past E is inert (no producer or
  // consumer, need -1, never full)
  C occ[ES], cons[ES], need[ES], hwm[ES], ecap[ES];
  i64 hwmc[ES], off[ES];
  int tpf[ES], ot[ES], qs[ES], rs[ES];
  int src[ES], dst[ES];
  NeedState<C> ns[ES];
  // a capacity past every count of the run is never reached
  const i64 cmax = sizeof(C) == 4 ? 0x7fffffffLL : kInf;
  u32 full[ES], unmet[ES];
#pragma unroll
  for (int j = 0; j < ES; ++j) {
    const int e = lane + 32 * j;
    const bool ok = e < E;
    ns[j] = NeedState<C>{1, 0, 0, 0, 0, 0};
    occ[j] = 0; cons[j] = 0; hwm[j] = 0; hwmc[j] = 0;
    ecap[j] = (C)(ok ? min(__ldg(cap + e), cmax) : cmax);
    src[j] = ok ? (int)ef(n, e, EF_SRC) : -1;
    dst[j] = ok ? (int)ef(n, e, EF_DST) : -1;
    off[j] = ok ? ef(n, e, EF_NEED_OFF) : -1;
    tpf[j] = ok ? (int)ef(n, e, EF_TPF) : 0;
    ot[j] = ok ? (int)ef(n, e, EF_OT) : 1;
    qs[j] = ok ? (int)ef(n, e, EF_QSTEP) : 0;
    rs[j] = ok ? (int)ef(n, e, EF_RSTEP) : 0;
    need[j] = ok ? need_init<C>(n, ns[j], off[j], tpf[j], ot[j], qs[j],
                                rs[j])
                 : (C)-1;
    full[j] = __ballot_sync(kAll, 0 >= ecap[j]);
  }
  int nd0 = 0;
#pragma unroll
  for (int i = 0; i < MS; ++i)
    nd0 |= (flags[i] & F_SINK) && tot[i] > 0;
  int notdone = __any_sync(kAll, nd0);
  __syncwarp();          // the rings are clear

  // per-design scalars: every lane holds the same values
  i64 t = 0, lastp = 0, skipped = 0, saved = 0, nfe = 0, sinkl = 0;
  i64 next_fb = n.frame_tokens;
  const bool frame_ends = n.sink0 >= 0 && n.frame_tokens > 0;
  int code = kRunning;
  CYC_PROF_BEGIN;
  while (true) {
    // stop codes, checked before each cycle: DONE, HORIZON, STALL
    if (!notdone) { code = kDone; break; }
    if (t >= n.horizon) { code = kHorizon; break; }
    if (t - lastp > n.stall_limit) { code = kStall; break; }
    CYC_STAMP(0); CYC_LOOP();
    // phase A, modules: a matured token pushes unless an out-edge is full
    u32 pushm[MS];
    int moved = 0;
#pragma unroll
    for (int i = 0; i < MS; ++i) {
      matured[i] += (C)((rv[i] >> rsh[i]) & 1);
      u32 blk = 0;
#pragma unroll
      for (int j = 0; j < ES; ++j) blk |= outm[i][j] & full[j];
      const int cp = (flags[i] & F_HAS_OUT) && !blk
          && pushed[i] < matured[i];
      pushed[i] += cp;
      pushm[i] = __ballot_sync(kAll, cp);
      moved |= pushm[i] != 0;
    }
    CYC_STAMP(1);
    // edges: the push lands, high-water mark, then a pop toward the need
    int popped = 0;
#pragma unroll
    for (int j = 0; j < ES; ++j) {
      C o = occ[j] + bit_of(pushm, src[j]);
      if (o > hwm[j]) { hwm[j] = o; hwmc[j] = t; }
      const int pop = cons[j] < need[j] && o > 0;
      o -= pop;
      cons[j] += pop;
      occ[j] = o;
      popped |= pop;
      unmet[j] = __ballot_sync(kAll, cons[j] < need[j]);
      full[j] = __ballot_sync(kAll, o >= ecap[j]);
    }
    moved |= __ballot_sync(kAll, popped) != 0;
    CYC_STAMP(2);
    // phase B, modules: launch when every in-edge is met and credit allows
    u32 launchm[MS];
    int nd = 0;
#pragma unroll
    for (int i = 0; i < MS; ++i) {
      u32 wait = 0;
#pragma unroll
      for (int j = 0; j < ES; ++j) wait |= inm[i][j] & unmet[j];
      const int throt = flags[i] & F_THROT;
      const int c = credit[i] + rnum[i];
      const int launch = (flags[i] & F_ACTIVE) && !wait
          && launched[i] < tot[i] && (!throt || c >= rden[i]);
      if (throt) credit[i] = launch ? c - rden[i] : min(c, rden[i]);
      launched[i] += launch;
      if (flags[i] & F_SINK) {
        pushed[i] += launch;                       // sinks absorb
        nd |= launched[i] < tot[i];
      }
      launchm[i] = __ballot_sync(kAll, launch);
      moved |= launchm[i] != 0;
      {
        // cycle t's launch bit goes in at p; p moves to cycle t + 1, and
        // the bit of cycle t + 1 - leff (p + 1) is loaded for the next
        // cycle (with leff = 1 it is the bit just stored).  A slot past M
        // (ring 0, R 2) reads and stores nothing of use: no store
        u64* w = ring + rb[i];
        const u64 b = 1ULL << (p[i] & 63);
        const u64 word = launch ? (wv[i] | b) : (wv[i] & ~b);
        const int old = p[i] >> 6;
        if (lane + 32 * i < M) w[old] = word;
        p[i] = p[i] + 1 == R[i] ? 0 : p[i] + 1;
        const int q = p[i] + 1 == R[i] ? 0 : p[i] + 1;
        wv[i] = (p[i] >> 6) == old ? word : w[p[i] >> 6];
        rv[i] = w[q >> 6];
        rsh[i] = q & 63;
      }
    }
    notdone = __ballot_sync(kAll, nd) != 0;
    CYC_STAMP(3);
    // edges: a launch advances the consumer's output index
#pragma unroll
    for (int j = 0; j < ES; ++j)
      need[j] = need_select(n, ns[j], bit_of(launchm, dst[j]), need[j],
                            off[j], tpf[j], ot[j], qs[j], rs[j]);
    // frame ends: the sink launches at most one token a cycle
    if (frame_ends && bit_of(launchm, (int)n.sink0) && ++sinkl == next_fb) {
      if (lane == 0 && nfe < n.F) fe[(i64)k * n.F + nfe] = t;
      ++nfe;
      next_fb += n.frame_tokens;
    }
    CYC_STAMP(4);
    t += 1;
    if (moved) {
      lastp = t - 1;
    } else if (n.jump) {
      // event jump: every enabling condition is frozen until the earliest
      // maturation or credit refill (the plain version's _next_event)
#pragma unroll
      for (int j = 0; j < ES; ++j)
        unmet[j] = __ballot_sync(kAll, cons[j] < need[j]);
      u64 d = ~0ULL;
#pragma unroll
      for (int i = 0; i < MS; ++i) {
        // the pending bit (cycle t - leff) joins the count now
        matured[i] += (C)((rv[i] >> rsh[i]) & 1);
        rv[i] = 0;
        const int f = flags[i];
        u32 blk = 0, wait = 0;
#pragma unroll
        for (int j = 0; j < ES; ++j) {
          blk |= outm[i][j] & full[j];
          wait |= inm[i][j] & unmet[j];
        }
        if ((f & F_ACTIVE) && (f & F_HAS_OUT) && !blk
            && pushed[i] < launched[i]) {
          const int dm = ring_next_maturation(ring + rb[i], R[i], p[i]);
          if (dm >= 0) d = min(d, (u64)dm);
        }
        if ((f & F_THROT) && (f & F_ACTIVE) && !wait
            && launched[i] < tot[i])
          d = min(d, credit_event(rnum[i], rden[i], credit[i]));
      }
      const i64 dt = jump_target(n, warp_min_u64(d), t, lastp, skipped,
                                 saved);
      if (dt > 0) {
#pragma unroll
        for (int i = 0; i < MS; ++i) {
          if (lane + 32 * i < M) {
            i64 mt = matured[i];
            ring_skip(ring + rb[i], R[i], p[i], dt, mt);
            matured[i] = (C)mt;
            wv[i] = ring[rb[i] + (p[i] >> 6)];
          }
          if (flags[i] & F_THROT)
            credit[i] = (int)min(credit[i] + dt * rnum[i], (i64)rden[i]);
        }
      }
    }
    CYC_STAMP(5);
  }
  CYC_PROF_END;

  i64* st = state + (i64)k * (6 * E + 3 * M);
#pragma unroll
  for (int j = 0; j < ES; ++j) {
    const int e = lane + 32 * j;
    if (e < E) {
      st[e] = occ[j];
      st[E + e] = cons[j];
      st[2 * E + e] = ns[j].kf;
      st[3 * E + e] = ns[j].fr;
      st[4 * E + e] = hwm[j];
      st[5 * E + e] = hwmc[j];
    }
  }
#pragma unroll
  for (int i = 0; i < MS; ++i) {
    const int m = lane + 32 * i;
    if (m < M) {
      st[6 * E + m] = launched[i];
      st[6 * E + M + m] = pushed[i];
      st[6 * E + 2 * M + m] = credit[i];
    }
  }
  if (lane == 0) {
    i64* sc = scal + (i64)k * S_N;
    sc[S_T] = t;
    sc[S_LAST] = lastp;
    sc[S_SKIPPED] = skipped;
    sc[S_SAVED] = saved;
    sc[S_CODE] = code;
    sc[S_NFE] = nfe;
  }
}

// ---- the block form -----------------------------------------------------
// Shared memory: the per-edge counters, the per-module counters, the
// event slot, two vote slots, the frame-end count, the ring positions,
// then the rings (kSharedRing).  kernels/cyclesim/ops.py::smem_bytes
// mirrors this layout.
template <bool kSharedRing>
__global__ void cyclesim_block_kernel(Net n, const i64* __restrict__ caps,
                                      u64* __restrict__ gring,
                                      i64* __restrict__ state,
                                      i64* __restrict__ scal,
                                      i64* __restrict__ fe) {
  extern __shared__ __align__(16) unsigned char cyc_smem[];
  const int M = n.M, E = n.E;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int k = blockIdx.x;
  i64* occ = reinterpret_cast<i64*>(cyc_smem);
  i64* cons = occ + E;
  i64* need = cons + E;
  i64* kf = need + E;
  i64* fr = kf + E;
  i64* base = fr + E;
  i64* q = base + E;
  i64* r = q + E;
  i64* nextw = r + E;
  i64* hwm = nextw + E;
  i64* hwmc = hwm + E;
  i64* ecap = hwmc + E;
  i64* launched = ecap + E;
  i64* pushed = launched + M;
  i64* credit = pushed + M;
  i64* matured = credit + M;
  u64* s_ev = reinterpret_cast<u64*>(matured + M);
  int* s_vote = reinterpret_cast<int*>(s_ev + 1);   // 2 slots
  int* s_nfe = s_vote + 2;
  int* pos = s_nfe + 2;                              // M ring positions
  u64* ring = kSharedRing
      ? reinterpret_cast<u64*>(cyc_smem) + 12 * E + 4 * M + 1 + (M + 5) / 2
      : gring + (i64)k * n.ring_words;
  for (i64 i = tid; i < n.ring_words; i += nt) ring[i] = 0;
  const i64* cap = caps + (i64)k * E;

  for (int e = tid; e < E; e += nt) {
    NeedState<i64> s;
    need[e] = need_init<i64>(n, s, ef(n, e, EF_NEED_OFF),
                             (int)ef(n, e, EF_TPF), (int)ef(n, e, EF_OT),
                             (int)ef(n, e, EF_QSTEP),
                             (int)ef(n, e, EF_RSTEP));
    kf[e] = s.kf; fr[e] = s.fr; base[e] = s.base; q[e] = s.q; r[e] = s.r;
    nextw[e] = s.nextw;
    occ[e] = 0; cons[e] = 0; hwm[e] = 0; hwmc[e] = 0;
    ecap[e] = __ldg(cap + e);
  }
  int nd = 0;
  for (int m = tid; m < M; m += nt) {
    launched[m] = 0; pushed[m] = 0; credit[m] = 0; matured[m] = 0;
    pos[m] = 0;
    if (mf(n, m, MF_IS_SINK) && mf(n, m, MF_TOT) > 0) nd = 1;
  }
  if (tid == 0) {
    *s_ev = ~0ULL;
    s_vote[0] = 0; s_vote[1] = 0;
    *s_nfe = 0;
  }
  int notdone = __syncthreads_or(nd);

  // per-design scalars: every thread holds the same values
  i64 t = 0, lastp = 0, skipped = 0, saved = 0;
  i64 sinkl = 0, next_fb = n.frame_tokens;     // the sink0 thread's
  const bool frame_ends = n.sink0 >= 0 && n.frame_tokens > 0;
  int code = kRunning, it = 0;
  CYC_PROF_BEGIN;
  while (true) {
    if (!notdone) { code = kDone; break; }
    if (t >= n.horizon) { code = kHorizon; break; }
    if (t - lastp > n.stall_limit) { code = kStall; break; }
    CYC_STAMP(0); CYC_LOOP();
    // phase A, modules: a matured token pushes unless an out-edge is full,
    // and lands on every out-edge (high-water mark)
    int act = 0;
    for (int m = tid; m < M; m += nt) {
      const int j0 = __ldg(n.out_ptr + m), j1 = __ldg(n.out_ptr + m + 1);
      int blocked = 0;
      for (int j = j0; j < j1; ++j) {
        const int e = __ldg(n.out_idx + j);
        blocked |= occ[e] >= ecap[e];
      }
      if (mf(n, m, MF_HAS_OUT) && !blocked && pushed[m] < matured[m]) {
        pushed[m] += 1;
        for (int j = j0; j < j1; ++j) {
          const int e = __ldg(n.out_idx + j);
          const i64 o = occ[e] + 1;
          occ[e] = o;
          if (o > hwm[e]) { hwm[e] = o; hwmc[e] = t; }
        }
        act = 1;
      }
    }
    __syncthreads();
    CYC_STAMP(1);
    // phase B, modules: pop each in-edge toward its need, launch when every
    // in-edge is met and credit allows, then step the in-edges' needs
    nd = 0;
    for (int m = tid; m < M; m += nt) {
      const int j0 = __ldg(n.in_ptr + m), j1 = __ldg(n.in_ptr + m + 1);
      int ready = 1;
      for (int j = j0; j < j1; ++j) {
        const int e = __ldg(n.in_idx + j);
        const i64 o = occ[e], c = cons[e], nd_e = need[e];
        const int pop = c < nd_e && o > 0;
        if (pop) { occ[e] = o - 1; cons[e] = c + 1; act = 1; }
        ready &= !(c + pop < nd_e);
      }
      const i64 l = launched[m], tot = mf(n, m, MF_TOT);
      const i64 rden = mf(n, m, MF_RDEN);
      const int throt = (int)mf(n, m, MF_THROT);
      const i64 c = credit[m] + mf(n, m, MF_RNUM);
      const int launch = ready && l < tot && mf(n, m, MF_ACTIVE)
          && (!throt || c >= rden);
      if (throt) credit[m] = launch ? c - rden : min(c, rden);
      launched[m] = l + launch;
      int p = pos[m];
      ring_step(ring + mf(n, m, MF_RING), (int)mf(n, m, MF_LEFF) + 1, p,
                launch, matured[m]);
      pos[m] = p;
      if (mf(n, m, MF_IS_SINK)) {
        pushed[m] += launch;                       // sinks absorb
        nd |= l + launch < tot;
      }
      if (launch) {
        act = 1;
        for (int j = j0; j < j1; ++j) {
          const int e = __ldg(n.in_idx + j);
          NeedState<i64> s{(int)kf[e], (int)q[e], (int)r[e], (int)fr[e],
                           base[e], nextw[e]};
          need[e] = need_select(n, s, true, need[e], ef(n, e, EF_NEED_OFF),
                                (int)ef(n, e, EF_TPF), (int)ef(n, e, EF_OT),
                                (int)ef(n, e, EF_QSTEP),
                                (int)ef(n, e, EF_RSTEP));
          kf[e] = s.kf; fr[e] = s.fr; base[e] = s.base; q[e] = s.q;
          r[e] = s.r; nextw[e] = s.nextw;
        }
        // frame ends: the sink launches at most one token a cycle
        if (frame_ends && m == n.sink0 && ++sinkl == next_fb) {
          if (*s_nfe < n.F) fe[(i64)k * n.F + *s_nfe] = t;
          *s_nfe += 1;
          next_fb += n.frame_tokens;
        }
      }
    }
    // the cycle's votes, in a slot that alternates by iteration: the
    // other slot was read before this cycle's first barrier
    const int vbits = act | (nd << 1);
    if (vbits) atomicOr(s_vote + (it & 1), vbits);
    __syncthreads();
    const int votes = s_vote[it & 1];
    if (tid == 0) s_vote[(it & 1) ^ 1] = 0;
    ++it;
    notdone = votes >> 1;
    CYC_STAMP(4);
    t += 1;
    if (votes & 1) {
      lastp = t - 1;
    } else if (n.jump) {
      u64 d = ~0ULL;
      for (int m = tid; m < M; m += nt) {
        int blocked = 0, ready = 1;
        for (int j = __ldg(n.out_ptr + m); j < __ldg(n.out_ptr + m + 1); ++j) {
          const int e = __ldg(n.out_idx + j);
          blocked |= occ[e] >= ecap[e];
        }
        for (int j = __ldg(n.in_ptr + m); j < __ldg(n.in_ptr + m + 1); ++j) {
          const int e = __ldg(n.in_idx + j);
          ready &= !(cons[e] < need[e]);
        }
        const int active = (int)mf(n, m, MF_ACTIVE);
        if (active && mf(n, m, MF_HAS_OUT) && !blocked
            && pushed[m] < launched[m]) {
          const int dm = ring_next_maturation(
              ring + mf(n, m, MF_RING), (int)mf(n, m, MF_LEFF) + 1, pos[m]);
          if (dm >= 0) d = min(d, (u64)dm);
        }
        if (mf(n, m, MF_THROT) && ready && active
            && launched[m] < mf(n, m, MF_TOT))
          d = min(d, credit_event(mf(n, m, MF_RNUM), mf(n, m, MF_RDEN),
                                  credit[m]));
      }
      d = warp_min_u64(d);
      if ((tid & 31) == 0 && d != ~0ULL) atomicMin(s_ev, d);
      __syncthreads();
      d = *s_ev;
      __syncthreads();
      if (tid == 0) *s_ev = ~0ULL;
      const i64 dt = jump_target(n, d, t, lastp, skipped, saved);
      if (dt > 0) {
        for (int m = tid; m < M; m += nt) {
          int p = pos[m];
          ring_skip(ring + mf(n, m, MF_RING), (int)mf(n, m, MF_LEFF) + 1, p,
                    dt, matured[m]);
          pos[m] = p;
          if (mf(n, m, MF_THROT))
            credit[m] = min(credit[m] + dt * mf(n, m, MF_RNUM),
                            mf(n, m, MF_RDEN));
        }
      }
    }
    CYC_STAMP(5);
  }
  CYC_PROF_END;
  __syncthreads();

  i64* st = state + (i64)k * (6 * E + 3 * M);
  for (int e = tid; e < E; e += nt) {
    st[e] = occ[e];
    st[E + e] = cons[e];
    st[2 * E + e] = kf[e];
    st[3 * E + e] = fr[e];
    st[4 * E + e] = hwm[e];
    st[5 * E + e] = hwmc[e];
  }
  for (int m = tid; m < M; m += nt) {
    st[6 * E + m] = launched[m];
    st[6 * E + M + m] = pushed[m];
    st[6 * E + 2 * M + m] = credit[m];
  }
  if (tid == 0) {
    i64* sc = scal + (i64)k * S_N;
    sc[S_T] = t;
    sc[S_LAST] = lastp;
    sc[S_SKIPPED] = skipped;
    sc[S_SAVED] = saved;
    sc[S_CODE] = code;
    sc[S_NFE] = *s_nfe;
  }
}

template <typename Kern>
int launch_form(Kern kern, int K, int threads, size_t smem,
                cudaStream_t stream, const Net& n, const i64* caps,
                u64* gring, i64* state, i64* scal, i64* fe) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  CYC_LAUNCH(kern, K, threads, smem, stream, n, caps, gring, state, scal,
             fe);
  return (int)cudaGetLastError();
}

template <int MS, int ES, typename C>
int launch_warp(bool shared_ring, int K, size_t smem, cudaStream_t stream,
                const Net& n, const i64* caps, u64* gring, i64* state,
                i64* scal, i64* fe) {
  if (shared_ring)
    return launch_form(cyclesim_warp_kernel<MS, ES, true, C>, K, 32, smem,
                       stream, n, caps, gring, state, scal, fe);
  return launch_form(cyclesim_warp_kernel<MS, ES, false, C>, K, 32, smem,
                     stream, n, caps, gring, state, scal, fe);
}

template <int MS, int ES>
int launch_warp(bool shared_ring, bool narrow, int K, size_t smem,
                cudaStream_t stream, const Net& n, const i64* caps,
                u64* gring, i64* state, i64* scal, i64* fe) {
  if (narrow)
    return launch_warp<MS, ES, int>(shared_ring, K, smem, stream, n, caps,
                                    gring, state, scal, fe);
  return launch_warp<MS, ES, i64>(shared_ring, K, smem, stream, n, caps,
                                  gring, state, scal, fe);
}

}  // namespace

// ms, es: the warp form's modules and edges a lane (one of the pairs
// below, kernels/cyclesim/ops.py WARP_SLOTS), or 0, 0 for the block form
// with `threads` threads.  smem: the dynamic shared memory
// (ops.py::smem_bytes); shared_ring: the rings are in it, else in gring;
// narrow: the warp form's counters in 32 bits (every count of the run
// fits, ops.py::counter_bits).
extern "C" int cyclesim_launch(
    const long long* mod, const long long* edge, const int* out_ptr,
    const int* out_idx, const int* in_ptr, const int* in_idx,
    const long long* need_buf, const long long* caps,
    unsigned long long* gring, long long* state, long long* scal,
    long long* fe, int K, int M, int E, long long ring_words,
    long long frames, long long horizon, long long stall_limit,
    long long sink0, long long frame_tokens, long long F, int jump, int ms,
    int es, int threads, long long smem, int shared_ring, int narrow,
    cudaStream_t stream) {
  Net n{mod, edge, out_ptr, out_idx, in_ptr, in_idx, need_buf, M, E,
        ring_words, frames, horizon, stall_limit, sink0, frame_tokens, F,
        jump};
  const size_t bytes = (size_t)smem;
  const int slots = ms * 8 + es;
  switch (ms == 0 ? 0 : slots) {
    case 0:
      if (shared_ring)
        return launch_form(cyclesim_block_kernel<true>, K, threads, bytes,
                           stream, n, caps, gring, state, scal, fe);
      return launch_form(cyclesim_block_kernel<false>, K, threads, bytes,
                         stream, n, caps, gring, state, scal, fe);
    case 1 * 8 + 1:
      return launch_warp<1, 1>(shared_ring, narrow, K, bytes, stream, n,
                               caps, gring, state, scal, fe);
    case 2 * 8 + 2:
      return launch_warp<2, 2>(shared_ring, narrow, K, bytes, stream, n,
                               caps, gring, state, scal, fe);
    case 2 * 8 + 3:
      return launch_warp<2, 3>(shared_ring, narrow, K, bytes, stream, n,
                               caps, gring, state, scal, fe);
    case 3 * 8 + 3:
      return launch_warp<3, 3>(shared_ring, narrow, K, bytes, stream, n,
                               caps, gring, state, scal, fe);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
