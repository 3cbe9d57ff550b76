// The cycle kernel: whole cycle-level dataflow simulations of one packed
// module netlist, one thread block per design (a FIFO capacity vector).
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
// What bounds it: a cycle is a chain of dependent phases, each behind a
// block barrier (four barriers and a done vote a cycle) and a few loads
// from the launch-history ring in global memory.  There is no roofline:
// the lower limit is a few barrier latencies a cycle, and the work a
// cycle does (tens of modules and edges) fills a few warps.  Designs of a
// population run side by side on separate SMs.
//
// State: per-edge occ, consumed, kf, fr, hwm, hwm_cycle and per-module
// launched, pushed, credit are int64 in shared memory; the ring (H x M
// int64 a design, H = max latency + 2) is in global memory.  Modules and
// edges are spread over the block's threads with a block stride.
//
// Python's % and // are not C's: pos_mod and floor_div below give
// Python's results for negative operands ((t - leff) % H is negative on
// a run's first cycles).  Every counter is int64: 2^62 is the sentinel of
// an absent event, and sums like last_progress + stall_limit + 1 stay
// far below overflow.
#include <cuda_runtime.h>

namespace {

typedef long long i64;

constexpr i64 kInf = 1LL << 62;
enum : int { kRunning = 0, kDone = 2, kHorizon = 3, kStall = 4 };
// packed constants, in kernels/cyclesim/ops.py's field order
enum : int { MF_RNUM, MF_RDEN, MF_THROT, MF_LEFF, MF_HAS_OUT, MF_ACTIVE,
             MF_IS_SINK, MF_TOT, MF_N };
enum : int { EF_SRC, EF_DST, EF_NEED_OFF, EF_TPF, EF_OT, EF_N };
enum : int { S_T, S_LAST, S_SKIPPED, S_SAVED, S_CODE, S_NFE, S_N };

struct Net {
  const i64* mod;        // M x MF_N
  const i64* edge;       // E x EF_N
  const i64* out_ptr;    // M + 1: module m's out-edges are
  const i64* out_idx;    //   out_idx[out_ptr[m] .. out_ptr[m+1])
  const i64* in_ptr;     // M + 1, the same for in-edges
  const i64* in_idx;
  const i64* need_buf;   // the profiled edges' within-frame need tables
  int M, E;
  i64 H, frames, horizon, stall_limit, sink0, frame_tokens, F;
  int jump;
};

__device__ __forceinline__ i64 pos_mod(i64 a, i64 b) {
  i64 r = a % b;
  return r < 0 ? r + b : r;
}

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

// tokens edge e's consumer needs before its kf-th output of frame fr
__device__ __forceinline__ i64 need_of(const Net& n, int e, i64 kf, i64 fr) {
  const i64 tpf = ef(n, e, EF_TPF);
  const i64 off = ef(n, e, EF_NEED_OFF);
  i64 within;
  if (off >= 0) {
    within = __ldg(n.need_buf + off + kf - 1);
  } else {   // proportional consumption: what need_array() tabulates
    within = min(tpf, ceil_div(kf * tpf, ef(n, e, EF_OT)));
  }
  return fr * tpf + within;
}

__global__ void cyclesim_kernel(Net n, const i64* __restrict__ caps,
                                i64* __restrict__ hist,
                                i64* __restrict__ state,
                                i64* __restrict__ scal, i64* __restrict__ fe) {
  extern __shared__ i64 smem[];
  const int M = n.M, E = n.E;
  const int tid = threadIdx.x, nt = blockDim.x;
  i64* occ = smem;
  i64* consumed = occ + E;
  i64* kf = consumed + E;
  i64* fr = kf + E;
  i64* hwm = fr + E;
  i64* hwmc = hwm + E;
  i64* launched = hwmc + E;
  i64* pushed = launched + M;
  i64* credit = pushed + M;
  i64* s_ev = credit + M;
  int* mflag = reinterpret_cast<int*>(s_ev + 1);   // M
  int* eflag = mflag + M;                           // E

  const int k = blockIdx.x;
  const i64* cap = caps + (i64)k * E;
  i64* ring = hist + (i64)k * n.H * M;
  const i64 H = n.H;

  for (int e = tid; e < E; e += nt) {
    occ[e] = 0; consumed[e] = 0; kf[e] = 1; fr[e] = 0;
    hwm[e] = 0; hwmc[e] = 0;
  }
  int notdone = 0;
  for (int m = tid; m < M; m += nt) {
    launched[m] = 0; pushed[m] = 0; credit[m] = 0;
    if (mf(n, m, MF_IS_SINK) && mf(n, m, MF_TOT) > 0) notdone = 1;
  }
  if (tid == 0) *s_ev = kInf;

  // per-design scalars: every thread holds the same values
  i64 t = 0, lastp = 0, skipped = 0, saved = 0, nfe = 0;
  int code = kRunning;
  while (true) {
    // stop codes, checked before each cycle: DONE, HORIZON, STALL
    if (!__syncthreads_or(notdone)) { code = kDone; break; }
    if (t >= n.horizon) { code = kHorizon; break; }
    if (t - lastp > n.stall_limit) { code = kStall; break; }
    int moved = 0;
    // phase A, modules: a matured token pushes unless an out-edge is full
    for (int m = tid; m < M; m += nt) {
      int blocked = 0;
      for (i64 j = __ldg(n.out_ptr + m); j < __ldg(n.out_ptr + m + 1); ++j) {
        const int e = (int)__ldg(n.out_idx + j);
        blocked |= occ[e] >= __ldg(cap + e);
      }
      const i64 matured = ring[pos_mod(t - mf(n, m, MF_LEFF), H) * M + m];
      const int cp = pushed[m] < matured && !blocked && mf(n, m, MF_HAS_OUT);
      pushed[m] += cp;
      mflag[m] = cp;
      moved |= cp;
    }
    __syncthreads();
    // edges: the push lands, high-water mark, then a pop toward the need
    for (int e = tid; e < E; e += nt) {
      i64 o = occ[e] + mflag[ef(n, e, EF_SRC)];
      if (o > hwm[e]) { hwm[e] = o; hwmc[e] = t; }
      const int done_dst = fr[e] >= n.frames;
      const i64 need = need_of(n, e, kf[e], fr[e]);
      const int pop = !done_dst && consumed[e] < need && o > 0;
      o -= pop;
      consumed[e] += pop;
      occ[e] = o;
      eflag[e] = consumed[e] < need && !done_dst;       // unmet
      moved |= pop;
    }
    __syncthreads();
    // phase B, modules: launch when every in-edge is met and credit allows
    notdone = 0;
    for (int m = tid; m < M; m += nt) {
      int ready = 1;
      for (i64 j = __ldg(n.in_ptr + m); j < __ldg(n.in_ptr + m + 1); ++j)
        ready &= !eflag[__ldg(n.in_idx + j)];
      i64 l = launched[m];
      const i64 tot = mf(n, m, MF_TOT);
      const i64 rden = mf(n, m, MF_RDEN);
      const int throt = (int)mf(n, m, MF_THROT);
      const i64 c = credit[m] + mf(n, m, MF_RNUM);
      const int launch = ready && l < tot && mf(n, m, MF_ACTIVE)
          && (!throt || c >= rden);
      if (throt) credit[m] = launch ? c - rden : min(c, rden);
      l += launch;
      launched[m] = l;
      const int sink = (int)mf(n, m, MF_IS_SINK);
      if (launch && sink) pushed[m] += 1;               // sinks absorb
      ring[pos_mod(t, H) * M + m] = l;
      mflag[m] = launch;
      moved |= launch;
      if (sink && l < tot) notdone = 1;
    }
    __syncthreads();
    // edges: a launch advances the consumer's output index, wrapping frames
    for (int e = tid; e < E; e += nt) {
      if (mflag[ef(n, e, EF_DST)]) {
        if (kf[e] == ef(n, e, EF_OT)) { kf[e] = 1; fr[e] += 1; }
        else { kf[e] += 1; }
      }
    }
    moved = __syncthreads_or(moved);
    t += 1;
    if (moved) {
      lastp = t - 1;
    } else if (n.jump) {
      // event jump: every enabling condition is frozen until the earliest
      // maturation or credit refill (the plain version's _next_event)
      for (int e = tid; e < E; e += nt) {
        const int full = occ[e] >= __ldg(cap + e);
        const int unmet = fr[e] < n.frames
            && consumed[e] < need_of(n, e, kf[e], fr[e]);
        eflag[e] = full | (unmet << 1);
      }
      __syncthreads();
      i64 ev = kInf;
      for (int m = tid; m < M; m += nt) {
        const i64 p = pushed[m], l = launched[m];
        int blocked = 0;
        for (i64 j = __ldg(n.out_ptr + m); j < __ldg(n.out_ptr + m + 1); ++j)
          blocked |= eflag[__ldg(n.out_idx + j)] & 1;
        const int active = (int)mf(n, m, MF_ACTIVE);
        if (active && mf(n, m, MF_HAS_OUT) && !blocked && p < l) {
          // the ring's rows over cycles t-leff .. t-1 are cumulative
          // launch counts, so they never decrease: the first row above
          // p is found by bisection (the plain version scans)
          const i64 leff = mf(n, m, MF_LEFF);
          i64 lo = 0, hi = leff;
          while (lo < hi) {
            const i64 mid = (lo + hi) / 2;
            if (ring[pos_mod(t + mid - leff, H) * M + m] > p) hi = mid;
            else lo = mid + 1;
          }
          if (lo < leff) ev = min(ev, t + lo);
        }
        int ready = 1;
        for (i64 j = __ldg(n.in_ptr + m); j < __ldg(n.in_ptr + m + 1); ++j)
          ready &= !(eflag[__ldg(n.in_idx + j)] & 2);
        if (mf(n, m, MF_THROT) && ready && l < mf(n, m, MF_TOT) && active) {
          const i64 gap = mf(n, m, MF_RDEN) - credit[m];
          const i64 d = max(0LL, ceil_div(gap, mf(n, m, MF_RNUM)) - 1);
          ev = min(ev, t + d);
        }
      }
      if (ev < kInf) atomicMin(s_ev, ev);
      __syncthreads();
      ev = *s_ev;
      __syncthreads();
      if (tid == 0) *s_ev = kInf;
      i64 te = min(min(ev, lastp + n.stall_limit + 1), n.horizon);
      te = max(te, t);
      const i64 dt = te - t;
      if (dt > 0) {
        // no event before the clamp: a provably dead state
        if (ev > te) saved += dt;
        // the skipped cycles' ring rows hold the frozen launch counts
        const i64 x0 = max(t, te - H);
        const i64 cells = (te - x0) * M;
        for (i64 i = tid; i < cells; i += nt) {
          const i64 x = x0 + i / M;
          const int m = (int)(i % M);
          ring[pos_mod(x, H) * M + m] = launched[m];
        }
        for (int m = tid; m < M; m += nt) {
          if (mf(n, m, MF_THROT))
            credit[m] = min(credit[m] + dt * mf(n, m, MF_RNUM),
                            mf(n, m, MF_RDEN));
        }
        t = te;
        skipped += dt;
      }
    }
    // frame ends: the sink launches at most one token a cycle
    if (n.sink0 >= 0 && n.frame_tokens > 0) {
      const i64 nf = launched[n.sink0] / n.frame_tokens;
      for (; nfe < nf; ++nfe) {
        if (tid == 0 && nfe < n.F) fe[(i64)k * n.F + nfe] = t - 1;
      }
    }
  }

  i64* st = state + (i64)k * (6 * E + 3 * M);
  for (int e = tid; e < E; e += nt) {
    st[e] = occ[e];
    st[E + e] = consumed[e];
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
    sc[S_NFE] = nfe;
  }
}

}  // namespace

extern "C" int cyclesim_launch(
    const long long* mod, const long long* edge, const long long* out_ptr,
    const long long* out_idx, const long long* in_ptr,
    const long long* in_idx, const long long* need_buf,
    const long long* caps, long long* hist, long long* state,
    long long* scal, long long* fe, int K, int M, int E, long long H,
    long long frames, long long horizon, long long stall_limit,
    long long sink0, long long frame_tokens, long long F, int jump,
    int threads, cudaStream_t stream) {
  Net n{mod, edge, out_ptr, out_idx, in_ptr, in_idx, need_buf, M, E,
        H, frames, horizon, stall_limit, sink0, frame_tokens, F, jump};
  const size_t smem = 8 * (6 * (size_t)E + 3 * (size_t)M + 1)
      + 4 * ((size_t)M + (size_t)E);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cyclesim_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cyclesim_kernel<<<K, threads, smem, stream>>>(n, caps, hist, state, scal,
                                                 fe);
  return (int)cudaGetLastError();
}
