// The cycle kernel's profiling build: per-phase clock stamps and latency
// probes, compiled only when CYCLESIM_PROFILE is defined.  The path's
// build never defines it; launch/cycle_profile.py builds csrc/cyclesim.cu
// a second time with -DCYCLESIM_PROFILE, under its own library name.
//
// Stamps: thread 0 of each design reads clock64() at each phase boundary
// and adds the clocks since the previous stamp to that phase's counter
// (registers: the indices are constants).  At the end the counters and
// the number of loop iterations go to cyc_prof[design], which the host
// reads with cyc_prof_read.  Without the define every macro is empty.
#pragma once
#include <cuda_runtime.h>

#ifdef CYCLESIM_PROFILE

#define CYC_NSTAMP 8
#define CYC_MAX_DESIGNS 64

__device__ unsigned long long cyc_prof[CYC_MAX_DESIGNS][CYC_NSTAMP + 1];

#define CYC_PROF_BEGIN                                              \
  unsigned long long cyc_acc[CYC_NSTAMP] = {}, cyc_loops = 0,       \
                     cyc_last = clock64()
#define CYC_STAMP(i)                                                \
  do {                                                              \
    const unsigned long long cyc_now = clock64();                   \
    cyc_acc[i] += cyc_now - cyc_last;                               \
    cyc_last = cyc_now;                                             \
  } while (0)
#define CYC_LOOP() (++cyc_loops)
#define CYC_PROF_END                                                \
  do {                                                              \
    if (threadIdx.x == 0 && blockIdx.x < CYC_MAX_DESIGNS) {         \
      for (int cyc_i = 0; cyc_i < CYC_NSTAMP; ++cyc_i)              \
        cyc_prof[blockIdx.x][cyc_i] = cyc_acc[cyc_i];               \
      cyc_prof[blockIdx.x][CYC_NSTAMP] = cyc_loops;                 \
    }                                                               \
  } while (0)

namespace cyc_probe {

__device__ __forceinline__ unsigned long long gtimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// One dependent chain per probe, timed by thread 0: out[0] clocks,
// out[1] globaltimer ns, out[2] the chain's value (kept live).
__global__ void probe_kernel(int which, int steps, long long arg,
                             const long long* __restrict__ buf,
                             unsigned long long* out) {
  extern __shared__ int cyc_chase[];
  const int tid = threadIdx.x, lane = tid & 31;
  const int n = 4096;
  for (int i = tid; i < n; i += blockDim.x) cyc_chase[i] = (i + 97) % n;
  __syncthreads();
  long long v = lane;
  unsigned x = (unsigned)lane;
  unsigned long long c0 = 0, g0 = 0;
  for (int rep = 0; rep < 2; ++rep) {     // the first pass warms up
    __syncthreads();
    c0 = clock64();
    g0 = gtimer();
    switch (which) {
      case 0:   // shared-memory pointer chase: one LDS round trip a step
        if (tid == 0)
          for (int s = 0; s < steps; ++s) x = (unsigned)cyc_chase[x];
        break;
      case 1:   // a shared store then a load of the same word
        if (tid == 0) {
          volatile int* w = cyc_chase;
          for (int s = 0; s < steps; ++s) {
            w[x & 1023] = (int)x + 1;
            x = (unsigned)w[x & 1023];
          }
        }
        break;
      case 2:   // dependent ballots across the warp
        if (tid < 32)
          for (int s = 0; s < steps; ++s)
            x = __ballot_sync(0xffffffffu, (x >> lane) & 1) + lane;
        break;
      case 3:   // dependent __any_sync
        if (tid < 32)
          for (int s = 0; s < steps; ++s)
            x = __any_sync(0xffffffffu, (x + lane) & 1) + x + 1;
        break;
      case 4:   // dependent __reduce_or_sync
        if (tid < 32)
          for (int s = 0; s < steps; ++s)
            x = __reduce_or_sync(0xffffffffu, x + lane) + 1;
        break;
      case 5:   // dependent __reduce_min_sync
        if (tid < 32)
          for (int s = 0; s < steps; ++s)
            x = __reduce_min_sync(0xffffffffu, x + lane) + 1;
        break;
      case 6:   // __syncthreads across the block
        for (int s = 0; s < steps; ++s) {
          __syncthreads();
          x += 1;
        }
        break;
      case 7:   // dependent __syncthreads_or across the block
        for (int s = 0; s < steps; ++s)
          x = (unsigned)__syncthreads_or((x + tid) & 1) + x;
        break;
      case 8:   // dependent emulated 64-bit remainder
        if (tid == 0)
          for (int s = 0; s < steps; ++s) v = v % arg + arg * 3 + s;
        break;
      case 9:   // global pointer chase through L2 (ld.global.cg)
        if (tid == 0) {
          long long j = 0;
          for (int s = 0; s < steps; ++s) j = __ldcg(buf + j);
          v = j;
        }
        break;
      case 10:  // clock64 read to read (a stamp's own cost)
        if (tid == 0)
          for (int s = 0; s < steps; ++s) v += (long long)clock64();
        break;
    }
  }
  if (tid == 0) {
    out[0] = clock64() - c0;
    out[1] = gtimer() - g0;
    out[2] = (unsigned long long)v + x;
  }
}

}  // namespace cyc_probe

extern "C" int cyc_prof_read(unsigned long long* host, int designs) {
  const int n = (designs < CYC_MAX_DESIGNS ? designs : CYC_MAX_DESIGNS)
      * (CYC_NSTAMP + 1);
  return (int)cudaMemcpyFromSymbol(host, cyc_prof,
                                   n * sizeof(unsigned long long));
}

extern "C" int cyc_probe_launch(int which, int steps, int threads,
                                long long arg, const long long* buf,
                                unsigned long long* out,
                                cudaStream_t stream) {
  cyc_probe::probe_kernel<<<1, threads, 4096 * sizeof(int), stream>>>(
      which, steps, arg, buf, out);
  return (int)cudaGetLastError();
}

#else

#define CYC_PROF_BEGIN
#define CYC_STAMP(i)
#define CYC_LOOP()
#define CYC_PROF_END

#endif
