// K4's decode form (Sq = 1): one query row a (batch, head) against the
// keys of a KV cache span, split-KV, for bf16 and float.  Its prefill
// forms are in flash_attn.cu; the arithmetic is the same:
//
//   s = (q . k^T) * (1/sqrt(D))                      in f32, no mask
//   m, l, acc: online softmax over the keys           in f32
//   acc += round_to_v_dtype(p) . v
//   out = acc / max(l, 1e-30)                         in q's dtype
//
// Replaces the decode of the TPU kernel
// src/repro/kernels/flash/kernel.py::_flash_kernel (wrapper
// flash_decode_tpu: a prefill padded to 8 rows through the same
// pallas_call), which carries the online softmax across KV tiles in
// scratch memory along a sequential grid axis; here the keys are split
// over blocks and the partial softmaxes merged, with the splits combined
// as m_all = max m_c, w_c = exp(m_c - m_all), l_all = sum l_c*w_c, out =
// sum acc_c*w_c / max(l_all, 1e-30).
//
// q (B, 1, H, D), k and v (B, Skv, Hkv, D) are read through their element
// strides with only the head dim contiguous, so a decode step's slice of
// the cache is not copied; query head h reads kv head h / g (GQA); out is
// (B, 1, H, D), contiguous.
//
// Split-KV: nsplit blocks a (b, kv head, head
// group) on a grid (nsplit, B*Hkv, head groups), block (c, b*Hkv + hk, z)
// taking keys [c*kc, min((c+1)*kc, skv)) for a group of GT query heads of
// kv head hk, so each K and V row leaves device memory once however many
// heads share it.  The cluster and split kernels size GT to g
// (dec::head_group, ops.decode_head_group): g itself up to 4, 6 for g 5-6,
// 8 for 7-8, and above 8 the largest of 8, 6, 4 that divides g (granite's
// g 3 runs 3 heads a block; in f32 or past 8 splits command-r-plus's 12
// two groups of 6, qwen2-vl's 7 one group of 8 with one idle slot); the
// mma kernel takes 16.  The Python wrapper picks kc and nsplit
// (ops.decode_split: about one block per SM, chunks of at least 16 keys,
// at most 8 splits from 16 (b, kv head) pairs on).  Three kernels serve
// it, by dec::decode_kernel (mirrored by ops.decode_kernel):
//  - up to 8 splits in bf16 at g >= 5: dec::flash_decode_mma_kernel, all
//    g <= 16 query heads of a kv head as the 16 rows of an mma.sync tile
//    (its note gives the design), merged in a cluster as below;
//  - up to 8 splits otherwise (every span at 16 or more pairs; short spans
//    at fewer): dec::flash_decode_cluster_kernel, one launch whose nsplit
//    blocks of a group form one thread-block cluster (cudaLaunchKernelEx,
//    cluster (nsplit, 1, 1)).  Each warp runs its own online softmax over
//    its rows, read straight into registers, with no block barrier; the
//    block combines its 4 warps in shared memory, and each split's (m, l)
//    and f32 acc go by st.async into the shared memory of the block that
//    owns their columns, completing on its mbarrier; each block then
//    merges its columns with m_all = max m_c, w_c = exp(m_c - m_all),
//    l_all = sum l_c*w_c and writes out = sum acc_c*w_c / max(l_all,
//    1e-30).  No workspace, no second kernel;
//  - more (long spans at fewer than 16 pairs, gemma3-1b's 4):
//    dec::flash_decode_split_kernel, a block's tiles through shared
//    memory, writes (m, l, acc) to an f32 workspace that the wrapper
//    allocates, and dec::flash_decode_merge_kernel applies the same
//    formula over the splits.
// Rows move with 16-byte cp.async / vector loads, so every row start must
// be 16-byte aligned (the wrapper raises otherwise).  The notes on the
// three kernels give their tiles.  What bounds the short spans is not bytes
// (granite's 160 keys are 1.3 MB, 0.4 us at 3.35 TB/s) but latency: a
// launch, a round trip to L2 or DRAM, and one warp a scheduler issuing
// every dependent step; the cluster kernel has one round trip for q, K and
// V together, one block barrier, and an exchange that waits only on the
// bytes each block needs.
//
// A decode step reads the cache span once and is bound by bytes: at
// gemma3-1b's decode (B 4, H 4, Hkv 1, D 256, 1024 keys, bf16) 4.2 MB, 1.3
// us at 3.35 TB/s, which takes most of the card's SMs streaming at once;
// the split over keys gives the 4 (b, kv head) pairs 128 blocks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"     // Strides, to_f, round_to, cp_async16, ...

namespace {

// ---- decode form: split-KV, merged in a cluster or by a merge kernel -----

namespace dec {

constexpr int kThreads = 128;    // 4 warps per split block
constexpr int kWarps = kThreads / 32;
constexpr int kTileBytes = 16384;  // K (and V) bytes per shared tile
constexpr int kMergeCols = 64;   // output columns per merge block
// most splits of one span (ops.py SMS: one block per SM)
constexpr int kMaxSplits = 132;
// most splits merged in one thread-block cluster, the portable cluster
// size (ops.py MAX_CLUSTER); a span with more splits takes the workspace
// and the merge kernel
constexpr int kMaxCluster = 8;

// How a row of D elements of T is read 16 bytes at a time: VE elements
// per vector, NV vectors per row; L lanes share a row (RPW rows per warp
// step), each holding VPL vectors (E elements).  KT keys per tile, STEPS
// warp steps per tile.
template <typename T, int D>
struct Shape {
  static constexpr int VE = 16 / int(sizeof(T));
  static constexpr int NV = D / VE;
  static constexpr int L = NV < 32 ? NV : 32;
  static constexpr int RPW = 32 / L;
  static constexpr int VPL = NV / L;
  static constexpr int E = VPL * VE;
  static constexpr int KT0 = kTileBytes / (D * int(sizeof(T)));
  static constexpr int KT = KT0 < 64 ? KT0 : 64;
  static constexpr int STEPS = KT / (kWarps * RPW);
};

// the head-group width GT of g query heads a kv head (ops.py
// decode_head_group): g itself up to 4, 6 for 5-6, 8 for 7-8; above 8 the
// largest of 8, 6, 4 that divides g, else 8
__host__ __device__ constexpr int head_group(int g) {
  return g <= 4 ? g : g <= 6 ? 6 : g <= 8 ? 8 : g % 8 == 0 ? 8
       : g % 6 == 0 ? 6 : g % 4 == 0 ? 4 : 8;
}

__device__ __forceinline__ void to_floats(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void to_floats(const uint4& u, float* f,
                                          __nv_bfloat16) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
// blockIdx.x, .y or .z, read where it is used (volatile: not hoisted)
__device__ __forceinline__ int ctaid(int d) {
  int r;
  if (d == 0) asm volatile("mov.u32 %0, %%ctaid.x;\n" : "=r"(r));
  else if (d == 1) asm volatile("mov.u32 %0, %%ctaid.y;\n" : "=r"(r));
  else asm volatile("mov.u32 %0, %%ctaid.z;\n" : "=r"(r));
  return r;
}

// four floats into four elements of T, each rounded to nearest
__device__ __forceinline__ void store4(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* f) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(mma::pack_bf16(f[0], f[1]), mma::pack_bf16(f[2], f[3]));
}

// rows [t0, t0 + n) of one head of a cache into a shared [n][D] tile, one
// 16-byte cp.async per (row, vector)
template <typename T, int D>
__device__ __forceinline__ void load_rows(T* s, const T* g, long long stride,
                                          int t0, int n, int tid) {
  constexpr int VE = Shape<T, D>::VE, NV = Shape<T, D>::NV;
  for (int i = tid; i < n * NV; i += kThreads) {
    const int r = i / NV, c = i % NV;
    mma::cp_async16(mma::smem_u32(s + r * D + c * VE),
                    g + (t0 + r) * stride + c * VE, true);
  }
}

// The GT scores of each key of a tile of n keys into sS: warp step st
// takes RPW rows, L lanes each, and warp w the row groups w, w + 4, ....
// A full tile (FULL) runs all STEPS steps, every step's loads and products
// and then every step's shuffles (which sum a row's lanes), so the steps
// interleave; a short one runs only the steps that hold one of its n keys,
// one after another.  Rows past n in a step read stale shared memory and
// are not written.
template <typename T, int D, int GT, int NS>
__device__ __forceinline__ void score_steps(
    float (*sS)[Shape<T, D>::KT], const T* sK,
    const float (&qf)[GT][Shape<T, D>::E], int st0, int n, float scale,
    int warp, int lane) {
  using S = Shape<T, D>;
  constexpr int VE = S::VE, L = S::L, RPW = S::RPW, VPL = S::VPL;
  constexpr int E = S::E;
  float dot[NS][GT];
#pragma unroll
  for (int st = 0; st < NS; ++st) {
    const int r = ((st0 + st) * kWarps + warp) * RPW + lane / L;
    float kf[E];
#pragma unroll
    for (int w = 0; w < VPL; ++w)
      to_floats(*reinterpret_cast<const uint4*>(
                    sK + r * D + (lane % L + w * L) * VE),
                &kf[w * VE], T());
#pragma unroll
    for (int i = 0; i < GT; ++i) {
      dot[st][i] = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) dot[st][i] += qf[i][e] * kf[e];
    }
  }
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1)
#pragma unroll
    for (int st = 0; st < NS; ++st)
#pragma unroll
      for (int i = 0; i < GT; ++i)
        dot[st][i] += __shfl_xor_sync(0xffffffffu, dot[st][i], o);
  if (lane % L == 0) {
#pragma unroll
    for (int st = 0; st < NS; ++st) {
      const int r = ((st0 + st) * kWarps + warp) * RPW + lane / L;
      if (r < n) {
#pragma unroll
        for (int i = 0; i < GT; ++i) sS[i][r] = dot[st][i] * scale;
      }
    }
  }
}

template <typename T, int D, int GT>
__device__ __forceinline__ void tile_scores(
    float (*sS)[Shape<T, D>::KT], const T* sK,
    const float (&qf)[GT][Shape<T, D>::E], int n, float scale, int warp,
    int lane) {
  constexpr int KT = Shape<T, D>::KT, RPW = Shape<T, D>::RPW;
  if (n == KT) {
    score_steps<T, D, GT, Shape<T, D>::STEPS>(sS, sK, qf, 0, n, scale, warp,
                                              lane);
    return;
  }
#pragma unroll 1
  for (int st = 0; st * kWarps * RPW < n; ++st)
    score_steps<T, D, GT, 1>(sS, sK, qf, st, n, scale, warp, lane);
}

// barrier.cluster, split into its arrive (relaxed: no memory order) and
// its wait (acquire)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}
// the shared::cluster address of p in the shared memory of block rank
__device__ __forceinline__ uint32_t cluster_map(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(mma::smem_u32(p)), "r"(rank));
  return a;
}
// an mbarrier of one arrival in this block's shared memory, its expected
// bytes, and the wait for its first phase
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   mma::smem_u32(bar)),
               "r"(1));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(mma::smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait0(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], 0;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(mma::smem_u32(bar))
      : "memory");
}
// asynchronous stores into a peer's shared memory (cluster addresses),
// each completing its bytes on the peer's mbarrier
__device__ __forceinline__ void st_async(uint32_t a, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(a),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void st_async(uint32_t a, float2 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], "
      "{%1, %2}, [%3];\n" ::"r"(a),
      "f"(v.x), "f"(v.y), "r"(bar)
      : "memory");
}

// The steps of rows a warp of the cluster kernel takes an iteration: a
// block's iteration covers 32 rows (a 32-key chunk, or two 16-key ones,
// in one) where the group's q and acc leave room for the steps' K and V
// and the next iteration's (about 200 registers in all), else the largest
// power of two that fits, so that no instantiation spills.
template <typename T, int D, int GT>
__host__ __device__ constexpr int cluster_steps() {
  using S = Shape<T, D>;
  constexpr int want = 32 / (kWarps * S::RPW);
  constexpr int base = 2 * GT * S::E + 2 * GT;    // q, acc, m, l
  constexpr int step = 16 * S::VPL + GT;          // K, V and the next's; s
  constexpr int fit = (200 - base) / step;
  constexpr int ns = fit < want ? fit : want;
  return ns >= 8 ? 8 : ns >= 4 ? 4 : ns >= 2 ? 2 : 1;
}

// The 16-byte vectors of this lane's rows r0 + s*ROWS + lane/L (steps s <
// NS; ROWS = 4*RPW rows a block step) of one head of K and V; rows at or
// past j1 load nothing and read as zeros.
template <typename T, int D, int NS>
__device__ __forceinline__ void load_steps(uint4 (&kx)[NS][Shape<T, D>::VPL],
                                           uint4 (&vx)[NS][Shape<T, D>::VPL],
                                           const T* kb, const T* vb,
                                           long long kss, long long vss,
                                           int r0, int j1, int lane) {
  using S = Shape<T, D>;
  constexpr int L = S::L, VE = S::VE, ROWS = kWarps * S::RPW;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int r = r0 + s * ROWS + lane / L;
#pragma unroll
    for (int w = 0; w < S::VPL; ++w) {
      const int off = (lane % L + w * L) * VE;
      kx[s][w] = r < j1 ? *reinterpret_cast<const uint4*>(kb + r * kss + off)
                        : make_uint4(0u, 0u, 0u, 0u);
      vx[s][w] = r < j1 ? *reinterpret_cast<const uint4*>(vb + r * vss + off)
                        : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// The cluster kernel's merge of a block's cnt items f = f0 .. (four
// columns of head i = f / (D/4) each), LP lanes an item, lane j of the LP
// taking splits j, j + LP, ... of the nsplit: m_all = max m_c, w_c =
// exp(m_c - m_all) and l_all = sum l_c*w_c over the splits, summed across
// the LP lanes by shuffles, and out = sum acc_c*w_c / max(l_all, 1e-30)
// for the group's heads below `heads`.  Split c's (m, l) of head i is
// sML[c][i], its acc of item f0 + fl sAcc[c*per + fl].
template <typename T, int D, int GT, int LP>
__device__ __forceinline__ void merge_items(
    T* __restrict__ out, const float4* sAcc,
    const float2 (*sML)[GT], size_t row0, int heads, int f0, int cnt,
    int per, int nsplit, int warp, int lane) {
  constexpr int C4 = D / 4, NT = kMaxCluster / LP;
  for (int u0 = warp * 32; u0 < cnt * LP; u0 += kThreads) {
    const int fl = (u0 + lane) / LP, j = lane % LP, i = (f0 + fl) / C4;
    const int jn = fl < cnt ? nsplit : 0;      // splits this lane reads
    float2 ml[NT];
    float m_all = kMaskAdd;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      ml[t] = j + t * LP < jn ? sML[j + t * LP][i]
                              : make_float2(kMaskAdd, 0.f);
      m_all = fmaxf(m_all, ml[t].x);
    }
#pragma unroll
    for (int o = 1; o < LP; o <<= 1)
      m_all = fmaxf(m_all, __shfl_xor_sync(0xffffffffu, m_all, o));
    float lw = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      if (j + t * LP < jn) {
        const float4 v = sAcc[(j + t * LP) * per + fl];
        const float w = expf(ml[t].x - m_all);
        lw += ml[t].y * w;
        a.x += v.x * w;
        a.y += v.y * w;
        a.z += v.z * w;
        a.w += v.w * w;
      }
    }
#pragma unroll
    for (int o = 1; o < LP; o <<= 1) {
      lw += __shfl_xor_sync(0xffffffffu, lw, o);
      a.x += __shfl_xor_sync(0xffffffffu, a.x, o);
      a.y += __shfl_xor_sync(0xffffffffu, a.y, o);
      a.z += __shfl_xor_sync(0xffffffffu, a.z, o);
      a.w += __shfl_xor_sync(0xffffffffu, a.w, o);
    }
    if (j == 0 && fl < cnt && i < heads) {
      const float den = fmaxf(lw, 1e-30f);
      const float o[4] = {a.x / den, a.y / den, a.z / den, a.w / den};
      store4(out + (row0 + i) * D + ((f0 + fl) % C4) * 4, o);
    }
  }
}

// One iteration of a warp of the cluster kernel: its rows r0 + s*ROWS +
// lane/L of steps s < NS, whose K and V vectors kr, vr hold, into its
// running (m, l, acc) per head.  A full iteration (FULL: every step holds
// a key) is straight-line code; otherwise only the ns steps that hold one
// run.  Rows at or past j1 in a step score -inf.
template <typename T, int D, int GT, int NS, bool FULL>
__device__ __forceinline__ void warp_steps(
    const uint4 (&kr)[NS][Shape<T, D>::VPL],
    const uint4 (&vr)[NS][Shape<T, D>::VPL],
    const float (&qf)[GT][Shape<T, D>::E], float (&m)[GT], float (&l)[GT],
    float (&acc)[GT][Shape<T, D>::E], int r0, int j1, int ns, float scale,
    int lane) {
  using S = Shape<T, D>;
  constexpr int VE = S::VE, L = S::L, VPL = S::VPL, E = S::E;
  constexpr int ROWS = kWarps * S::RPW;
  float sc[NS][GT];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    if (FULL || s < ns) {
      float kf[E];
#pragma unroll
      for (int w = 0; w < VPL; ++w) to_floats(kr[s][w], &kf[w * VE], T());
#pragma unroll
      for (int i = 0; i < GT; ++i) {
        sc[s][i] = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) sc[s][i] += qf[i][e] * kf[e];
      }
    }
  }
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1)
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if (FULL || s < ns) {
#pragma unroll
        for (int i = 0; i < GT; ++i)
          sc[s][i] += __shfl_xor_sync(0xffffffffu, sc[s][i], o);
      }
    }
  float mt[GT];
#pragma unroll
  for (int i = 0; i < GT; ++i) mt[i] = -INFINITY;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    if (FULL || s < ns) {
      const bool in = r0 + s * ROWS + lane / L < j1;
#pragma unroll
      for (int i = 0; i < GT; ++i) {
        sc[s][i] = in ? sc[s][i] * scale : -INFINITY;
        mt[i] = fmaxf(mt[i], sc[s][i]);
      }
    }
  }
#pragma unroll
  for (int o = L; o < 32; o <<= 1)
#pragma unroll
    for (int i = 0; i < GT; ++i)
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], o));
#pragma unroll
  for (int i = 0; i < GT; ++i) {
    const float m_new = fmaxf(m[i], mt[i]);
    const float corr = expf(m[i] - m_new);
    m[i] = m_new;
    l[i] *= corr;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] *= corr;
  }
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    if (FULL || s < ns) {
      float vf[E];
#pragma unroll
      for (int w = 0; w < VPL; ++w) to_floats(vr[s][w], &vf[w * VE], T());
#pragma unroll
      for (int i = 0; i < GT; ++i) {
        const float p = expf(sc[s][i] - m[i]);
        l[i] += p;
        const float pr = round_to<T>(p);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[i][e] += pr * vf[e];
      }
    }
  }
}

// Up to kMaxCluster splits: block (c, b*Hkv + hk, z) of a cluster of the
// nsplit blocks (c = 0 .. nsplit-1) of one (b, kv head, head group) takes
// keys [c*kc, min((c+1)*kc, skv)) for query heads hk*g + z*GT + i.
//  1. Each of its 4 warps runs the online softmax over its own rows with
//     no block barrier: warp w takes rows j0 + (s*4 + w)*RPW + lane/L, NS
//     steps an iteration (a block's 32 rows where registers allow),
//     straight from device memory into registers (L lanes a row, 16 bytes
//     a lane; the next iteration's loads issued before this one's math;
//     warp_steps).  Its rows' scores are summed over the L lanes by a
//     butterfly of shuffles, its max over its row groups by shuffles.
//  2. The warp's (m, l) and its row groups' acc go to shared memory; after
//     one __syncthreads, item f of the group (four columns of a head)
//     combines the 4 warps' with w_w = exp(m_w - m_b) into the split's
//     partial, and stores it into the shared memory of block f / per of
//     the cluster (per = ceil(ITEMS / nsplit) items a block) with
//     st.async, which completes its bytes on that block's mbarrier; each
//     head's (m_b, l_b) goes to every block the same way.
//  3. Block r waits on its own mbarrier for the bytes of its items from
//     every split, and merges them (merge_items): m_all = max m_c, w_c =
//     exp(m_c - m_all), l_all = sum l_c*w_c, out = sum acc_c*w_c /
//     max(l_all, 1e-30).
// The stores wait on a cluster barrier phase whose arrive each block
// makes when it starts, after setting its mbarrier, so no store reaches a
// block that is not running.  No block reads a peer's shared memory and
// no fence orders the stores: the release arrive of barrier.cluster
// compiles to a GPU-wide memory barrier, which the mbarrier's byte count
// does without.
template <typename T, int D, int GT>
__global__ void __launch_bounds__(kThreads)
flash_decode_cluster_kernel(T* __restrict__ out, const T* __restrict__ q,
                            const T* __restrict__ k, const T* __restrict__ v,
                            Strides qs, Strides ks, Strides vs, int H,
                            int Hkv, int g, int skv, int kc, int nsplit,
                            float scale) {
  using S = Shape<T, D>;
  constexpr int VE = S::VE, L = S::L, RPW = S::RPW;
  constexpr int VPL = S::VPL, E = S::E, ROWS = kWarps * RPW;
  constexpr int NS = cluster_steps<T, D, GT>();
  constexpr int C4 = D / 4;              // four-column items of a head
  constexpr int ITEMS = GT * C4;         // of the group
  // each warp's row groups' acc
  __shared__ __align__(16) float4 sPart[kWarps][RPW][ITEMS];
  __shared__ float2 sMLw[kWarps][GT];                    // warps' (m, l)
  // split c's acc of this block's item fl at [c*per + fl], its (m, l)
  __shared__ __align__(16) float4 sAcc[ITEMS + kMaxCluster - 1];
  __shared__ float2 sML[kMaxCluster][GT];
  __shared__ uint64_t sBar;              // the splits' partials are in

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c = blockIdx.x, b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv;
  // items f = c*per .. of the group's are this block's to merge: nsplit
  // partials of 16 bytes each, and every split's (m, l) of each head
  const int per = (ITEMS + nsplit - 1) / nsplit;
  const int cnt = max(0, min(per, ITEMS - c * per));
  if (tid == 0) {
    mbar_init(&sBar);
    mbar_expect(&sBar, uint32_t(nsplit) * (16 * cnt + 8 * GT));
  }
  cluster_arrive_relaxed();              // started, its mbarrier set
  const int hg = blockIdx.z * GT;        // first head of the group in hk's
  const int j0 = c * kc, j1 = min(j0 + kc, skv);
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  int r0 = j0 + warp * RPW;
  uint4 kr[NS][VPL], vr[NS][VPL];
  load_steps<T, D, NS>(kr, vr, kb, vb, ks.s, vs.s, r0, j1, lane);
  float qf[GT][E];
#pragma unroll
  for (int i = 0; i < GT; ++i) {
    const bool in = hg + i < g;
    const T* qh = q + b * qs.b + (hk * g + hg + i) * qs.h;
#pragma unroll
    for (int w = 0; w < VPL; ++w) {
      const uint4 u = in ? *reinterpret_cast<const uint4*>(
                               qh + (lane % L + w * L) * VE)
                         : make_uint4(0u, 0u, 0u, 0u);
      to_floats(u, &qf[i][w * VE], T());
    }
  }
  float m[GT], l[GT], acc[GT][E];
#pragma unroll
  for (int i = 0; i < GT; ++i) {
    m[i] = kMaskAdd;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
  }

  while (r0 < j1) {
    const int rn = r0 + NS * ROWS;
    uint4 kn[NS][VPL], vn[NS][VPL];
    load_steps<T, D, NS>(kn, vn, kb, vb, ks.s, vs.s, rn, j1, lane);
    const int ns = min(NS, (j1 - r0 + ROWS - 1) / ROWS);   // steps with keys
    if (ns == NS)
      warp_steps<T, D, GT, NS, true>(kr, vr, qf, m, l, acc, r0, j1, ns,
                                     scale, lane);
    else
      warp_steps<T, D, GT, NS, false>(kr, vr, qf, m, l, acc, r0, j1, ns,
                                      scale, lane);
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int w = 0; w < VPL; ++w) {
        kr[s][w] = kn[s][w];
        vr[s][w] = vn[s][w];
      }
    r0 = rn;
  }
  // the warp's l: its row groups' sums (every lane holds them)
#pragma unroll
  for (int o = L; o < 32; o <<= 1)
#pragma unroll
    for (int i = 0; i < GT; ++i)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], o);

  // the warp's partial into shared memory (acc by row group: they share
  // the warp's m), then the block's: item f (four columns of head i)
  // combines the warps' with w_w = exp(m_w - m_b), m_b = max m_w, l_b =
  // sum l_w*w_w, and goes to block f / per of the cluster (per =
  // ceil(ITEMS / nsplit) items a block); the last nsplit*GT threads take
  // each head's (m_b, l_b) to every block
#pragma unroll
  for (int i = 0; i < GT; ++i)
#pragma unroll
    for (int w = 0; w < VPL; ++w)
#pragma unroll
      for (int e = 0; e < VE; e += 4)
        sPart[warp][lane / L][i * C4 + ((lane % L + w * L) * VE + e) / 4] =
            make_float4(acc[i][w * VE + e], acc[i][w * VE + e + 1],
                        acc[i][w * VE + e + 2], acc[i][w * VE + e + 3]);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < GT; ++i) sMLw[warp][i] = make_float2(m[i], l[i]);
  }
  __syncthreads();
  cluster_wait();                        // every block's mbarrier is set
  for (int f = tid; f < ITEMS; f += kThreads) {
    const int i = f / C4, r = f / per;
    float2 mlw[kWarps];
    float mb = kMaskAdd;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      mlw[w] = sMLw[w][i];
      mb = fmaxf(mb, mlw[w].x);
    }
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float ww = expf(mlw[w].x - mb);
#pragma unroll
      for (int rg = 0; rg < RPW; ++rg) {
        const float4 t = sPart[w][rg][f];
        a.x += t.x * ww;
        a.y += t.y * ww;
        a.z += t.z * ww;
        a.w += t.w * ww;
      }
    }
    st_async(cluster_map(&sAcc[c * per + f - r * per], r), a,
             cluster_map(&sBar, r));
  }
  for (int t = kThreads - 1 - tid; t < nsplit * GT; t += kThreads) {
    const int i = t % GT, rr = t / GT;
    float2 mlw[kWarps];
    float mb = kMaskAdd, lb = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      mlw[w] = sMLw[w][i];
      mb = fmaxf(mb, mlw[w].x);
    }
#pragma unroll
    for (int w = 0; w < kWarps; ++w) lb += mlw[w].y * expf(mlw[w].x - mb);
    st_async(cluster_map(&sML[c][i], rr), make_float2(mb, lb),
             cluster_map(&sBar, rr));
  }

  // this block's items, lp lanes an item: the power of two at or above
  // nsplit, or fewer where cnt * lp passes the block's threads
  int lp = nsplit > 4 ? 8 : nsplit > 2 ? 4 : nsplit;
  while (lp > 1 && cnt * lp > kThreads) lp >>= 1;
  mbar_wait0(&sBar);
  const size_t row0 = size_t(b) * H + hk * g + hg;
  const int heads = min(GT, g - hg);
#define K4_MERGE(LP)                                                       \
  case LP:                                                                 \
    merge_items<T, D, GT, LP>(out, sAcc, sML, row0, heads, c * per, cnt,   \
                              per, nsplit, warp, lane);                    \
    break
  switch (lp) {
    K4_MERGE(1);
    K4_MERGE(2);
    K4_MERGE(4);
    K4_MERGE(8);
  }
#undef K4_MERGE
}

// ---- the wide head groups in bf16: one kv head's query heads as the rows
// of an mma.sync tile --------------------------------------------------------
//
// dec::flash_decode_mma_kernel<D> replaces, for bf16 decodes at g >= 5
// query heads a kv head and up to kMaxCluster splits (decode_kernel), the
// same TPU kernel as the rest of this file: the decode of
// src/repro/kernels/flash/kernel.py::_flash_kernel through
// flash_decode_tpu, with the function at the top of this file.
//
// What bounds it: the span's bytes are few (qwen2-72b's 8 kv heads at B 4
// over 160 keys: 2.8 MB, 0.84 us at 3.35 TB/s), so latency and issue set
// the time, as in the cluster kernel.  That kernel keeps q and acc of all
// its GT heads in f32 on every lane (about 250 registers at GT 6-8, two
// blocks an SM), sums each score over 16 lanes by shuffles, and runs
// command-r-plus's g 12 as two groups of 6 whose blocks both read every K
// and V row, in two waves.  Here all g <= 16 query heads of a kv head are
// the 16 rows of one m16n8k16 tile: the D reduction happens inside the
// instruction, O lives in fragments (64 registers at D 128; 127 in all,
// so four blocks fit an SM), each K and V row leaves memory once a split,
// and a group of up to 16 heads is one block (command-r-plus's grid is 160
// blocks, one wave).  mma.sync, not wgmma: wgmma takes 64 rows, of which a
// kv head's 7-16 heads would fill a quarter, and the kernel is not bound
// by the products.  On an H100 at the paths' shapes (about 4.5 us a call)
// the copies, products and the block's combine take about 3.3 us, the
// exchange's stores and wait 0.1-0.3 us and the merge 0.4-0.8 us: one pass
// of dependent loads, exponentials and divisions a thread, with 4 warps an
// SM.  One bulk copy a peer (cp.async.bulk) in place of the st.async
// stores ran 5-8 % slower, its closing cluster barrier included.
//
// Block (c, b*Hkv + hk, z) of a cluster of the nsplit blocks of one (b, kv
// head, z) takes keys [c*kc, min((c+1)*kc, skv)) for query heads hk*g +
// 16z + r (r < 16; rows at or past g hold zero q and are never stored):
//  1. Q's 16 rows go to shared memory by 16-byte cp.async; each warp takes
//     the chunk's 16-key groups w, w + 4, ..., each group's K and V rows
//     copied by cp.async into the warp's own ring (all of a warp's first
//     two groups in flight at once: kc <= 32 keys at the paths' spans; a
//     second stage only where the chunk holds more than 4 groups), rows
//     padded by 8 elements, so ldmatrix (K, Q) and ldmatrix.trans (V) are
//     free of bank conflicts.  One block barrier, for Q; the warps' loops
//     have none.
//  2. Per group, S = Q K^T: 16 heads x 16 keys from ldmatrix'd fragments
//     (Q's read from shared memory a k-step: held in registers they took
//     32 more at D 128 and ran no faster), the even and odd k-steps into
//     two accumulators; the scaled scores' row max and sum cross a
//     quad by two shuffles (the online softmax in f32, l summing the f32
//     p); P rounded to bf16 is repacked from the C fragments into A
//     fragments in registers, and O += P V takes V's fragments from
//     ldmatrix.trans.
//  3. The warps' (m, l, O) are combined in shared memory (each warp's O
//     over its own first stage) and exchanged as in the cluster kernel:
//     each split's partial of item f (four columns of one head) goes by
//     st.async into the shared memory of block f / per of the cluster,
//     completing on its mbarrier, and merge_items writes out.  Only the
//     group's live heads are exchanged.
constexpr int kMmaRows = 16;      // a block's query heads: the tile's rows
constexpr int kMmaKeys = 16;      // a warp's key group: P's k16
constexpr int kMmaPad = 8;        // bf16 elements of padding a shared row
constexpr int kMmaMinGroup = 5;   // the least g the kernel takes

// The kernel a decode launch takes (ops.decode_kernel mirrors it): past
// kMaxCluster splits the split and merge kernels; up to it, a bf16 decode
// at g >= kMmaMinGroup the mma kernel, any other the cluster kernel.
enum { kSplitKernel = 0, kClusterKernel = 1, kMmaKernel = 2 };
__host__ __device__ constexpr int decode_kernel(int dtype, int g,
                                                int nsplit) {
  return nsplit > kMaxCluster ? kSplitKernel
         : dtype == 1 && g >= kMmaMinGroup ? kMmaKernel
                                           : kClusterKernel;
}

// A warp's ring: two stages where a chunk of kc keys holds more than one
// group a warp, else one.  Shared bytes: Q's 16 rows, then each warp's
// stages of K and V (16 rows each), all padded bf16 rows.
__host__ __device__ constexpr int mma_stages(int kc) {
  return (kc + kMmaKeys - 1) / kMmaKeys > kWarps ? 2 : 1;
}
template <int D>
__host__ __device__ constexpr int mma_smem_bytes(int stages) {
  return 2 * (D + kMmaPad) * (kMmaRows + kWarps * stages * 2 * kMmaKeys);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// c (16x8 f32) += a (16x16 bf16, row) . b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// a lane's row and column in the 16x16 block that ldmatrix.x4 reads for an
// A fragment (Q), or for V's B fragments with .trans: matrices (rows 0-7,
// cols 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
__device__ __forceinline__ int a_row(int lane) {
  return (lane & 7) + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ int a_col(int lane) { return (lane >> 4) * 8; }
// ... and for K's B fragments of two n8 key blocks: (keys 0-7, d 0-7),
// (keys 0-7, d 8-15), (keys 8-15, d 0-7), (keys 8-15, d 8-15)
__device__ __forceinline__ int b_row(int lane) {
  return (lane & 7) + (lane >> 4) * 8;
}
__device__ __forceinline__ int b_col(int lane) {
  return ((lane >> 3) & 1) * 8;
}

// rows [r0, r0 + 16) of one head of a cache into a warp's [16][D + 8]
// tile, 16 bytes a lane a copy; rows at or past j1 are zero-filled
template <int D>
__device__ __forceinline__ void load_group(__nv_bfloat16* s,
                                           const __nv_bfloat16* g,
                                           long long stride, int r0, int j1,
                                           int lane) {
  constexpr int NV = D / 8, RS = D + kMmaPad;
#pragma unroll
  for (int i = lane; i < kMmaKeys * NV; i += 32) {
    const int r = i / NV, cv = i % NV;
    const bool in = r0 + r < j1;
    mma::cp_async16(mma::smem_u32(s + r * RS + cv * 8),
                    in ? g + (r0 + r) * stride + cv * 8 : g, in);
  }
}

// The note above gives the design; the cluster kernel's (its steps 2-3)
// gives the exchange, whose barriers and byte counts this kernel keeps.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_decode_mma_kernel(__nv_bfloat16* __restrict__ out,
                        const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, Strides qs,
                        Strides ks, Strides vs, int H, int Hkv, int g,
                        int skv, int kc, int nsplit, float scale) {
  using bf16 = __nv_bfloat16;
  constexpr int GT = kMmaRows, RS = D + kMmaPad;
  constexpr int NK = D / 16;             // k16 steps of S = Q K^T
  constexpr int NO = D / 8;              // n8 blocks of O
  constexpr int NV = D / 8;              // 16-byte vectors a row
  constexpr int C4 = D / 4;              // four-column items of a head
  constexpr int WS = 2 * kMmaKeys * RS;  // a warp's stage: K, then V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);          // [16][RS]
  // split c's acc of this block's item fl at [c*per + fl], its (m, l)
  __shared__ __align__(16) float4 sAcc[GT * C4 + kMaxCluster - 1];
  __shared__ float2 sML[kMaxCluster][GT];
  __shared__ float2 sMLw[kWarps][GT];                    // warps' (m, l)
  __shared__ uint64_t sBar;              // the splits' partials are in

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tig = lane & 3;  // fragment row, column pair
  const int c = blockIdx.x, b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv;
  const int hg = blockIdx.z * GT;        // first head of the block in hk's
  const int heads = min(GT, g - hg);     // its live heads
  // items f = c*per .. of the block's live heads' are its to merge
  const int items = heads * C4;
  const int per = (items + nsplit - 1) / nsplit;
  const int cnt = max(0, min(per, items - c * per));
  if (tid == 0) {
    mbar_init(&sBar);
    mbar_expect(&sBar, uint32_t(nsplit) * (16 * cnt + 8 * heads));
  }
  cluster_arrive_relaxed();              // started, its mbarrier set
  const int j0 = c * kc, j1 = min(j0 + kc, skv);
  const int groups = (j1 - j0 + kMmaKeys - 1) / kMmaKeys;
  const int stages = mma_stages(kc);
  bf16* sW = sQ + GT * RS + warp * stages * WS;          // the warp's ring
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;

  // Q (one copy group), then the warp's groups w and w + 4 into its
  // stages, K and V a copy group each (empty where there is no group)
  const bf16* qb = q + b * qs.b + (hk * g + hg) * qs.h;
  for (int i = tid; i < GT * NV; i += kThreads) {
    const int r = i / NV, cv = i % NV;
    mma::cp_async16(mma::smem_u32(sQ + r * RS + cv * 8),
                    r < heads ? qb + r * qs.h + cv * 8 : qb, r < heads);
  }
  mma::cp_async_commit();
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int grp = warp + s * kWarps;
    const bool has = s < stages && grp < groups;
    if (has)
      load_group<D>(sW + s * WS, kb, ks.s, j0 + grp * kMmaKeys, j1, lane);
    mma::cp_async_commit();
    if (has)
      load_group<D>(sW + s * WS + kMmaKeys * RS, vb, vs.s,
                    j0 + grp * kMmaKeys, j1, lane);
    mma::cp_async_commit();
  }
  mma::cp_async_wait<4>();               // Q has landed
  __syncthreads();                       // ... for every thread

  const uint32_t qa = mma::smem_u32(sQ + a_row(lane) * RS + a_col(lane));
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kMaskAdd, kMaskAdd}, l[2] = {0.f, 0.f};  // rows gr, gr + 8
  const uint32_t kfrag = 2 * (b_row(lane) * RS + b_col(lane));
  const uint32_t vfrag = 2 * ((kMmaKeys + a_row(lane)) * RS + a_col(lane));

  int st = 0;                            // the group's stage
  for (int grp = warp; grp < groups; grp += kWarps) {
    mma::cp_async_wait<3>();             // the group's K
    __syncwarp();
    const uint32_t base = mma::smem_u32(sW + st * WS);
    float s[2][2][4];                    // even and odd k-steps, two n8
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[h][n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t a[4], bk[4];
      ldsm_x4(a, qa + kk * 32);
      ldsm_x4(bk, base + kfrag + kk * 32);
      mma_bf16(s[kk & 1][0], a, bk[0], bk[1]);
      mma_bf16(s[kk & 1][1], a, bk[2], bk[3]);
    }
    // the scaled scores (keys at or past j1 at -inf), the quad's row max,
    // p = exp(s - m) summed unrounded into l, and O's correction
    const int key0 = j0 + grp * kMmaKeys + 2 * tig;
    float x[2][4], mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[n][e] = key0 + n * 8 + (e & 1) < j1
                      ? (s[0][n][e] + s[1][n][e]) * scale
                      : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], x[n][e]);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[n][e] = expf(x[n][e] - m[e >> 1]);
        l[e >> 1] += x[n][e];
      }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }
    // O += round_to_bf16(P) . V: S's C fragments are P's A fragment
    const uint32_t pa[4] = {mma::pack_bf16(x[0][0], x[0][1]),
                            mma::pack_bf16(x[0][2], x[0][3]),
                            mma::pack_bf16(x[1][0], x[1][1]),
                            mma::pack_bf16(x[1][2], x[1][3])};
    mma::cp_async_wait<2>();             // the group's V
    __syncwarp();
#pragma unroll
    for (int nb = 0; nb < D / 16; ++nb) {
      uint32_t bv[4];
      ldsm_x4_trans(bv, base + vfrag + nb * 32);
      mma_bf16(o[2 * nb], pa, bv[0], bv[1]);
      mma_bf16(o[2 * nb + 1], pa, bv[2], bv[3]);
    }
    __syncwarp();                        // the stage is read: refill it
    const int nxt = grp + 2 * kWarps;    // (only where there are 2 stages)
    if (nxt < groups)
      load_group<D>(sW + st * WS, kb, ks.s, j0 + nxt * kMmaKeys, j1, lane);
    mma::cp_async_commit();
    if (nxt < groups)
      load_group<D>(sW + st * WS + kMmaKeys * RS, vb, vs.s,
                    j0 + nxt * kMmaKeys, j1, lane);
    mma::cp_async_commit();
    st ^= stages - 1;
  }
  mma::cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < 2; ++r) {          // the warp's l: its quad's sums
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }

  // the warp's O (f32, rows of RS floats) over its first stage, its (m, l)
  // beside; a warp with no group writes zeros at m = -1e30, weight 0
  __syncwarp();
  float* sP = reinterpret_cast<float*>(sW);
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(sP + (gr + 8 * r) * RS + n * 8 + 2 * tig) =
          make_float2(o[n][2 * r], o[n][2 * r + 1]);
  if (tig == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      sMLw[warp][gr + 8 * r] = make_float2(m[r], l[r]);
  }
  __syncthreads();
  cluster_wait();                        // every block's mbarrier is set
  // item f (four columns of head i) combines the warps' with w_w =
  // exp(m_w - m_b) into the split's partial and goes to block f / per;
  // the last nsplit*heads threads take each head's (m_b, l_b) to every
  // block
  for (int f = tid; f < items; f += kThreads) {
    const int i = f / C4, r = f / per;
    float2 mlw[kWarps];
    float mb = kMaskAdd;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      mlw[w] = sMLw[w][i];
      mb = fmaxf(mb, mlw[w].x);
    }
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float ww = expf(mlw[w].x - mb);
      const float4 t = *reinterpret_cast<const float4*>(
          reinterpret_cast<const float*>(sQ + GT * RS + w * stages * WS) +
          i * RS + (f % C4) * 4);
      a.x += t.x * ww;
      a.y += t.y * ww;
      a.z += t.z * ww;
      a.w += t.w * ww;
    }
    st_async(cluster_map(&sAcc[c * per + f - r * per], r), a,
             cluster_map(&sBar, r));
  }
  for (int t = kThreads - 1 - tid; t < nsplit * heads; t += kThreads) {
    const int i = t % heads, rr = t / heads;
    float2 mlw[kWarps];
    float mb = kMaskAdd, lb = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      mlw[w] = sMLw[w][i];
      mb = fmaxf(mb, mlw[w].x);
    }
#pragma unroll
    for (int w = 0; w < kWarps; ++w) lb += mlw[w].y * expf(mlw[w].x - mb);
    st_async(cluster_map(&sML[c][i], rr), make_float2(mb, lb),
             cluster_map(&sBar, rr));
  }

  int lp = nsplit > 4 ? 8 : nsplit > 2 ? 4 : nsplit;
  while (lp > 1 && cnt * lp > kThreads) lp >>= 1;
  mbar_wait0(&sBar);
  const size_t row0 = size_t(b) * H + hk * g + hg;
#define K4_MERGE(LP)                                                       \
  case LP:                                                                 \
    merge_items<bf16, D, GT, LP>(out, sAcc, sML, row0, heads, c * per, cnt, \
                                 per, nsplit, warp, lane);                 \
    break
  switch (lp) {
    K4_MERGE(1);
    K4_MERGE(2);
    K4_MERGE(4);
    K4_MERGE(8);
  }
#undef K4_MERGE
}

// More than kMaxCluster splits: block (c, b*Hkv + hk, z) takes keys
// [c*kc, min((c+1)*kc, skv)) of kv head hk for query heads hk*g + z*GT + i
// (i < GT, those below g).  K and V go through shared memory in tiles of
// KT keys (cp.async, one group each; the next tile's K is fetched while
// this tile's p . v runs).  Per tile: the GT scores of each key
// (tile_scores), then per head the tile's max, p = exp(s - m), l and the
// correction of the running acc (warp i % 4 for head i), then acc = acc *
// corr + round_to<T>(p) . v with each thread owning one (head, 16-byte
// column vector) item.  (m, l, acc) of the split then go to
// the f32 workspace for the merge kernel (acc rows of D, then (m, l)
// pairs, both 8-byte aligned since D is a multiple of 64).
template <typename T, int D, int GT>
__global__ void __launch_bounds__(kThreads, 1)
flash_decode_split_kernel(float* __restrict__ ws_acc,
                          float2* __restrict__ ws_ml, const T* __restrict__ q,
                          const T* __restrict__ k, const T* __restrict__ v,
                          Strides qs, Strides ks, Strides vs, int H, int Hkv,
                          int g, int skv, int kc, int nsplit, float scale) {
  using S = Shape<T, D>;
  constexpr int KT = S::KT, VE = S::VE, NV = S::NV, L = S::L;
  constexpr int VPL = S::VPL, E = S::E;
  constexpr int ITEMS = GT * NV;
  constexpr int IPT = (ITEMS + kThreads - 1) / kThreads;
  constexpr int KW = (KT + 31) / 32;     // a tile's keys per lane
  static_assert(KT % (kWarps * S::RPW) == 0, "tile rows per warp step");
  __shared__ __align__(16) T sK[KT * D];
  __shared__ __align__(16) T sV[KT * D];
  __shared__ float sS[GT][KT];           // scores, then rounded p
  __shared__ float sM[GT], sL[GT], sC[GT];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c = blockIdx.x, b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv;
  const int hg = blockIdx.z * GT;        // first head of the group in hk's
  const int j0 = c * kc, j1 = min(j0 + kc, skv);
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  load_rows<T, D>(sK, kb, ks.s, j0, min(KT, j1 - j0), tid);
  mma::cp_async_commit();
  load_rows<T, D>(sV, vb, vs.s, j0, min(KT, j1 - j0), tid);
  mma::cp_async_commit();

  // this lane's part of each head's q row, while the first tile arrives
  float qf[GT][E];
#pragma unroll
  for (int i = 0; i < GT; ++i) {
    const bool in = hg + i < g;
    const T* qh = q + b * qs.b + (hk * g + hg + i) * qs.h;
#pragma unroll
    for (int w = 0; w < VPL; ++w) {
      const uint4 u = in ? *reinterpret_cast<const uint4*>(
                               qh + (lane % L + w * L) * VE)
                         : make_uint4(0u, 0u, 0u, 0u);
      to_floats(u, &qf[i][w * VE], T());
    }
  }
  if (tid < GT) {
    sM[tid] = kMaskAdd;
    sL[tid] = 0.f;
  }
  float acc[IPT][VE];
#pragma unroll
  for (int it = 0; it < IPT; ++it)
#pragma unroll
    for (int e = 0; e < VE; ++e) acc[it][e] = 0.f;

  for (int t0 = j0; t0 < j1; t0 += KT) {
    const int n = min(KT, j1 - t0), t1 = t0 + KT;
    mma::cp_async_wait<1>();             // this tile's K
    __syncthreads();
    tile_scores<T, D, GT>(sS, sK, qf, n, scale, warp, lane);
    __syncthreads();                     // scores in; sK free
    if (t1 < j1) load_rows<T, D>(sK, kb, ks.s, t1, min(KT, j1 - t1), tid);
    mma::cp_async_commit();              // (possibly empty) next K

    // online softmax over the tile, one warp per head
    for (int i = warp; i < GT; i += kWarps) {
      float x[KW], mx = -INFINITY;
#pragma unroll
      for (int w = 0; w < KW; ++w) {
        const int j = lane + 32 * w;
        x[w] = j < n ? sS[i][j] : -INFINITY;
        mx = fmaxf(mx, x[w]);
      }
      const float m_old = sM[i];
      const float m_new = fmaxf(m_old, warp_max(mx));
      float psum = 0.f;
#pragma unroll
      for (int w = 0; w < KW; ++w) {
        const int j = lane + 32 * w;
        const float p = expf(x[w] - m_new);
        psum += p;
        if (j < n) sS[i][j] = round_to<T>(p);
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        sM[i] = m_new;
        sL[i] = sL[i] * corr + psum;
        sC[i] = corr;
      }
    }
    mma::cp_async_wait<1>();             // this tile's V
    __syncthreads();                     // p, corr and V in

#pragma unroll
    for (int it = 0; it < IPT; ++it) {
      const int item = tid + it * kThreads;
      if (item < ITEMS) {
        const int i = item / NV, cv = item % NV;
        const float corr = sC[i];
#pragma unroll
        for (int e = 0; e < VE; ++e) acc[it][e] *= corr;
#pragma unroll 4
        for (int j = 0; j < n; ++j) {
          const float p = sS[i][j];
          float vf[VE];
          to_floats(*reinterpret_cast<const uint4*>(sV + j * D + cv * VE),
                    vf, T());
#pragma unroll
          for (int e = 0; e < VE; ++e) acc[it][e] += p * vf[e];
        }
      }
    }
    __syncthreads();                     // sV and sS free
    if (t1 < j1) load_rows<T, D>(sV, vb, vs.s, t1, min(KT, j1 - t1), tid);
    mma::cp_async_commit();              // (possibly empty) next V
  }

  // the block's coordinates read afresh: held through the tile loop they
  // cost a spill at some instantiations
  const int cx = ctaid(0), cy = ctaid(1);
  const int hg1 = ctaid(2) * GT;
  const size_t row0 = size_t(cy / Hkv) * H + (cy % Hkv) * g + hg1;
#pragma unroll
  for (int it = 0; it < IPT; ++it) {
    const int item = tid + it * kThreads;
    const int i = item / NV, cv = item % NV;
    if (item >= ITEMS || hg1 + i >= g) continue;
    const size_t row = row0 + i;                           // b*H + h
    float4* wa = reinterpret_cast<float4*>(
        ws_acc + (row * nsplit + cx) * D + cv * VE);
#pragma unroll
    for (int e = 0; e < VE; e += 4)
      wa[e / 4] = make_float4(acc[it][e], acc[it][e + 1], acc[it][e + 2],
                              acc[it][e + 3]);
  }
  if (tid < GT && hg1 + tid < g)
    ws_ml[(row0 + tid) * nsplit + cx] = make_float2(sM[tid], sL[tid]);
}

// Block (b*H + h, column slab), a thread per column.  Every warp reads
// the splits' (m_c, l_c) itself, split c in lane c % 32, takes m_all with
// a warp max, each split's weight exp(m_c - m_all) in its lane and l_all
// with a warp sum; a thread then sums acc_c * w_c over the splits (w_c
// from lane c % 32 by shuffle) and writes acc / max(l_all, 1e-30).  The
// first 32 splits' acc are loaded with the (m, l) pairs, before the
// weights: one round trip to L2, no shared memory and no barrier.
template <typename T>
__global__ void __launch_bounds__(kMergeCols)
flash_decode_merge_kernel(T* __restrict__ out,
                          const float* __restrict__ ws_acc,
                          const float2* __restrict__ ws_ml, int D,
                          int nsplit) {
  constexpr int kPerLane = (kMaxSplits + 31) / 32;
  const int row = blockIdx.x, lane = threadIdx.x & 31;
  const int d = blockIdx.y * kMergeCols + threadIdx.x;
  const float2* ml = ws_ml + size_t(row) * nsplit;
  const float* a = ws_acc + size_t(row) * nsplit * D + d;
  float pre[32];
#pragma unroll
  for (int c = 0; c < 32; ++c) pre[c] = c < nsplit ? a[size_t(c) * D] : 0.f;
  float2 mine[kPerLane];
  float m = kMaskAdd;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int c = lane + 32 * k;
    mine[k] = c < nsplit ? ml[c] : make_float2(kMaskAdd, 0.f);
    m = fmaxf(m, mine[k].x);
  }
  m = warp_max(m);
  float w[kPerLane], l = 0.f;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    w[k] = lane + 32 * k < nsplit ? expf(mine[k].x - m) : 0.f;
    l += mine[k].y * w[k];
  }
  l = warp_sum(l);
  float o = 0.f;
#pragma unroll
  for (int c = 0; c < 32; ++c)
    o += pre[c] * __shfl_sync(0xffffffffu, w[0], c);
#pragma unroll
  for (int k = 1; k < kPerLane; ++k) {
    if (32 * k >= nsplit) break;
#pragma unroll 8
    for (int cc = 0; cc < 32; ++cc) {
      const int c = 32 * k + cc;
      const float wc = __shfl_sync(0xffffffffu, w[k], cc);
      if (c < nsplit) o += a[size_t(c) * D] * wc;
    }
  }
  out[size_t(row) * D + d] = from_f<T>(o / fmaxf(l, 1e-30f));
}

// A launch of clusters of nsplit blocks along x (cudaLaunchKernelEx)
struct ClusterLaunch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = {};
  ClusterLaunch(dim3 grid, int nsplit, size_t smem, cudaStream_t stream) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = nsplit;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = grid;
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// The mma kernel: one launch of clusters of nsplit blocks, a cluster the
// splits of one (b, kv head, 16 query heads).  Its shared bytes pass 48 KB
// at two stages and at D 256, so it opts in to two stages' bytes once a
// device.
template <int D>
cudaError_t launch_decode_mma(void* out, const void* q, const void* k,
                              const void* v, Strides qs, Strides ks,
                              Strides vs, int B, int H, int Hkv, int skv,
                              int kc, int nsplit, float scale,
                              cudaStream_t stream) {
  constexpr int kDevices = 64;
  static bool opted[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kDevices || !opted[dev]) {
    err = cudaFuncSetAttribute(flash_decode_mma_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               mma_smem_bytes<D>(2));
    if (err != cudaSuccess) return err;
    if (dev < kDevices) opted[dev] = true;
  }
  const int g = H / Hkv;
  const ClusterLaunch cl(dim3(nsplit, B * Hkv, (g + kMmaRows - 1) / kMmaRows),
                         nsplit, mma_smem_bytes<D>(mma_stages(kc)), stream);
  using bf16 = __nv_bfloat16;
  err = cudaLaunchKernelEx(
      &cl.cfg, flash_decode_mma_kernel<D>, static_cast<bf16*>(out),
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), qs, ks, vs, H, Hkv, g, skv, kc, nsplit,
      scale);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Up to kMaxCluster splits: the cluster kernel as one launch of clusters
// of nsplit blocks (cudaLaunchKernelEx), each cluster the splits of one
// (b, kv head, head group).  More: the split kernel writing the
// workspace, then the merge kernel.
template <typename T, int D, int GT>
cudaError_t launch_decode(void* out, float* ws, const void* q, const void* k,
                          const void* v, Strides qs, Strides ks, Strides vs,
                          int B, int H, int Hkv, int skv, int kc, int nsplit,
                          float scale, cudaStream_t stream) {
  const int g = H / Hkv;
  const dim3 grid(nsplit, B * Hkv, (g + GT - 1) / GT);
  T* o = static_cast<T*>(out);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  if (nsplit <= kMaxCluster) {
    // the cluster kernel is not built where the mma kernel takes every
    // launch (decode_kernel: bf16 at g >= 5, whose groups are 6 or 8)
    if constexpr (std::is_same<T, __nv_bfloat16>::value && GT > 4) {
      return cudaErrorInvalidValue;
    } else {
      const ClusterLaunch cl(grid, nsplit, 0, stream);
      const cudaError_t err = cudaLaunchKernelEx(
          &cl.cfg, flash_decode_cluster_kernel<T, D, GT>, o, qt, kt, vt, qs,
          ks, vs, H, Hkv, g, skv, kc, nsplit, scale);
      return err != cudaSuccess ? err : cudaGetLastError();
    }
  }
  float2* ws_ml = reinterpret_cast<float2*>(ws + size_t(B) * H * nsplit * D);
  flash_decode_split_kernel<T, D, GT><<<grid, kThreads, 0, stream>>>(
      ws, ws_ml, qt, kt, vt, qs, ks, vs, H, Hkv, g, skv, kc, nsplit, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_decode_merge_kernel<T><<<dim3(B * H, D / kMergeCols), kMergeCols, 0,
                                 stream>>>(o, ws, ws_ml, D, nsplit);
  return cudaGetLastError();
}

// the launch at g's head-group width (head_group)
template <typename T, int D>
cudaError_t launch_decode_any_g(void* out, float* ws, const void* q,
                                const void* k, const void* v, Strides qs,
                                Strides ks, Strides vs, int B, int H, int Hkv,
                                int skv, int kc, int nsplit, float scale,
                                cudaStream_t stream) {
#define K4_DECODE_G(GT)                                                    \
  case GT:                                                                 \
    return launch_decode<T, D, GT>(out, ws, q, k, v, qs, ks, vs, B, H, Hkv, \
                                   skv, kc, nsplit, scale, stream)
  switch (head_group(H / Hkv)) {
    K4_DECODE_G(1);
    K4_DECODE_G(2);
    K4_DECODE_G(3);
    K4_DECODE_G(4);
    K4_DECODE_G(6);
    K4_DECODE_G(8);
  }
  return cudaErrorInvalidValue;
#undef K4_DECODE_G
}

}  // namespace dec

}  // namespace

// dtype: 0 float32, 1 bfloat16; one head dim D of 64, 128 or 256
// (K4_DISPATCH_D).  Strides are in elements: (b, h) for q, (b, s, h) for
// k and v.
#define K4_DISPATCH_D(CALL, T)                                             \
  do {                                                                     \
    if (D == 64) return int(CALL(T, 64));                                  \
    if (D == 128) return int(CALL(T, 128));                                \
    if (D == 256) return int(CALL(T, 256));                                \
    return int(cudaErrorInvalidValue);                                     \
  } while (0)

// The decode form (dec::launch_decode): up to 8 splits, the cluster kernel
// as clusters of nsplit blocks that merge in distributed shared memory (ws
// unused, may be null); more, the split kernel writing ws, then the merge
// kernel, on one stream.  ws: f32
// workspace of B*H*nsplit*(D + 2) floats (acc, then (m, l) pairs); chunk
// c holds keys [c*kc, min((c+1)*kc, skv)), and the chunks must cover skv
// with none empty.
extern "C" int flash_decode_launch(void* out, void* ws, const void* q,
                                   const void* k, const void* v, int dtype,
                                   int B, int H, int Hkv, int D, int skv,
                                   int kc, int nsplit, long long qsb,
                                   long long qsh, long long ksb,
                                   long long kss, long long ksh,
                                   long long vsb, long long vss,
                                   long long vsh, float scale, void* stream) {
  if (nsplit < 1 || nsplit > dec::kMaxSplits || kc < 1 ||
      (long long)(nsplit - 1) * kc >= skv || (long long)nsplit * kc < skv ||
      (nsplit > dec::kMaxCluster && ws == nullptr))
    return int(cudaErrorInvalidValue);
  const Strides qs{qsb, 0, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  if (dec::decode_kernel(dtype, H / Hkv, nsplit) == dec::kMmaKernel) {
#define K4_DECODE_MMA(T, DD)                                               \
  dec::launch_decode_mma<DD>(out, q, k, v, qs, ks, vs, B, H, Hkv, skv, kc, \
                             nsplit, scale, st)
    K4_DISPATCH_D(K4_DECODE_MMA, __nv_bfloat16);
#undef K4_DECODE_MMA
  }
#define K4_DECODE(T, DD)                                                   \
  dec::launch_decode_any_g<T, DD>(out, w, q, k, v, qs, ks, vs, B, H, Hkv,  \
                                  skv, kc, nsplit, scale, st)
  if (dtype == 0) K4_DISPATCH_D(K4_DECODE, float);
  if (dtype == 1) K4_DISPATCH_D(K4_DECODE, __nv_bfloat16);
  return int(cudaErrorInvalidValue);
#undef K4_DECODE
}

// The decode form's head-group width for g query heads a kv head (the
// split and cluster kernels' GT; ops.decode_head_group is its mirror), the
// most splits it merges in one cluster, and the kernel a launch of dtype
// (0 float32, 1 bfloat16) at g query heads a kv head over nsplit splits
// takes (dec::decode_kernel, mirrored by ops.decode_kernel): 0 the split
// and merge kernels, 1 the cluster kernel, 2 the mma kernel.
extern "C" int flash_decode_head_group(int g) { return dec::head_group(g); }
extern "C" int flash_decode_max_cluster() { return dec::kMaxCluster; }
extern "C" int flash_decode_kernel(int dtype, int g, int nsplit) {
  return dec::decode_kernel(dtype, g, nsplit);
}

