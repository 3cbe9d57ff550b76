// K4: flash attention with an online softmax, in three forms: a prefill
// form on the tensor cores for bf16 (flash_attn_mma.cuh), a SIMT prefill
// form for float (below) and a decode form for both.
//
// Replaces the TPU kernel src/repro/kernels/flash/kernel.py::_flash_kernel
// (driver flash_bhsd, wrappers flash_attention_tpu / flash_decode_tpu).
// The TPU kernel carries the online softmax across KV tiles in scratch
// memory along a sequential grid axis; here a block loops over its tiles,
// and the decode form splits the keys over blocks and merges the partial
// softmaxes in a second kernel.
//
//   s = (q . k^T) * (1/sqrt(D))                      in f32
//   s += -1e30 where the causal or window mask drops (k, q)
//   m, l, acc: online softmax over KV tiles           in f32
//   acc += round_to_v_dtype(p) . v                    (kernel.py:58)
//   out = acc / max(l, 1e-30)                         in q's dtype
//
// q (B, Sq, H, D) and k, v (B, Skv, Hkv, D) are read through their element
// strides, with only D contiguous, so neither a prefill's projections nor a
// decode step's slice of the cache is copied.  Query head h reads kv head
// h / g (GQA); no KV is repeated in memory.  out is (B, Sq, H, D),
// contiguous.  Keys at or past skv get no weight at all; a row whose band
// holds no key sees every key at -1e30 and so averages them uniformly, as
// the plain version (attention_ref) does.
//
// bf16 prefill: flash_attn_mma.cuh (mma.sync m16n8k16, ldmatrix, a
// cp.async ring); its note gives the design.
//
// f32 prefill (the SIMT form): one block of 256 threads per (b*H + h,
// 64-row q tile), looping over 64-row KV tiles from the first to the last
// that meets the tile's causal and window band (tiles wholly outside it are
// skipped).  All operands sit in shared memory as f32: Q (64 x D), K
// transposed (D x 64), V (64 x D) and the score tile; for D = 256 that is
// 219,136 bytes, so the launcher raises the block's dynamic shared memory
// limit.  Each thread computes a 4 x 4 block of scores (float4 reads of Q
// rows and K^T columns); each warp owns 8 query rows for the softmax and
// for the f32 accumulator (8 rows x D/32 columns in registers), so m and l
// live in registers and no tile-sized accumulator goes through shared
// memory.  f32 stays off the tensor cores on purpose: their f32 input is
// TF32, whose 10-bit mantissa would break the f32 tolerance of 2e-5 that
// the reference's tests hold this form to.
//
// Decode form (Sq = 1), split-KV: a split kernel on a grid (nsplit,
// B*Hkv, head groups) whose block (c, b*Hkv + hk) takes keys [c*kc,
// min((c+1)*kc, skv)) for all g query heads of kv head hk (up to 8 per
// block), so each K and V row leaves device memory once however many
// heads share it; then a merge kernel that rescales the splits' (m, l,
// acc) by exp(m_c - m_all), sums them and divides by max(l_all, 1e-30).
// The Python wrapper picks kc and nsplit (ops.decode_split: about one
// block per SM, chunks of at least 16 keys) and allocates the f32
// workspace; one split writes out directly and skips the merge.  Rows
// move with 16-byte cp.async / vector loads, so every row start must be
// 16-byte aligned (the wrapper raises otherwise).  The note on
// dec::flash_decode_split_kernel gives the tiles.
//
// Bound on an H100: at the main path's prefill (B 4, S 1024, H 4, Hkv 1,
// D 256) the work is about 8.6e9 flops for the causal layers, 8.7 us at the
// bf16 tensor-core rate, and 21 MB of q, k, v and out (6.3 us): bound by
// operations.  The f32 SIMT form runs its products on the f32 FMA lanes
// and can at best reach the 67 TFLOP/s f32 rate; the bf16 form uses the
// tensor cores through mma.sync.  A decode step reads the cache span once
// and is bound by bytes: at the main path's decode (B 4, H 4, Hkv 1, D 256,
// 1024 keys, bf16) 4.2 MB, 1.3 us at 3.35 TB/s, which takes most of the
// card's SMs streaming at once; the split over keys gives the 4 (b, kv
// head) pairs 128 blocks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attn_mma.cuh"   // Strides, launch_mma

namespace {

constexpr int kBQ = 64;          // query rows per prefill block
constexpr int kBK = 64;          // keys per KV tile
constexpr int kThreads = 256;    // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kBQ / kWarps;   // 8
constexpr float kMaskAdd = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}
// p.astype(v.dtype) before p . v
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr size_t prefill_smem_bytes() {
  return sizeof(float) * (size_t(kBQ) * (D + 4) + size_t(D) * (kBK + 4) +
                          size_t(kBK) * D + size_t(kBQ) * (kBK + 4));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(T* __restrict__ out, const T* __restrict__ q,
                     const T* __restrict__ k, const T* __restrict__ v,
                     Strides qs, Strides ks, Strides vs, int H, int g, int sq,
                     int skv, int causal, int window, float scale) {
  constexpr int QS = D + 4;      // padded row strides (float4-aligned)
  constexpr int KS = kBK + 4;
  constexpr int PS = kBK + 4;
  constexpr int CPT = D / 32;    // accumulator columns per lane
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);   // [kBQ][QS]
  float* sKt = sQ + kBQ * QS;                    // [D][KS]
  float* sV = sKt + D * KS;                      // [kBK][D]
  float* sP = sV + kBK * D;                      // [kBQ][PS]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, hk = h / g;
  const int q0 = blockIdx.x * kBQ;
  const int q1 = min(q0 + kBQ, sq);
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    sQ[r * QS + d] = q0 + r < sq ? to_f(qb[(q0 + r) * qs.s + d]) : 0.f;
  }

  // the keys this tile's band meets; a row with no key in its band (only
  // possible with a window and sq > skv) needs every key, at -1e30
  int kv_lo = 0, kv_hi = causal ? min(skv, q1) : skv;
  if (window > 0) {
    if (q1 - window >= skv) kv_hi = skv;
    else kv_lo = max(0, q0 - window + 1);
  }

  float acc[kRowsPerWarp][CPT];
  float m_r[kRowsPerWarp], l_r[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m_r[rr] = kMaskAdd;
    l_r[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[rr][c] = 0.f;
  }
  const int rg = tid >> 4, cg = tid & 15;   // score rows rg*4.., cols cg*4..

  for (int t0 = kv_lo; t0 < kv_hi; t0 += kBK) {
    __syncthreads();   // Q is loaded; the previous tile's K, V, P are read
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D, d = i % D;
      const bool in = t0 + c < skv;
      sKt[d * KS + c] = in ? to_f(kb[(t0 + c) * ks.s + d]) : 0.f;
      sV[c * D + d] = in ? to_f(vb[(t0 + c) * vs.s + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&sQ[(rg * 4 + i) * QS + d]);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        kv[u] = *reinterpret_cast<const float4*>(&sKt[(d + u) * KS + cg * 4]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i][0] += qv[i].x * kv[0].x; s[i][1] += qv[i].x * kv[0].y;
        s[i][2] += qv[i].x * kv[0].z; s[i][3] += qv[i].x * kv[0].w;
        s[i][0] += qv[i].y * kv[1].x; s[i][1] += qv[i].y * kv[1].y;
        s[i][2] += qv[i].y * kv[1].z; s[i][3] += qv[i].y * kv[1].w;
        s[i][0] += qv[i].z * kv[2].x; s[i][1] += qv[i].z * kv[2].y;
        s[i][2] += qv[i].z * kv[2].z; s[i][3] += qv[i].z * kv[2].w;
        s[i][0] += qv[i].w * kv[3].x; s[i][1] += qv[i].w * kv[3].y;
        s[i][2] += qv[i].w * kv[3].z; s[i][3] += qv[i].w * kv[3].w;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg * 4 + i, qi = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = cg * 4 + j, kj = t0 + c;
        float x = -INFINITY;                  // past the keys: no weight
        if (kj < skv) {
          bool keep = !causal || kj <= qi;
          if (window > 0) keep = keep && kj > qi - window;
          x = s[i][j] * scale + (keep ? 0.f : kMaskAdd);
        }
        sP[r * PS + c] = x;
      }
    }
    __syncthreads();

    // online softmax: warp `warp` owns rows warp*8 .. warp*8+7 of sP and
    // of the accumulator, so only __syncwarp separates it from p . v
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      float* prow = sP + (warp * kRowsPerWarp + rr) * PS;
      const float x0 = prow[lane], x1 = prow[lane + 32];
      const float m_new = fmaxf(m_r[rr], warp_max(fmaxf(x0, x1)));
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      const float corr = expf(m_r[rr] - m_new);
      l_r[rr] = l_r[rr] * corr + warp_sum(p0 + p1);
      m_r[rr] = m_new;
      prow[lane] = round_to<T>(p0);
      prow[lane + 32] = round_to<T>(p1);
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[rr][c] *= corr;
    }
    __syncwarp();

#pragma unroll 2
    for (int c0 = 0; c0 < kBK; c0 += 4) {
      float4 p4[kRowsPerWarp];
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr)
        p4[rr] = *reinterpret_cast<const float4*>(
            &sP[(warp * kRowsPerWarp + rr) * PS + c0]);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float v0 = sV[(c0 + 0) * D + lane + 32 * c];
        const float v1 = sV[(c0 + 1) * D + lane + 32 * c];
        const float v2 = sV[(c0 + 2) * D + lane + 32 * c];
        const float v3 = sV[(c0 + 3) * D + lane + 32 * c];
#pragma unroll
        for (int rr = 0; rr < kRowsPerWarp; ++rr) {
          acc[rr][c] += p4[rr].x * v0;
          acc[rr][c] += p4[rr].y * v1;
          acc[rr][c] += p4[rr].z * v2;
          acc[rr][c] += p4[rr].w * v3;
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int qi = q0 + warp * kRowsPerWarp + rr;
    if (qi >= sq) continue;
    const float den = fmaxf(l_r[rr], 1e-30f);
    T* orow = out + ((size_t(b) * sq + qi) * H + h) * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) orow[lane + 32 * c] = from_f<T>(acc[rr][c] / den);
  }
}

template <typename T, int D>
cudaError_t launch_prefill(void* out, const void* q, const void* k,
                           const void* v, Strides qs, Strides ks, Strides vs,
                           int B, int H, int g, int sq, int skv, int causal,
                           int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = prefill_smem_bytes<D>();
  // dynamic shared memory above 48 KB needs the opt-in (on every launch:
  // the attribute belongs to the current device)
  const cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBQ - 1) / kBQ, B * H, 1);
  flash_prefill_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<T*>(out), static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), qs, ks, vs, H, g,
      sq, skv, causal, window, scale);
  return cudaGetLastError();
}

// ---- decode form: split-KV ----------------------------------------------

namespace dec {

constexpr int kThreads = 128;    // 4 warps per split block
constexpr int kWarps = kThreads / 32;
constexpr int kTileBytes = 16384;  // K (and V) bytes per shared tile
constexpr int kMergeCols = 64;   // output columns per merge block
// most splits of one span (ops.py MAX_SPLITS: one block per SM)
constexpr int kMaxSplits = 132;

// How a row of D elements of T is read 16 bytes at a time: VE elements
// per vector, NV vectors per row; L lanes share a row (RPW rows per warp
// step), each holding VPL vectors (E elements).  KT keys per tile.
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
};

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
// 16 bytes of T from VE floats, each rounded to nearest
__device__ __forceinline__ uint4 from_floats(const float* f, float) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 from_floats(const float* f, __nv_bfloat16) {
  return make_uint4(mma::pack_bf16(f[0], f[1]), mma::pack_bf16(f[2], f[3]),
                    mma::pack_bf16(f[4], f[5]), mma::pack_bf16(f[6], f[7]));
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

// Block (c, b*Hkv + hk, z): keys [c*kc, min((c+1)*kc, skv)) of kv head hk
// for query heads hk*g + z*GT + i (i < GT, those below g).  K and V go
// through shared memory in tiles of KT keys (cp.async, one group each;
// the next tile's K is fetched while this tile's p . v runs).  Per tile:
// the GT scores of each key (L lanes share a row and split D; warp w
// takes the row groups w, w + 4, ..., STEPS of them, and sums each row's
// lanes by shuffles), then per head the tile's max, p =
// exp(s - m), l and the correction of the running acc (warp i % 4 for
// head i), then acc = acc * corr + round_to<T>(p) . v with each thread
// owning one (head, 16-byte column vector) item.  With one split the
// block writes out = acc / max(l, 1e-30) itself; otherwise (m, l, acc) of
// its split go to the f32 workspace for the merge kernel (acc rows of D,
// then (m, l) pairs, both 8-byte aligned since D is a multiple of 64).
template <typename T, int D, int GT>
__global__ void __launch_bounds__(kThreads)
flash_decode_split_kernel(T* __restrict__ out, float* __restrict__ ws_acc,
                          float2* __restrict__ ws_ml, const T* __restrict__ q,
                          const T* __restrict__ k, const T* __restrict__ v,
                          Strides qs, Strides ks, Strides vs, int H, int Hkv,
                          int g, int skv, int kc, int nsplit, float scale) {
  using S = Shape<T, D>;
  constexpr int KT = S::KT, VE = S::VE, NV = S::NV, L = S::L;
  constexpr int RPW = S::RPW, VPL = S::VPL, E = S::E;
  constexpr int ITEMS = GT * NV;
  constexpr int IPT = (ITEMS + kThreads - 1) / kThreads;
  constexpr int KW = (KT + 31) / 32;     // a tile's keys per lane
  constexpr int STEPS = KT / (kWarps * RPW);   // row steps per warp
  static_assert(KT % (kWarps * RPW) == 0, "tile rows per warp step");
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

    // scores: warp step st takes RPW rows, L lanes each; every step is
    // computed (rows past n read stale shared memory and are not written)
    // so the steps' loads, products and shuffles interleave
    float dot[STEPS][GT];
#pragma unroll
    for (int st = 0; st < STEPS; ++st) {
      const int r = (st * kWarps + warp) * RPW + lane / L;
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
      for (int st = 0; st < STEPS; ++st)
#pragma unroll
        for (int i = 0; i < GT; ++i)
          dot[st][i] += __shfl_xor_sync(0xffffffffu, dot[st][i], o);
    if (lane % L == 0) {
#pragma unroll
      for (int st = 0; st < STEPS; ++st) {
        const int r = (st * kWarps + warp) * RPW + lane / L;
        if (r < n) {
#pragma unroll
          for (int i = 0; i < GT; ++i) sS[i][r] = dot[st][i] * scale;
        }
      }
    }
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

#pragma unroll
  for (int it = 0; it < IPT; ++it) {
    const int item = tid + it * kThreads;
    const int i = item / NV, cv = item % NV;
    if (item >= ITEMS || hg + i >= g) continue;
    const size_t row = size_t(b) * H + hk * g + hg + i;   // b*H + h
    if (nsplit == 1) {
      const float den = fmaxf(sL[i], 1e-30f);
      float o[VE];
#pragma unroll
      for (int e = 0; e < VE; ++e) o[e] = acc[it][e] / den;
      *reinterpret_cast<uint4*>(out + row * D + cv * VE) =
          from_floats(o, T());
    } else {
      float4* wa = reinterpret_cast<float4*>(
          ws_acc + (row * nsplit + c) * D + cv * VE);
#pragma unroll
      for (int e = 0; e < VE; e += 4)
        wa[e / 4] = make_float4(acc[it][e], acc[it][e + 1], acc[it][e + 2],
                                acc[it][e + 3]);
    }
  }
  if (nsplit > 1 && tid < GT && hg + tid < g) {
    const size_t row = size_t(b) * H + hk * g + hg + tid;
    ws_ml[row * nsplit + c] = make_float2(sM[tid], sL[tid]);
  }
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

template <typename T, int D, int GT>
cudaError_t launch_decode(void* out, float* ws, const void* q, const void* k,
                          const void* v, Strides qs, Strides ks, Strides vs,
                          int B, int H, int Hkv, int skv, int kc, int nsplit,
                          float scale, cudaStream_t stream) {
  const int g = H / Hkv;
  float2* ws_ml =
      reinterpret_cast<float2*>(ws + size_t(B) * H * nsplit * D);
  const dim3 grid(nsplit, B * Hkv, (g + GT - 1) / GT);
  flash_decode_split_kernel<T, D, GT><<<grid, kThreads, 0, stream>>>(
      static_cast<T*>(out), ws, ws_ml, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), qs, ks, vs, H, Hkv,
      g, skv, kc, nsplit, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  flash_decode_merge_kernel<T><<<dim3(B * H, D / kMergeCols), kMergeCols, 0,
                                 stream>>>(static_cast<T*>(out), ws, ws_ml, D,
                                           nsplit);
  return cudaGetLastError();
}

// the head-group width GT: g itself up to 8 (a power of two at or above
// it), groups of 8 heads beyond
template <typename T, int D>
cudaError_t launch_decode_any_g(void* out, float* ws, const void* q,
                                const void* k, const void* v, Strides qs,
                                Strides ks, Strides vs, int B, int H, int Hkv,
                                int skv, int kc, int nsplit, float scale,
                                cudaStream_t stream) {
  const int g = H / Hkv;
#define K4_DECODE_G(GT)                                                    \
  launch_decode<T, D, GT>(out, ws, q, k, v, qs, ks, vs, B, H, Hkv, skv, kc, \
                          nsplit, scale, stream)
  if (g <= 1) return K4_DECODE_G(1);
  if (g <= 2) return K4_DECODE_G(2);
  if (g <= 4) return K4_DECODE_G(4);
  return K4_DECODE_G(8);
#undef K4_DECODE_G
}

}  // namespace dec

}  // namespace

// dtype: 0 float32, 1 bfloat16.  D: 64, 128 or 256.  window 0 = none.
// Strides are in elements, (b, s, h) for each of q, k, v.
#define K4_DISPATCH_D(CALL, T)                                             \
  do {                                                                     \
    if (D == 64) return int(CALL(T, 64));                                  \
    if (D == 128) return int(CALL(T, 128));                                \
    if (D == 256) return int(CALL(T, 256));                                \
    return int(cudaErrorInvalidValue);                                     \
  } while (0)

// bf16 prefill takes the tensor-core form and f32 the SIMT form; the SIMT
// form has no bf16 instantiation
extern "C" int flash_attn_launch(void* out, const void* q, const void* k,
                                 const void* v, int dtype, int B, int H,
                                 int Hkv, int D, int sq, int skv,
                                 long long qsb, long long qss, long long qsh,
                                 long long ksb, long long kss, long long ksh,
                                 long long vsb, long long vss, long long vsh,
                                 int causal, int window, float scale,
                                 void* stream) {
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define K4_PREFILL_SIMT(T, DD)                                             \
  launch_prefill<T, DD>(out, q, k, v, qs, ks, vs, B, H, H / Hkv, sq, skv,  \
                        causal, window, scale, st)
#define K4_PREFILL_MMA(T, DD)                                              \
  launch_mma<DD>(out, q, k, v, qs, ks, vs, B, H, H / Hkv, sq, skv, causal, \
                 window, scale, st)
  if (dtype == 0) K4_DISPATCH_D(K4_PREFILL_SIMT, float);
  if (dtype == 1) K4_DISPATCH_D(K4_PREFILL_MMA, __nv_bfloat16);
  return int(cudaErrorInvalidValue);
#undef K4_PREFILL_SIMT
#undef K4_PREFILL_MMA
}

// The decode form: the split kernel, then (with more than one split) the
// merge kernel, on one stream.  ws: f32 workspace of B*H*nsplit*(D + 2)
// floats (acc, then (m, l) pairs); chunk c holds keys [c*kc,
// min((c+1)*kc, skv)), and the chunks must cover skv with none empty.
extern "C" int flash_decode_launch(void* out, void* ws, const void* q,
                                   const void* k, const void* v, int dtype,
                                   int B, int H, int Hkv, int D, int skv,
                                   int kc, int nsplit, long long qsb,
                                   long long qsh, long long ksb,
                                   long long kss, long long ksh,
                                   long long vsb, long long vss,
                                   long long vsh, float scale, void* stream) {
  if (nsplit < 1 || nsplit > dec::kMaxSplits || kc < 1 ||
      (long long)(nsplit - 1) * kc >= skv || (long long)nsplit * kc < skv)
    return int(cudaErrorInvalidValue);
  const Strides qs{qsb, 0, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
#define K4_DECODE(T, DD)                                                   \
  dec::launch_decode_any_g<T, DD>(out, w, q, k, v, qs, ks, vs, B, H, Hkv,  \
                                  skv, kc, nsplit, scale, st)
  if (dtype == 0) K4_DISPATCH_D(K4_DECODE, float);
  if (dtype == 1) K4_DISPATCH_D(K4_DECODE, __nv_bfloat16);
  return int(cudaErrorInvalidValue);
#undef K4_DECODE
}

// The tensor-core form's raw scores q . k^T (f32, unscaled, unmasked) into
// out (B*H, sq, skv): a card test of its QK^T fragments alone.  q, k bf16.
extern "C" int flash_mma_scores_launch(float* out, const void* q,
                                       const void* k, int B, int H, int Hkv,
                                       int D, int sq, int skv, long long qsb,
                                       long long qss, long long qsh,
                                       long long ksb, long long kss,
                                       long long ksh, void* stream) {
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define K4_SCORES(T, DD)                                                   \
  launch_mma_scores<DD>(out, q, k, qs, ks, B, H, H / Hkv, sq, skv, st)
  K4_DISPATCH_D(K4_SCORES, __nv_bfloat16);
#undef K4_SCORES
}

// The tensor-core form's dynamic shared memory per block at head dim D
// (Q and the K/V ring, padded rows), or 0 for a D it is not built for.
extern "C" int flash_mma_smem_bytes(int D) {
  if (D == 64) return int(mma::smem_bytes<64>());
  if (D == 128) return int(mma::smem_bytes<128>());
  if (D == 256) return int(mma::smem_bytes<256>());
  return 0;
}
