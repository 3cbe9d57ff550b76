// K4: flash attention with an online softmax, in three forms: a prefill
// form on the tensor cores for bf16 (flash_attn_mma.cuh), a SIMT prefill
// form for float (below) and a decode form for both.
//
// Replaces the TPU kernel src/repro/kernels/flash/kernel.py::_flash_kernel
// (driver flash_bhsd, wrappers flash_attention_tpu / flash_decode_tpu).
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
// Decode form (Sq = 1): one block of 8 warps per (b, h).  Each lane holds
// D/32 elements of q and of the accumulator; warp w takes keys w, w+8, ...,
// four at a time (loads issued before the reductions), with its own online
// softmax; the eight partial (m, l, acc) are merged in shared memory.
//
// Bound on an H100: at the main path's prefill (B 4, S 1024, H 4, Hkv 1,
// D 256) the work is about 8.6e9 flops for the causal layers, 8.7 us at the
// bf16 tensor-core rate, and 21 MB of q, k, v and out (6.3 us): bound by
// operations.  The f32 SIMT form runs its products on the f32 FMA lanes
// and can at best reach the 67 TFLOP/s f32 rate; the bf16 form uses the
// tensor cores through mma.sync.  A decode step reads the cache span once
// and is bound by bytes.
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
constexpr int kUnroll = 4;       // keys in flight per warp in the decode form
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
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(T* __restrict__ out, const T* __restrict__ q,
                    const T* __restrict__ k, const T* __restrict__ v,
                    Strides qs, Strides ks, Strides vs, int H, int g, int skv,
                    float scale) {
  constexpr int CPT = D / 32;
  __shared__ float sM[kWarps], sL[kWarps];
  __shared__ float sAcc[kWarps][D];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / g;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  float qv[CPT], acc[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    qv[c] = to_f(qb[lane + 32 * c]);
    acc[c] = 0.f;
  }
  float m = kMaskAdd, l = 0.f;
  for (int j0 = warp; j0 < skv; j0 += kWarps * kUnroll) {
    float kx[kUnroll][CPT], vx[kUnroll][CPT], dot[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * kWarps;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        kx[u][c] = j < skv ? to_f(kb[j * ks.s + lane + 32 * c]) : 0.f;
        vx[u][c] = j < skv ? to_f(vb[j * vs.s + lane + 32 * c]) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) part += qv[c] * kx[u][c];
      dot[u] = warp_sum(part);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j0 + u * kWarps >= skv) break;
      const float s = dot[u] * scale;
      const float m_new = fmaxf(m, s);
      const float p = expf(s - m_new), corr = expf(m - m_new);
      l = l * corr + p;
      m = m_new;
      const float pr = round_to<T>(p);
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[c] = acc[c] * corr + pr * vx[u][c];
    }
  }
  if (lane == 0) {
    sM[warp] = m;
    sL[warp] = l;
  }
#pragma unroll
  for (int c = 0; c < CPT; ++c) sAcc[warp][lane + 32 * c] = acc[c];
  __syncthreads();

  float m_all = kMaskAdd;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, sM[w]);
  float l_all = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) l_all += sL[w] * expf(sM[w] - m_all);
  const float den = fmaxf(l_all, 1e-30f);
  T* orow = out + (size_t(b) * H + h) * D;
  for (int d = tid; d < D; d += kThreads) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += sAcc[w][d] * expf(sM[w] - m_all);
    orow[d] = from_f<T>(o / den);
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

template <typename T, int D>
cudaError_t launch_decode(void* out, const void* q, const void* k,
                          const void* v, Strides qs, Strides ks, Strides vs,
                          int B, int H, int g, int skv, float scale,
                          cudaStream_t stream) {
  flash_decode_kernel<T, D><<<B * H, kThreads, 0, stream>>>(
      static_cast<T*>(out), static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), qs, ks, vs, H, g,
      skv, scale);
  return cudaGetLastError();
}

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

extern "C" int flash_decode_launch(void* out, const void* q, const void* k,
                                   const void* v, int dtype, int B, int H,
                                   int Hkv, int D, int skv, long long qsb,
                                   long long qsh, long long ksb,
                                   long long kss, long long ksh,
                                   long long vsb, long long vss,
                                   long long vsh, float scale, void* stream) {
  const Strides qs{qsb, 0, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define K4_DECODE(T, DD)                                                   \
  launch_decode<T, DD>(out, q, k, v, qs, ks, vs, B, H, H / Hkv, skv,       \
                       scale, st)
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
