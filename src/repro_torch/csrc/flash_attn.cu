// K4: flash attention with an online softmax, in three forms: a bf16
// prefill form on the tensor cores (warpgroup products fed by the tensor
// memory accelerator, at (Dk, Dv) = (64, 64), (128, 128), (192, 128) and
// (256, 256), flash_attn_wgmma.cuh), a SIMT prefill form for float
// (below) and a decode form for both (flash_decode.cu).
//
// Replaces the TPU kernel src/repro/kernels/flash/kernel.py::_flash_kernel
// (driver flash_bhsd, wrappers flash_attention_tpu / flash_decode_tpu).
// The TPU kernel carries the online softmax across KV tiles in scratch
// memory along a sequential grid axis; here a block loops over its tiles,
// and the decode form splits the keys over blocks and merges the partial
// softmaxes in a thread-block cluster (up to 8 splits) or in a second
// kernel.
//
//   s = (q . k^T) * (1/sqrt(D))                      in f32
//   s += -1e30 where the causal or window mask drops (k, q)
//   m, l, acc: online softmax over KV tiles           in f32
//   acc += round_to_v_dtype(p) . v                    (kernel.py:58)
//   out = acc / max(l, 1e-30)                         in q's dtype
//   lse = m + log(max(l, 1e-30))     f32 (B, H, Sq), when asked for
//
// Both prefill forms write lse only when given a pointer to it (the
// training path: the attention backward, models/layers.py, reads it);
// serving passes null and nothing is written.
//
// q (B, Sq, H, Dk), k (B, Skv, Hkv, Dk) and v (B, Skv, Hkv, Dv) are read
// through their element strides, with only the head dim contiguous, so
// neither a prefill's projections nor a decode step's slice of the cache is
// copied.  Dv differs from Dk only in prefill, at (192, 128): MLA's
// unpadded heads.  Query head h reads kv head h / g (GQA); no KV is
// repeated in memory.  out is (B, Sq, H, Dv), contiguous.  Keys at or
// past skv get no weight at all; a row whose band holds no key sees every
// key at -1e30 and so averages them uniformly, as the plain version
// (attention_ref) does.
//
// bf16 prefill: flash_attn_wgmma.cuh (wgmma.mma_async on TMA tiles, a
// producer warp and two consumer warpgroups, one persistent block an SM)
// at every pair, MLA's (192, 128) included; its note gives the design.
// The type alone picks the form (prefill_form below, mirrored by
// kernels/flash/ops.py's prefill_form).  (Until this form took MLA's
// pair too, flash_attn_mma.cuh held mma.sync forms with Q in registers;
// PERF.md keeps their last times.)
//
// f32 prefill (the SIMT form, simt::flash_prefill_kernel): one block of 8
// warps per (b*H + h, 64-row q tile), the q tiles in reverse order,
// looping over 32-key tiles from the first to the last that meets the
// tile's causal and window band (tiles wholly outside it are skipped).  K
// and V tiles come in through a two-stage ring of 16-byte cp.async.cg
// copies (4-byte ones when a row start is not 16-byte aligned), zero-filled
// past skv; the next tile's copies run under this tile's math, with one
// barrier per tile.  K and V stay row-major in shared memory as f32.  Each
// warp owns 8 query rows for the whole softmax, and each lane owns D/32
// columns of Q, K and O.  Q lives in registers (8 rows x D/32 a lane), so
// a K float4 read feeds 8 rows: per 4 keys a lane forms 32 partial dot
// products over its columns and a reduce-scatter of 31 shuffles leaves it
// one full score.  p goes through the warp's own 8 x 32 tile (a
// __syncwarp, no block barrier) to O += P V, where a lane holds 8 rows x
// D/32 columns of O and reads 4 keys of p per broadcast float4.  At D 256
// a thread holds 255 registers and the block 148,736 bytes of shared
// memory: one block per SM.  What bounds it: per 32-key tile an SM issues
// 8,192 cycles of FMAs and about 8,100 of shared-memory and shuffle
// traffic (4 bytes a lane a cycle), and with 2 warps a scheduler the two
// barely overlap.  f32 stays off the tensor cores on purpose: their f32
// input is TF32, whose 10-bit mantissa would break the f32 tolerance of
// 2e-5 that the reference's tests hold this form to.
//
// Decode form (Sq = 1): flash_decode.cu.
//
// Bound on an H100: at the main path's prefill (B 4, S 1024, H 4, Hkv 1,
// D 256) the work is about 8.6e9 flops for the causal layers, 8.7 us at the
// bf16 tensor-core rate, and 21 MB of q, k, v and out (6.3 us): bound by
// operations.  The f32 SIMT form runs its products on the f32 FMA lanes
// and can at best reach the 67 TFLOP/s f32 rate; the bf16 form uses the
// tensor cores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attn_wgmma.cuh"   // Strides, launch_wgmma

namespace {

// ---- f32 prefill form: SIMT ---------------------------------------------

namespace simt {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRW = 8;                 // query rows per warp
constexpr int kBQ = kWarps * kRW;      // query rows per block
constexpr int kBK = 32;                // keys per tile
constexpr int kPS = kBK + 4;           // row stride of a warp's p tile

// K and V rows padded by 16 floats: a row starts 64 bytes on from the one
// before it modulo 128, which spreads the four rows that a warp's K read
// meets (see the kernel) over all 8 bank groups
template <int D> __host__ __device__ constexpr int row_stride() {
  return D + 16;
}
// a two-stage ring of K (DK) and V (DV) tiles, each warp's p tile and its
// rows' corrections
template <int DK, int DV> __host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t(2 * kBK) * (row_stride<DK>() + row_stride<DV>()) +
          size_t(kWarps) * kRW * (kPS + 1));
}

// floats per vector of a lane's D / 32 columns: 4, or the largest power of
// two that divides them (2 at D 64 and 192)
template <int D> __host__ __device__ constexpr int vec_width() {
  return (D / 32) % 4 == 0 ? 4 : (D / 32) % 2 == 0 ? 2 : 1;
}

// 4 bytes global -> shared; src-size 0 writes zeros
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0));
}

// rows [r0, r0 + kBK) of one head into a shared [kBK][row_stride] tile,
// rows at or past lim zero-filled: a 16-byte cp.async per 4 floats when
// every row start is 16-byte aligned (vec), else a 4-byte one per float
template <int D>
__device__ __forceinline__ void load_tile(float* s, const float* g,
                                          long long stride, int r0, int lim,
                                          bool vec, int tid) {
  constexpr int RS = row_stride<D>();
  if (vec) {
    constexpr int NV = D / 4;
#pragma unroll 4
    for (int i = tid; i < kBK * NV; i += kThreads) {
      const int r = i / NV, c = (i % NV) * 4;
      const bool in = r0 + r < lim;
      mma::cp_async16(mma::smem_u32(s + r * RS + c),
                      in ? g + (r0 + r) * stride + c : g, in);
    }
  } else {
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool in = r0 + r < lim;
      cp_async4(mma::smem_u32(s + r * RS + c),
                in ? g + (r0 + r) * stride + c : g, in);
    }
  }
}

// VW floats at p into f (VW 4, 2 or 1; p aligned to VW floats)
template <int VW>
__device__ __forceinline__ void load_vec(float* f, const float* p) {
  if (VW == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    f[0] = t.x;
    f[1] = t.y;
    f[2] = t.z;
    f[3] = t.w;
  } else if (VW == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    f[0] = t.x;
    f[1] = t.y;
  } else {
    f[0] = *p;
  }
}

__device__ __forceinline__ float part(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// Block (b*H + h, q tile): kBQ query rows, the q tiles in reverse order
// (the longest causal tiles start first when the grid takes more than one
// wave).  Warp w owns rows 8w .. 8w+7 for the whole softmax, and lane L
// owns columns c(L) = {L*VW + 32*VW*n + e} of Q and K (D = DK) and of V
// and O (D = DV), VW = vec_width<D>().
//   S = Q K^T  Q lives in registers: lane L holds its columns of the
//              warp's 8 rows.  Per 4 keys a lane forms 32 partial dot
//              products over its columns (8 rows x 4 keys, one K float4 read
//              per key and vector: 8 FMAs per word read), and a
//              reduce-scatter over the warp (5 shuffle steps, 31 shuffles)
//              leaves lane L the full score of row L/4, key L%4.  So that
//              every step sends and keeps the same slots on every lane
//              (no selects), lane L's slot s holds the partial of index
//              s ^ L: its Q registers hold rows in the order r ^ (L/4) and
//              it reads keys in the order k ^ (L%4).
//   softmax    row max and sum over the 4 lanes of a row by 2 shuffles;
//              p and each row's correction go to the warp's own p tile
//              (no block barrier: __syncwarp);
//   O += P V   lane L holds all 8 rows x its D/32 columns of O and reads p
//              as broadcast float4 (4 keys of a row) and V rows as float4.
template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
flash_prefill_kernel(T* __restrict__ out, const T* __restrict__ q,
                     const T* __restrict__ k, const T* __restrict__ v,
                     Strides qs, Strides ks, Strides vs, int H, int g, int sq,
                     int skv, int causal, int window, int q_off, float scale,
                     int vec, float* __restrict__ lse) {
  static_assert(sizeof(T) == sizeof(float), "the SIMT form is f32 only");
  constexpr int RS = row_stride<DK>(), RSV = row_stride<DV>();
  constexpr int CPL = DK / 32;             // Q and K columns per lane
  constexpr int VW = vec_width<DK>();      // floats per vector
  constexpr int NVEC = CPL / VW;
  constexpr int CPLV = DV / 32;            // V and O columns per lane
  constexpr int VWV = vec_width<DV>();
  constexpr int NVECV = CPLV / VWV;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);   // [2][kBK][RS]
  float* sV = sK + 2 * kBK * RS;                 // [2][kBK][RSV]
  float* sP = sV + 2 * kBK * RSV;                // [kWarps][kRW][kPS]
  float* sC = sP + kWarps * kRW * kPS;           // [kWarps][kRW]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rl = lane >> 2, kl = lane & 3;   // slot order; then row and key
  const int bh = blockIdx.x, b = bh / H, h = bh % H, hk = h / g;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int q1 = min(q0 + kBQ, sq);
  const float* qb = reinterpret_cast<const float*>(q) + b * qs.b + h * qs.h;
  const float* kb = reinterpret_cast<const float*>(k) + b * ks.b + hk * ks.h;
  const float* vb = reinterpret_cast<const float*>(v) + b * vs.b + hk * vs.h;

  // the keys this tile's band meets (row i sits at position i + q_off); a
  // row with no key in its band (only possible with a window and
  // sq + q_off > skv) needs every key, at -1e30
  const int p0 = q0 + q_off, p1 = q1 + q_off;
  int kv_lo = 0, kv_hi = causal ? min(skv, p1) : skv;
  if (window > 0) {
    if (p1 - window >= skv) kv_hi = skv;
    else kv_lo = max(0, p0 - window + 1);
  }
  const int ntiles = (kv_hi - kv_lo + kBK - 1) / kBK;

  if (ntiles > 0) {
    load_tile<DK>(sK, kb, ks.s, kv_lo, skv, vec, tid);
    load_tile<DV>(sV, vb, vs.s, kv_lo, skv, vec, tid);
  }
  mma::cp_async_commit();

  // this lane's columns of the warp's rows, row r ^ rl in slot r
  float qv[kRW][CPL];
#pragma unroll
  for (int r = 0; r < kRW; ++r) {
    const int qi = q0 + warp * kRW + (r ^ rl);
    const float* qrow = qb + (long long)qi * qs.s + lane * VW;
#pragma unroll
    for (int n = 0; n < NVEC; ++n) {
#pragma unroll
      for (int e = 0; e < VW; ++e) qv[r][n * VW + e] = 0.f;
      if (qi < sq) {
        if (vec) {
          load_vec<VW>(&qv[r][n * VW], qrow + 32 * VW * n);
        } else {
#pragma unroll
          for (int e = 0; e < VW; ++e) qv[r][n * VW + e] = qrow[32 * VW * n + e];
        }
      }
    }
  }

  float m = kMaskAdd, l = 0.f;             // of row rl
  float acc[kRW][CPLV];
#pragma unroll
  for (int r = 0; r < kRW; ++r)
#pragma unroll
    for (int c = 0; c < CPLV; ++c) acc[r][c] = 0.f;
  float* pw = sP + warp * kRW * kPS;
  float* cw = sC + warp * kRW;

  for (int it = 0; it < ntiles; ++it) {
    const int t0 = kv_lo + it * kBK;
    const float* sKt = sK + (it & 1) * kBK * RS;
    const float* sVt = sV + (it & 1) * kBK * RSV;
    mma::cp_async_wait<0>();
    __syncthreads();   // tile it is in; every warp is done with tile it - 1
    if (it + 1 < ntiles) {
      const int nxt = ((it + 1) & 1) * kBK;
      load_tile<DK>(sK + nxt * RS, kb, ks.s, t0 + kBK, skv, vec, tid);
      load_tile<DV>(sV + nxt * RSV, vb, vs.s, t0 + kBK, skv, vec, tid);
    }
    mma::cp_async_commit();   // (possibly empty) next tile

    // x[c]: the score of row rl, key 4c + kl
    float x[kBK / 4];
#pragma unroll
    for (int c = 0; c < kBK / 4; ++c) {
      float pt[kRW * 4];   // slot r*4 + j: row r ^ rl, key 4c + (j ^ kl)
#pragma unroll
      for (int s = 0; s < kRW * 4; ++s) pt[s] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* krow = sKt + (4 * c + (j ^ kl)) * RS + lane * VW;
#pragma unroll
        for (int n = 0; n < NVEC; ++n) {
          float kk[VW];
          load_vec<VW>(kk, krow + 32 * VW * n);
#pragma unroll
          for (int r = 0; r < kRW; ++r)
#pragma unroll
            for (int e = 0; e < VW; ++e)
              pt[r * 4 + j] += qv[r][n * VW + e] * kk[e];
        }
      }
#pragma unroll
      for (int lv = 4; lv >= 0; --lv) {      // half = 16, 8, 4, 2, 1
#pragma unroll
        for (int s = 0; s < 16; ++s)
          if (s < (1 << lv))
            pt[s] += __shfl_xor_sync(0xffffffffu, pt[s + (1 << lv)], 1 << lv);
      }
      x[c] = pt[0];
    }

    // online softmax over the tile: row rl on lanes 4rl .. 4rl+3
    const int qi = q0 + warp * kRW + rl + q_off;   // the row's position
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < kBK / 4; ++c) {
      const int kj = t0 + 4 * c + kl;
      float val = -INFINITY;                   // past the keys: no weight
      if (kj < skv) {
        bool keep = !causal || kj <= qi;
        if (window > 0) keep = keep && kj > qi - window;
        val = x[c] * scale + (keep ? 0.f : kMaskAdd);
      }
      x[c] = val;
      mx = fmaxf(mx, val);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < kBK / 4; ++c) {
      const float p = expf(x[c] - m_new);
      sum += p;
      pw[rl * kPS + 4 * c + kl] = round_to<T>(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l = l * corr + sum;
    m = m_new;
    if (kl == 0) cw[rl] = corr;
    __syncwarp();

    const float4 c03 = *reinterpret_cast<const float4*>(cw);
    const float4 c47 = *reinterpret_cast<const float4*>(cw + 4);
#pragma unroll
    for (int r = 0; r < kRW; ++r) {
      const float cr = part(r < 4 ? c03 : c47, r & 3);
#pragma unroll
      for (int c = 0; c < CPLV; ++c) acc[r][c] *= cr;
    }
#pragma unroll 2
    for (int c0 = 0; c0 < kBK; c0 += 4) {
      float4 p4[kRW];
#pragma unroll
      for (int r = 0; r < kRW; ++r)
        p4[r] = *reinterpret_cast<const float4*>(pw + r * kPS + c0);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = sVt + (c0 + u) * RSV + lane * VWV;
        float vv[CPLV];
#pragma unroll
        for (int n = 0; n < NVECV; ++n)
          load_vec<VWV>(&vv[n * VWV], vrow + 32 * VWV * n);
#pragma unroll
        for (int r = 0; r < kRW; ++r) {
          const float pr = part(p4[r], u);
#pragma unroll
          for (int c = 0; c < CPLV; ++c) acc[r][c] += pr * vv[c];
        }
      }
    }
  }

  // m and l of row r sit on lanes 4r .. 4r+3
#pragma unroll
  for (int r = 0; r < kRW; ++r) {
    const float lr = __shfl_sync(0xffffffffu, l, 4 * r);
    const float mr = __shfl_sync(0xffffffffu, m, 4 * r);
    const int qi = q0 + warp * kRW + r;
    if (qi >= sq) continue;
    const float den = fmaxf(lr, 1e-30f);
    // the row's log-sum-exp of the scaled scores (m is in natural units)
    if (lse != nullptr && lane == 0) lse[size_t(bh) * sq + qi] = mr + logf(den);
    float* orow = reinterpret_cast<float*>(out) +
                  ((size_t(b) * sq + qi) * H + h) * DV + lane * VWV;
#pragma unroll
    for (int n = 0; n < NVECV; ++n) {
      const float* a = &acc[r][n * VWV];
      float* o = orow + 32 * VWV * n;
      if (VWV == 4) {
        *reinterpret_cast<float4*>(o) =
            make_float4(a[0] / den, a[1] / den, a[2] / den, a[3] / den);
      } else if (VWV == 2) {
        *reinterpret_cast<float2*>(o) = make_float2(a[0] / den, a[1] / den);
      } else {
        *o = a[0] / den;
      }
    }
  }
}

// every row start of one operand 16-byte aligned: its pointer, and its
// (b, s, h) strides multiples of 4 floats
__host__ inline bool rows_aligned16(const void* p, const Strides& s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 4 == 0 &&
         s.s % 4 == 0 && s.h % 4 == 0;
}

template <typename T, int DK, int DV>
cudaError_t launch_prefill(void* out, const void* q, const void* k,
                           const void* v, Strides qs, Strides ks, Strides vs,
                           int B, int H, int g, int sq, int skv, int causal,
                           int window, int q_off, float scale, float* lse,
                           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DK, DV>();
  // dynamic shared memory above 48 KB needs the opt-in (on every launch:
  // the attribute belongs to the current device)
  const cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_kernel<T, DK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int vec = rows_aligned16(q, qs) && rows_aligned16(k, ks) &&
                  rows_aligned16(v, vs);
  const dim3 grid(B * H, (sq + kBQ - 1) / kBQ, 1);
  flash_prefill_kernel<T, DK, DV><<<grid, kThreads, smem, stream>>>(
      static_cast<T*>(out), static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), qs, ks, vs, H, g,
      sq, skv, causal, window, q_off, scale, vec, lse);
  return cudaGetLastError();
}

}  // namespace simt

}  // namespace

// The prefill form of a call: 0 the SIMT form (f32), 2 the wgmma form
// (bf16); -1 for a pair or type K4 is not built for.  (1 was the
// Q-register form's, since retired.)
constexpr int kFormSimt = 0, kFormWgmma = 2;
constexpr int prefill_form(int dtype, int Dk, int Dv) {
  const bool built = (Dk == 64 && Dv == 64) || (Dk == 128 && Dv == 128) ||
                     (Dk == 192 && Dv == 128) || (Dk == 256 && Dv == 256);
  if (!built || (dtype != 0 && dtype != 1)) return -1;
  return dtype == 0 ? kFormSimt : kFormWgmma;
}

// dtype: 0 float32, 1 bfloat16.  window 0 = none.  q_off: query row i
// sits at key position i + q_off for the causal and window masks (0: row i
// aligns with key i).  Strides are in elements, (b, s, h) for each of q,
// k, v.  Dk, Dv: q and k's head dim and v's, one of the pairs (64, 64),
// (128, 128), (192, 128), (256, 256); prefill_form picks the form.  Any
// scale.  lse: null, or f32 (B, H, sq)
// for each row's log-sum-exp of the scaled, masked scores, m + log(max(l,
// 1e-30)) (what the attention backward reads).
extern "C" int flash_attn_launch(void* out, const void* q, const void* k,
                                 const void* v, int dtype, int B, int H,
                                 int Hkv, int Dk, int Dv, int sq, int skv,
                                 long long qsb, long long qss, long long qsh,
                                 long long ksb, long long kss, long long ksh,
                                 long long vsb, long long vss, long long vsh,
                                 int causal, int window, int q_off,
                                 float scale, float* lse, void* stream) {
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define K4_ARGS out, q, k, v, qs, ks, vs, B, H
#define K4_BAND sq, skv, causal, window, q_off, scale, lse
  switch (prefill_form(dtype, Dk, Dv)) {
    case kFormSimt: {
      const int g = H / Hkv;
#define K4_SIMT(DK, DV) \
  int(simt::launch_prefill<float, DK, DV>(K4_ARGS, g, K4_BAND, st))
      if (Dk == 64) return K4_SIMT(64, 64);
      if (Dk == 128) return K4_SIMT(128, 128);
      if (Dk == 192) return K4_SIMT(192, 128);
      return K4_SIMT(256, 256);
#undef K4_SIMT
    }
    case kFormWgmma:
#define K4_WGMMA(DK, DV) \
  int(launch_wgmma<DK, DV>(K4_ARGS, Hkv, K4_BAND, st))
      if (Dk == 64) return K4_WGMMA(64, 64);
      if (Dk == 128) return K4_WGMMA(128, 128);
      if (Dk == 192) return K4_WGMMA(192, 128);
      return K4_WGMMA(256, 256);
#undef K4_WGMMA
  }
  return int(cudaErrorInvalidValue);
#undef K4_ARGS
#undef K4_BAND
}

// flash_attn_launch's form for (dtype, Dk, Dv), as prefill_form gives it
// (the Python mirror, kernels/flash/ops.py's prefill_form, is tested
// against it).
extern "C" int flash_prefill_form(int dtype, int Dk, int Dv) {
  return prefill_form(dtype, Dk, Dv);
}

// The wgmma form's dynamic shared memory per block at (Dk, Dv) (the Q
// buffers, the K / V ring, the mbarriers and the alignment slack), or 0
// for a pair that is not built.
extern "C" int flash_wgmma_smem_bytes(int Dk, int Dv) {
  if (Dk == 64 && Dv == 64) return int(wg::smem_bytes<64, 64>());
  if (Dk == 128 && Dv == 128) return int(wg::smem_bytes<128, 128>());
  if (Dk == 192 && Dv == 128) return int(wg::smem_bytes<192, 128>());
  if (Dk == 256 && Dv == 256) return int(wg::smem_bytes<256, 256>());
  return 0;
}

// The same for the SIMT form (the K/V ring, the warps' p tiles).
extern "C" int flash_simt_smem_bytes(int Dk, int Dv) {
  if (Dk == 64 && Dv == 64) return int(simt::smem_bytes<64, 64>());
  if (Dk == 128 && Dv == 128) return int(simt::smem_bytes<128, 128>());
  if (Dk == 192 && Dv == 128) return int(simt::smem_bytes<192, 128>());
  if (Dk == 256 && Dv == 256) return int(simt::smem_bytes<256, 256>());
  return 0;
}
