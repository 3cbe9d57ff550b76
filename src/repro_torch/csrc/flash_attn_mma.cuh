// K4's bf16 prefill form on the tensor cores at (Dk, Dv) = (192, 128)
// (DeepSeek-V2's MLA, unpadded): flash_mma_qreg_kernel<DK, DV>, mma.sync
// m16n8k16 (bf16 in, f32 accumulate), operands from shared memory through
// ldmatrix, tiles brought in by cp.async into a two-stage ring, Q in
// registers, 128 rows of one query head a block.  Included by
// flash_attn.cu, whose launcher sends the bf16 prefills at that pair here;
// the pairs with Dk = Dv take the wgmma form (flash_attn_wgmma.cuh), f32
// the SIMT form.  (Until the wgmma form, this header also held
// flash_mma_kernel, D 256 with Q in shared memory and 32-key tiles, and
// built this kernel at (128, 128) and at (64, 64) with up to 3 query heads
// of a kv head a block; PERF.md keeps their last times.)
//
// Replaces the TPU kernel src/repro/kernels/flash/kernel.py::_flash_kernel
// for bf16 operands, with the function written at the top of flash_attn.cu
// (scores in f32, -1e30 where the causal or window band drops a key, no
// weight past skv, p rounded to bf16 before p . v, l summing the unrounded
// p, out = acc / max(l, 1e-30) in bf16).
//
// Bound on an H100: the products are 2 (Dk + Dv) flops a (q, k) pair in
// the band, and at the models' shapes their time at the dense bf16 rate
// exceeds that of q, k, v and out's bytes: bound by operations.  mma.sync
// reaches only part of the tensor cores' rate (wgmma, whose B operand four
// warps read from shared memory once, is the way to all of it).  What
// bounds this form instead is shared memory and the softmax's per-element
// work: every warp reads the whole K and V tile through ldmatrix.
//
// Layout (kQRows, kQKeys, kQStages), the fastest of the layouts measured
// on an H100:
//
// - Q in registers.  With Dv at most 128 the O accumulator is at most 64
//   registers a thread, so each warp loads its 16 x Dk Q fragments once
//   (Dk / 16 A fragments: 48 registers at Dk 192) and never re-reads them.
//   Per warp and 64-key tile the shared-memory reads are K's and V's
//   alone: 24 + 16 KB at (192, 128), where zero-padding both to 256 read
//   about 80 KB (Q's included) and did 60 % more products.
// - Rows a block.  Each K and V tile copied into shared memory serves
//   every query row of its block, so the copies per product fall with the
//   rows a block holds.  At (192, 128) a block holds 128 rows of one head
//   (8 warps; 64 rows ran MLA 30 % slower) and a ring of two stages (three
//   measured within 1 %): 137,216 bytes, one block an SM; more warps a
//   block would spill.
// - Shared memory: Q's staging and the K / V ring, all bf16, each row
//   padded by 8 elements (16 bytes), so consecutive rows start 16 bytes
//   apart modulo 128 and the 8 row addresses of each 8x8 ldmatrix fall in
//   8 different bank groups (no conflicts) without an XOR swizzle's address
//   arithmetic; the launcher opts in above 48 KB on every launch.
// - Fragments (PTX ISA, mma.m16n8k16 .bf16): S = Q K^T takes B from K's
//   rows with ldmatrix.x4 (two n8 blocks of keys x 16 d; K's row-major
//   [key][d] tile is the "col" operand as it stands).  The m16n8 f32 C
//   fragment of S is, element for element, the A fragment of the next
//   product, so P goes to bf16 pairs in registers and O += P V never sends
//   P through shared memory; V's B fragments come from its [key][d] tile
//   through ldmatrix.x4.trans.
// - Copies: 8 threads a row, 16 bytes each per 64 columns, so a thread's
//   column is fixed and only its row steps (an unrolled table of copy
//   addresses held 60 registers and spilled at (192, 128)); rows past sq
//   or skv are zero-filled with the src-size 0 form; one barrier a key
//   tile (see the kernel).  Every row start must be 16-byte aligned: the
//   Python wrapper raises unless each operand's data_ptr() is a multiple
//   of 16 bytes and its (b, s, h) strides multiples of 8 elements.
// - Softmax: a thread holds 2 rows of the score fragment (rows g and g+8
//   of its warp's 16); the row max finishes with two __shfl_xor over the
//   4 threads of a quad, l is kept per thread and summed over the quad
//   once, at the end.  A tile wholly inside every row's band of a warp
//   skips the masking.
// - The scale folded into the exponent: the row max is kept on the raw
//   scores and p = 2^(s * c - m * c) with c = scale * log2(e), one FMA a
//   score, by ex2.approx.ftz (exp2f's range fix-up cost 5 % at D 64); the
//   scale must be positive, which the wrapper checks.  A dropped key's raw
//   score is -2^k with 2^k * c in [2^100, 2^101), so m * c is exact for a
//   row that has seen only dropped keys and its keys average uniformly (p
//   = 1), as at -1e30; such a row's lse is written as -1e30 + log(l), the
//   plain version's value.
// - q tiles longest first: blockIdx.y counts from the last q tile, and the
//   grid's x runs over (batch, kv head, head block), so the causal tiles
//   with the most keys start in the first wave.
// - Epilogue: each warp writes acc / max(l, 1e-30) as bf16 pairs straight
//   from its fragments (staging them through shared memory for 16-byte
//   rows measured slower); with an lse pointer, one thread of each quad
//   writes its row's m + log(max(l, 1e-30)) in f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"     // Strides, smem_u32, cp_async16, pack_bf16

namespace {

namespace mma {

using bf16 = __nv_bfloat16;

constexpr int kPad = 8;                 // bf16 elements of padding per row
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
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

// lane's row and column (elements) in the 16x16 block that ldmatrix.x4
// reads for an A fragment, or for V's B fragments with .trans: matrices
// (rows 0-7, cols 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
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

// ---- the Q-register form ------------------------------------------------

// The Q-register form's layout (the header's note): 128 query rows of a
// head a block, 16 a warp; 64-key tiles in a two-stage ring.
constexpr int kQRows = 128;
constexpr int kQThreads = 32 * kQRows / 16;
constexpr int kQKeys = 64;
constexpr int kQStages = 2;

// Q's staging (QT rows x Dk) and the ring of K (Dk) and V (Dv) tiles,
// every row padded by kPad
template <int DK, int DV>
__host__ __device__ constexpr size_t qreg_smem_bytes() {
  return sizeof(bf16) * (size_t(kQRows) * (DK + kPad) +
                         size_t(kQStages) * kQKeys * (DK + kPad + DV + kPad));
}

// 2^x by the SFU alone (ex2.approx.ftz: relative error about 2^-22,
// results below 2^-126 flushed to 0), where exp2f adds a range fix-up of
// three instructions a call
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ROWS rows of DW elements from g (row r0 + r at g + (r0 + r) * stride)
// into a shared tile of row stride RS, by NT threads: 8 threads a row, 16
// bytes each per 64 columns, so a thread's column is fixed and only its
// row steps (no per-copy address table held in registers); rows at or
// past `limit` are zero-filled
template <int DW, int RS, int ROWS, int NT>
__device__ __forceinline__ void load_rows(bf16* s, const bf16* g,
                                          long long stride, int r0, int limit,
                                          int tid) {
  constexpr int RPP = NT / 8;             // rows a pass
  static_assert(DW % 64 == 0 && NT % 8 == 0, "64-column segments");
  const int c = (tid & 7) * 8, rt = tid >> 3;
#pragma unroll
  for (int p = 0; p < (ROWS + RPP - 1) / RPP; ++p) {
    const int r = rt + p * RPP;
    if (ROWS % RPP == 0 || r < ROWS) {
      const bool in = r0 + r < limit;
      const bf16* src = in ? g + (r0 + r) * stride + c : g;
      const uint32_t dst = smem_u32(s + r * RS + c);
#pragma unroll
      for (int seg = 0; seg < DW / 64; ++seg)
        cp_async16(dst + seg * 128, src + (in ? seg * 64 : 0), in);
    }
  }
}

// Block (x: b * H + h, y: q tile from the last): query head h against kv
// head h / g; warp w serves rows 16 w .. of the QT-row q tile.
// One barrier a key tile: tile j's copies are waited for, the barrier
// makes them visible and frees the stage tile j - 1 used, and tile j + 1
// goes into that stage while tile j is computed.  A warp whose rows all
// sit before a causal tile's first key skips it (exactly: their bands lie
// in tiles already seen, so it would add p = 0).  The header's note gives
// the design.
template <int DK, int DV>
__global__ void __launch_bounds__(kQThreads, 1)
flash_mma_qreg_kernel(bf16* __restrict__ out, const bf16* __restrict__ q,
                      const bf16* __restrict__ k, const bf16* __restrict__ v,
                      Strides qs, Strides ks, Strides vs, int H, int g,
                      int sq, int skv, int causal, int window, int q_off,
                      float scale, float* __restrict__ lse) {
  constexpr int NS = kQStages, BK = kQKeys;
  constexpr int QT = kQRows, NT = kQThreads;
  constexpr int RSK = DK + kPad, RSV = DV + kPad;
  constexpr int NQ = DK / 16;              // Q's A fragments
  constexpr int NO = DV / 8;               // n8 blocks of the O accumulator
  static_assert(DK % 64 == 0 && DV % 64 == 0, "64-column segments");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);   // [QT][RSK]
  bf16* sK = sQ + QT * RSK;                       // [NS][BK][RSK]
  bf16* sV = sK + NS * BK * RSK;                  // [NS][BK][RSV]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tig = lane & 3;       // fragment row, column pair
  const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / g;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * QT, q1 = min(q0 + QT, sq);
  const int w0 = q0 + warp * 16;                  // the warp's first row
  const bool busy = w0 < sq;
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;

  // the keys this tile's band meets (row i sits at position i + q_off); a
  // row with no key in its band (only with a window and sq + q_off > skv)
  // needs every key, at the mask value
  const int p0 = q0 + q_off, p1 = q1 + q_off, pw0 = w0 + q_off;
  int kv_lo = 0, kv_hi = causal ? min(skv, p1) : skv;
  if (window > 0) {
    if (p1 - window >= skv) kv_hi = skv;
    else kv_lo = max(0, p0 - window + 1);
  }

  // Q, then tiles 0 .. NS-2, one copy group each
  load_rows<DK, RSK, QT, NT>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, sq, tid);
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (kv_lo + i * BK < kv_hi) {
      load_rows<DK, RSK, BK, NT>(sK + i * BK * RSK, kb, ks.s,
                                 kv_lo + i * BK, skv, tid);
      load_rows<DV, RSV, BK, NT>(sV + i * BK * RSV, vb, vs.s,
                                 kv_lo + i * BK, skv, tid);
    }
    cp_async_commit();
  }
  cp_async_wait<NS - 1>();               // Q has landed
  __syncthreads();
  uint32_t qf[NQ][4];
  {
    const uint32_t qa =
        smem_u32(sQ + (warp * 16 + a_row(lane)) * RSK + a_col(lane));
#pragma unroll
    for (int kk = 0; kk < NQ; ++kk) ldsm_x4(qf[kk], qa + kk * 32);
  }

  // raw scores to log2 units, and a dropped key's raw score (see the note)
  const float c = scale * kLog2e;
  const float mask_raw = -ldexpf(1.f, min(127, 100 - ilogbf(c)));
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_r[2] = {mask_raw, mask_raw}, l_r[2] = {0.f, 0.f};
  const uint32_t kfrag = smem_u32(sK + b_row(lane) * RSK + b_col(lane));
  const uint32_t vfrag = smem_u32(sV + a_row(lane) * RSV + a_col(lane));

  int st = 0;                            // tile j's stage, j % NS
  for (int t0 = kv_lo; t0 < kv_hi; t0 += BK, st = st + 1 == NS ? 0 : st + 1) {
    cp_async_wait<NS - 2>();             // tile j has landed
    __syncthreads();                     // ... for every thread; j-1 done
    {
      const int tn = t0 + (NS - 1) * BK;   // tile j+NS-1 into j-1's stage
      const int sn = st == 0 ? NS - 1 : st - 1;
      if (tn < kv_hi) {
        load_rows<DK, RSK, BK, NT>(sK + sn * BK * RSK, kb, ks.s, tn, skv,
                                   tid);
        load_rows<DV, RSV, BK, NT>(sV + sn * BK * RSV, vb, vs.s, tn, skv,
                                   tid);
      }
      cp_async_commit();                 // (possibly empty) group
    }
    if (!busy || (causal && t0 > pw0 + 15)) continue;

    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    const uint32_t kt = kfrag + st * BK * RSK * 2;
#pragma unroll
    for (int kk = 0; kk < NQ; ++kk) {
#pragma unroll
      for (int nb = 0; nb < BK / 16; ++nb) {
        uint32_t bk[4];
        ldsm_x4(bk, kt + nb * 16 * RSK * 2 + kk * 32);
        mma_bf16(s[2 * nb], qf[kk], bk[0], bk[1]);
        mma_bf16(s[2 * nb + 1], qf[kk], bk[2], bk[3]);
      }
    }

    // mask the raw scores; a tile inside every row's band of this warp
    // skips the per-element test
    const bool inside = t0 + BK <= skv &&
                        (!causal || t0 + BK - 1 <= pw0) &&
                        (window <= 0 || t0 > pw0 + 15 - window);
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e];
        if (!inside) {
          const int row = pw0 + gr + (e >> 1) * 8;
          const int key = t0 + n * 8 + tig * 2 + (e & 1);
          bool keep = !causal || key <= row;
          if (window > 0) keep = keep && key > row - window;
          x = key < skv ? (keep ? x : mask_raw) : -INFINITY;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2], mc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2_approx((m_r[r] - mx[r]) * c);
      m_r[r] = mx[r];
      mc[r] = mx[r] * c;
      l_r[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2_approx(fmaf(s[n][e], c, -mc[e >> 1]));
        l_r[e >> 1] += p;                // the unrounded p, as the reference
        s[n][e] = p;
      }
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // O += round_to_bf16(P) . V: S's C fragments are P's A fragments
    const uint32_t vt = vfrag + st * BK * RSV * 2;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nb = 0; nb < DV / 16; ++nb) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, vt + kk * 16 * RSV * 2 + nb * 32);
        mma_bf16(o[2 * nb], a, bv[0], bv[1]);
        mma_bf16(o[2 * nb + 1], a, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait<0>();
  if (!busy) return;

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float den = fmaxf(l, 1e-30f);
    const int row = w0 + gr + r * 8;
    if (row >= sq) continue;
    // the row's log-sum-exp of the scaled scores, in natural units; a row
    // that saw only dropped keys sits at -1e30, as in the plain version
    if (lse != nullptr && tig == 0)
      lse[(size_t(b) * H + h) * sq + row] =
          (m_r[r] == mask_raw ? kMaskAdd : m_r[r] * scale) + logf(den);
    bf16* orow = out + ((size_t(b) * sq + row) * H + h) * DV;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + tig * 2) =
          pack_bf16(o[n][2 * r] / den, o[n][2 * r + 1] / den);
  }
}

}  // namespace mma

template <int DK, int DV>
cudaError_t launch_mma_qreg(void* out, const void* q, const void* k,
                            const void* v, Strides qs, Strides ks, Strides vs,
                            int B, int H, int Hkv, int sq, int skv,
                            int causal, int window, int q_off, float scale,
                            float* lse, cudaStream_t stream) {
  constexpr size_t smem = mma::qreg_smem_bytes<DK, DV>();
  const cudaError_t err = cudaFuncSetAttribute(
      mma::flash_mma_qreg_kernel<DK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (sq + mma::kQRows - 1) / mma::kQRows, 1);
  mma::flash_mma_qreg_kernel<DK, DV>
      <<<grid, mma::kQThreads, smem, stream>>>(
          static_cast<mma::bf16*>(out), static_cast<const mma::bf16*>(q),
          static_cast<const mma::bf16*>(k), static_cast<const mma::bf16*>(v),
          qs, ks, vs, H, H / Hkv, sq, skv, causal, window, q_off, scale, lse);
  return cudaGetLastError();
}

}  // namespace
