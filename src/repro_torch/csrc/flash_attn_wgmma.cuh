// K4's bf16 prefill form for Hopper at (Dk, Dv) = (64, 64), (128, 128),
// (192, 128) (DeepSeek-V2's MLA, unpadded) and (256, 256):
// flash_wgmma_kernel<DK, DV>, warpgroup products (wgmma.mma_async) on tiles
// that the tensor memory accelerator (cp.async.bulk.tensor) copies into
// shared memory.  Included by flash_attn.cu, whose launcher sends every
// bf16 prefill here; f32 takes the SIMT form.
//
// Replaces the TPU kernel src/repro/kernels/flash/kernel.py::_flash_kernel
// for bf16 operands, with the function written at the top of flash_attn.cu
// (scores in f32, -1e30 where the causal or window band drops a key, no
// weight past skv, p rounded to bf16 before p . v, l summing the unrounded
// p, out = acc / max(l, 1e-30) in bf16, the lse as m + log(max(l, 1e-30))
// in f32 when asked for).
//
// Bound on an H100: 2 (Dk + Dv) flops a (q, k) pair in the band at the
// dense bf16 rate, against q, k, v and out's bytes at 3.35 TB/s.  At the
// paths' prefills (B 4, S 1024, causal): qwen2-vl's g 7 at D 128 is 30.1
// GFLOP (0.0304 ms) against 67.1 MB (0.0200 ms); gemma-2b's MQA at D 256
// 17.2 GFLOP (0.0174 ms) against 37.7 MB (0.0113 ms); musicgen's MHA at D
// 64 12.9 GFLOP (0.0130 ms) against 50.3 MB (0.0150 ms), bound by bytes;
// MLA's 128 heads at (192, 128) 172 GFLOP (0.1739 ms) against 671 MB
// (0.2003 ms), bound by bytes.  The forms this one replaces issued
// mma.sync, in which every warp reads the whole K and V tile through
// ldmatrix for its own 16 rows; wgmma reads B from shared memory once for
// the four warps of a warpgroup and keeps A (Q) in shared memory too, and
// the copies cost no thread a register or an instruction.  At D 64 the
// exponentials of a tile take about as long as its products (16 a clock
// an SM), so the products hide less of the softmax than at D 128.
//
// Layout.  A block of 384 threads: warpgroup 0 is the producer (one
// thread issues every TMA copy; setmaxnreg drops its warps to 40
// registers), warpgroups 1 and 2 consume (232 registers each, the 168 a
// thread of the launch moved over: 128 x 40 + 256 x 232 = 384 x 168).
// The grid is persistent, one block an SM: a work item is a (batch, query
// head, 128-row q tile), each consumer warpgroup owning 64 consecutive
// rows for the whole softmax.  A block pays its launch, its barriers'
// set-up and its first copies once rather than once an item: the next
// item's first K and V tile land in the ring (and its Q in a second
// buffer where one fits) while this one runs (at D 64 a block per item
// spent about 4.5 us on those a block, 26 of musicgen's 63 us).  Whatever
// g, no head slot idles (g 7 included).  The head-pair layout (the two
// warpgroups on the same 64 rows of two query heads of one kv head, each
// K and V tile serving both) measured faster at some even g and slower at
// g 7 (PERF.md §6; that variant, a text edit of this header, is not
// kept).
//
// Work order (work_item).  The work items in head-major order (head by
// head, each head's q tiles last first) are cut into chunks, the last
// chunk taking the remainder, and each chunk's items run longest q tile
// first; block x takes item x of each even pass of the grid over the list
// and item gridDim.x - 1 - x of each odd one (snake).  Where K and V
// together exceed half the L2, a chunk is two passes (2 gridDim.x
// items): each block's two items of a chunk pair a long q tile with a
// short one, so the causal work evens out, and the blocks work one
// chunk's heads at a time, so a head's K and V come from device memory
// about once and then from the L2 for its other q tiles.  At MLA's
// serving shape (B 4, 128 heads, S 1024, 132 SMs: 8 q tiles a head) a
// chunk is 33 heads, whose K and V are 33 x 1024 x (192 + 128) x 2 B =
// 21.6 MB, well inside the 50 MB L2.  The list as one chunk (every head's
// last q tile first, then the next), the order below half the L2 (every
// Dk = Dv row of the paths: qwen2-72b's K and V are 16.8 MB), comes back
// to a head only after all its heads' K and V have passed: at MLA's 512
// heads 335 MB, so each q tile read its keys from device memory, 36 of a
// head's 8 x 8 key tiles, 1.51 GB a call, 0.45 ms at 3.35 TB/s.
// kernels/flash/ops.py mirrors the order (wgmma_chunk, wgmma_item) and
// counts these bytes under a model of the L2 (kv_read_bytes: 1.49 GB in
// one chunk, 0.336 GB, the once-bytes, in chunks of two passes).
//
// Tiles.  Key tiles of 128 keys at D 64 and 128 and at (192, 128), 64 at
// D 256: the S accumulator (64 x BK f32, BK / 2 registers a thread) sits
// beside O (64 x Dv f32: 32 registers at Dv 64, 64 at Dv 128, 128 at Dv
// 256) and P (BK / 4); at (192, 128) that is D 128's 64 + 64 + 32.  Two
// stages of K and V.  Shared bytes (smem_bytes, reported by
// flash_wgmma_smem_bytes): qbufs() Q buffers of 128 x Dk, stages() x (K
// BK x Dk + V BK x Dv), all bf16, the mbarriers and 1024 bytes that align
// the swizzled tiles: 99,424 at D 64, 197,728 at D 128, 197,712 at D 256
// and 214,096 at (192, 128) (one Q buffer where a second does not fit
// beside the ring: D 256 and (192, 128); there an item's Q waits for the
// item before to store its out from the buffer).
//
// Copies.  Each operand has a 4-D tensor map (d, s, h, b) over its own
// strides, encoded on the host at every call (cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint: the library links no
// libcuda), passed as a __grid_constant__ parameter.  A box is 64 columns
// (128 bytes, the 128-byte swizzle's width) by 64 q rows or BK keys of one
// head, so a tile is Dk / 64 boxes (Q, K) or Dv / 64 (V, out); rows past
// sq or skv arrive as zeros.  The strided head views models/layers.py
// passes need no copy; the wrapper's 16-byte rule (_checks.rows_aligned)
// is TMA's alignment.  An item's Q completes on its buffer's full barrier
// and the buffer is released, once the item's out has been stored from
// it, on its empty barrier; K_j and V_j each complete on their own full
// barrier and are released on their own empty barrier (256 arrivals), so
// K_j+1 can land while V_j is still read.
//
// Products.  S = Q K^T: wgmma m64nBKk16 with both operands in shared
// memory, K-major (a descriptor of the 128-byte swizzle; a k16 step moves
// the start address 32 bytes along a 128-byte row, a chunk of 64 columns
// away every four steps: Dk / 16 steps, 12 at Dk 192).  O += P V at n =
// Dv: P from registers (the S accumulator is, element for element, the A
// fragment of P once packed to bf16 pairs), V's [key][d] tile as the
// MN-major B operand (the next 64 columns a BK x 128-byte chunk on, the
// next 8 keys 1024 bytes on).
//
// Schedule.  Iteration j issues S_j and then PV_{j-1}, waits for S_j alone
// (wgmma groups complete in order) and computes its softmax while PV_{j-1}
// still runs, then waits for PV_{j-1}, rescales O and packs P_j.  The two
// warpgroups take turns to issue (named barriers 1 and 2: ping-pong), so
// the tensor cores run one warpgroup's products while the other computes
// exponentials.  Every warpgroup runs every tile of its item: a wgmma
// under a per-warpgroup test was serialized by ptxas ("compiler-inserted
// WG.AR in divergent path"), so a tile outside one warpgroup's band
// computes p = 0 there rather than being skipped.  Tiles wholly outside
// the item's band are neither copied nor computed (gemma3-1b's window
// 512, q_offset); a tile inside every row's band skips the masking.
//
// Softmax.  Scores scaled to log2 units (x = s * scale * log2(e), so any
// scale is taken: the max is over scaled scores); a dropped key's score
// is -1e30 * log2(e), so a row with no key in its band averages every key
// (p = 1) as the plain version does, and its lse is written as -1e30 +
// log(l); keys past skv get -inf.  p = 2^(x - m) by ex2.approx.ftz; l sums
// the unrounded p per thread, over the quad at the end.
//
// Epilogue.  out / l is packed to bf16 into the warpgroup's own Q rows
// (its last S has read them; out's Dv / 64 chunks take the first of Q's
// Dk / 64) in the swizzled layout the Q copy used, and one thread stores
// each 64-column chunk with a TMA store (rows past sq are not written),
// waits until the store has read the rows, and frees the buffer.  The
// lse, when asked for, goes straight from the quad's first thread.
//
// Measured on an H100 and rejected (PERF.md §6; the variants were text
// edits of this header, not kept): the serial schedule (S, softmax, PV,
// each waited for), 3 stages at D 128, ping-pong off, the threads' own
// stores, the head-pair layout; at D 64, three consumer warpgroups of 192
// rows, two blocks an SM of one consumer warpgroup each (level with the
// persistent grid once it was persistent too), three or four stages,
// 64-key tiles, the work list in groups of heads on a 128-block grid.
#pragma once

#include <cuda.h>               // CUtensorMap and its enums (no libcuda link)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "flash_common.cuh"     // Strides, smem_u32, pack_bf16, kMaskAdd

namespace {

namespace wg {

using bf16 = __nv_bfloat16;
using mma::pack_bf16;
using mma::smem_u32;

constexpr int kWGRows = 64;             // query rows a consumer warpgroup
constexpr int kConsumers = 2;           // consumer warpgroups a block
constexpr int kThreads = 128 * (1 + kConsumers);  // and the producer's
constexpr int kChunk = 64;              // bf16 columns of a 128-byte box
constexpr int kProducerRegs = 40;       // setmaxnreg: 128 x 40 + 256 x 232
constexpr int kConsumerRegs = 232;      // = 384 x 168, the launch's registers
constexpr size_t kSmemMax = 232448;     // the shared bytes a block can have
constexpr long long kL2Bytes = 50ll << 20;  // the H100's L2
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// a dropped key's score in log2 units: -1e30 * log2(e), as the plain
// version's s * scale - 1e30 once both are scaled by log2(e)
constexpr float kMaskL2 = -1.4426950408889634e30f;

// The tile plan (the header's note) at q and k's head dim DK and v's DV:
// keys a tile, and the shared bytes of the Q buffers (both warpgroups'
// rows each), stages() K and V tiles, the mbarriers and the slack that
// aligns the base to the 1024 bytes of a swizzle pattern.
template <int DK, int DV> __host__ __device__ constexpr int keys() {
  return DK == 256 ? 64 : 128;
}
// K and V tiles in flight (a third stage at D 128, a third or fourth at D
// 64 measured level with two; at D 256 and (192, 128) it does not fit
// beside Q)
template <int DK, int DV> __host__ __device__ constexpr int stages() {
  return 2;
}
template <int DK, int DV> __host__ __device__ constexpr uint32_t q_bytes() {
  return uint32_t(kConsumers) * kWGRows * DK * 2;
}
template <int DK, int DV> __host__ __device__ constexpr uint32_t k_tile() {
  return uint32_t(keys<DK, DV>()) * DK * 2;
}
template <int DK, int DV> __host__ __device__ constexpr uint32_t v_tile() {
  return uint32_t(keys<DK, DV>()) * DV * 2;
}
// the block's shared bytes with nq Q buffers
template <int DK, int DV>
__host__ __device__ constexpr size_t plan_bytes(int nq) {
  return size_t(nq) * q_bytes<DK, DV>() +
         size_t(stages<DK, DV>()) * (k_tile<DK, DV>() + v_tile<DK, DV>()) +
         8 * (2 * nq + 4 * stages<DK, DV>()) + 1024;
}
// Q buffers: two where they fit beside the ring (the next item's Q lands
// while this one's runs), else one (D 256, and (192, 128) at 128-key
// tiles)
template <int DK, int DV> __host__ __device__ constexpr int qbufs() {
  return plan_bytes<DK, DV>(2) <= kSmemMax ? 2 : 1;
}
template <int DK, int DV> __host__ __device__ constexpr uint32_t bar_offset() {
  return qbufs<DK, DV>() * q_bytes<DK, DV>() +
         stages<DK, DV>() * (k_tile<DK, DV>() + v_tile<DK, DV>());
}
template <int DK, int DV> __host__ __device__ constexpr size_t smem_bytes() {
  return plan_bytes<DK, DV>(qbufs<DK, DV>());
}
static_assert(smem_bytes<64, 64>() <= kSmemMax &&
                  smem_bytes<128, 128>() <= kSmemMax &&
                  smem_bytes<192, 128>() <= kSmemMax &&
                  smem_bytes<256, 256>() <= kSmemMax,
              "a block's shared memory");

// ---- mbarriers, TMA and wgmma in inline PTX -----------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// one box of shared memory at src to the 4-D map at those coordinates;
// rows past the map's extent are not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int d, int s, int h,
                                          int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.tile.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(d), "r"(s),
      "r"(h), "r"(b)
      : "memory");
}
__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
// one box of the 4-D map (d, s, h, b) at those coordinates into dst,
// completing on bar; a row past the map's extent lands as zeros
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int s, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d),
      "r"(s), "r"(h), "r"(b)
      : "memory");
}

template <int N> __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N> __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
// named barriers 1 and 2 over both consumer warpgroups' 256 threads
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// 2^x by the SFU alone (ex2.approx.ftz: relative error about 2^-22,
// results below 2^-126 flushed to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// keeps the compiler from moving accesses of r across a wgmma
template <int N> __device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// A shared-memory matrix descriptor for 128-byte swizzled tiles: the
// start address, the leading and stride byte offsets (16-byte units) and
// the swizzle mode (1 << 62)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (1ull << 62);
}

// d (64 x 64 f32) (+)= A (64 x 16, shared, K-major) . B (64 x 16,
// shared, K-major); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128 f32) (+)= A (64 x 16, shared, K-major) . B (128 x 16,
// shared, K-major); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64 f32) += A (64 x 16 bf16 in registers, the m16n8k16 A
// fragment of each warp's 16 rows) . B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128 f32) += A (64 x 16 bf16 in registers, the m16n8k16 A
// fragment of each warp's 16 rows) . B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, "
      "1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 256 f32) += A (64 x 16 bf16 in registers, the m16n8k16 A
// fragment of each warp's 16 rows) . B (16 x 256, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, "
      "%71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, "
      "%85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, "
      "%99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, "
      "%121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, "
      "%132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Work item wk of the list: (batch x head, q tile).  The head-major list
// (head by head, each head's q tiles last first) is cut into chunks of
// `chunk` items, the last chunk taking the remainder, and each chunk's
// items run longest q tile first (the last tile of every head in the
// chunk, then the one before), heads in order.  One chunk over the whole
// list is every head's last q tile first, then the next.  A chunk's items
// at one q tile: the heads h with s <= h nqt + (nqt - 1 - qt) < e.
// kernels/flash/ops.py's wgmma_item mirrors it.
__device__ __forceinline__ void work_item(int wk, int bh_count, int nqt,
                                          int chunk, int& bh, int& qt) {
  const int nwork = bh_count * nqt;
  // one chunk: two divisions (a lookup of more divisions, which every
  // consumer thread runs for every item, cost the rows of one chunk 2-6 %
  // on an H100)
  if (chunk >= nwork) {
    bh = wk % bh_count;
    qt = nqt - 1 - wk / bh_count;
    return;
  }
  const int last = max(0, nwork / chunk - 1);
  const int c = min(wk / chunk, last);
  const int s = c * chunk, e = c == last ? nwork : s + chunk;
  int r = wk - s;
  for (int u = 0; u < nqt; ++u) {        // u: q tiles before the last
    const int h0 = (s - u + nqt - 1) / nqt;          // s - u + nqt - 1 >= 0
    const int n = e - 1 - u < 0 ? 0 : max(0, (e - 1 - u) / nqt - h0 + 1);
    if (r < n) {
      bh = h0 + r;
      qt = nqt - 1 - u;
      return;
    }
    r -= n;
  }
  bh = qt = 0;                           // not reached: r < e - s
}

// A persistent block (one an SM) walks its share of the work items, each
// a (batch, query head, q tile of NW x 64 rows); consumer warpgroup w takes
// rows row0 + 64 w .. of the item's head.  Warp 0 of warpgroup 0 is the
// producer: one thread copies each item's Q into one of qbufs() buffers,
// then each key tile's K and V into the ring, running ahead into the next
// item; the other warpgroups consume.  q and
// k are DK wide, v and out DV.  The header's note gives the design.
template <int DK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tmq,
                   const __grid_constant__ CUtensorMap tmk,
                   const __grid_constant__ CUtensorMap tmv,
                   const __grid_constant__ CUtensorMap tmo,
                   float* __restrict__ lse, int B, int H, int g, int sq,
                   int skv, int causal, int window, int q_off, float scale,
                   int chunk) {
  constexpr int BK = keys<DK, DV>();
  constexpr int NW = kConsumers;
  constexpr int NQ = qbufs<DK, DV>();
  constexpr int NCK = DK / kChunk;         // 128-byte column chunks of q, k
  constexpr int NCV = DV / kChunk;         // ... of v and out
  constexpr uint32_t QWG = kWGRows * DK * 2;  // one warpgroup's Q bytes
  constexpr uint32_t KT = k_tile<DK, DV>(), VT = v_tile<DK, DV>();
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t base = (smem_u32(wg_smem) + 1023) & ~1023u;
  constexpr int NS = stages<DK, DV>();
  const uint32_t sQ = base, sK = base + NQ * q_bytes<DK, DV>(),
                 sV = sK + NS * KT;
  // mbarriers: per Q buffer full and empty, then per stage K full, V
  // full, K empty and V empty
  const uint32_t bar = base + bar_offset<DK, DV>();
  auto q_full = [&](int qb) { return bar + 8 * qb; };
  auto q_empty = [&](int qb) { return bar + 8 * (NQ + qb); };
  const uint32_t ring = bar + 16 * NQ;
  auto k_full = [&](int st) { return ring + 8 * st; };
  auto v_full = [&](int st) { return ring + 8 * (NS + st); };
  auto k_empty = [&](int st) { return ring + 8 * (2 * NS + st); };
  auto v_empty = [&](int st) { return ring + 8 * (3 * NS + st); };

  // Work item i of this block: passes of gridDim.x items over the list
  // (work_item), in snake order (block x takes item x of an even pass and
  // gridDim.x - 1 - x of an odd one), so that a chunk's longest items
  // pair with its shortest and each block's sum of causal work evens out;
  // -1 past the list.
  const int nqt = (sq + NW * kWGRows - 1) / (NW * kWGRows);
  const int nwork = B * H * nqt;
  auto work = [&](int i) {
    const int wk = i * int(gridDim.x) +
                   (i & 1 ? int(gridDim.x) - 1 - int(blockIdx.x)
                          : int(blockIdx.x));
    return wk < nwork ? wk : -1;
  };
  // an item's head, rows and band: the keys its rows meet (row i sits at
  // position i + q_off); a row with no key in its band (only with a
  // window and sq + q_off > skv) needs every key, at the mask value
  struct Item {
    int b, h, row0, kv_lo, ntiles;
  };
  auto item = [&](int wk) {
    Item it;
    int bh, qt;
    work_item(wk, B * H, nqt, chunk, bh, qt);
    it.b = bh / H;
    it.h = bh % H;
    it.row0 = qt * NW * kWGRows;
    const int hi = min(sq, it.row0 + NW * kWGRows);
    const int p0 = it.row0 + q_off, p1 = hi + q_off;
    int kv_lo = 0, kv_hi = causal ? min(skv, p1) : skv;
    if (window > 0) {
      if (p1 - window >= skv) kv_hi = skv;
      else kv_lo = max(0, p0 - window + 1);
    }
    it.kv_lo = kv_lo;
    it.ntiles = (kv_hi - kv_lo + BK - 1) / BK;   // at least 1: skv >= 1
    return it;
  };

  if (threadIdx.x == 0) {
    for (int qb = 0; qb < NQ; ++qb) {
      mbar_init(q_full(qb), 1);
      mbar_init(q_empty(qb), NW);
    }
    for (int st = 0; st < NS; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(k_empty(st), NW * 128);
      mbar_init(v_empty(st), NW * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 0) {
    // ---- producer: one thread issues every copy ----
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int n = 0;                           // key tiles copied so far
      for (int i = 0, wk; (wk = work(i)) >= 0; ++i) {
        const Item it = item(wk);
        const int qb = i % NQ, hk = it.h / g;
        // every consumer's rows, those past sq as zeros, once the item
        // NQ before has stored its out from this buffer
        if (i >= NQ) mbar_wait(q_empty(qb), (i / NQ - 1) & 1);
        mbar_expect_tx(q_full(qb), NW * QWG);
        for (int w = 0; w < NW; ++w)
          for (int c = 0; c < NCK; ++c)
            tma_load(sQ + qb * q_bytes<DK, DV>() + w * QWG +
                         c * (kWGRows * 128),
                     &tmq, q_full(qb), c * kChunk, it.row0 + w * kWGRows,
                     it.h, it.b);
        for (int j = 0; j < it.ntiles; ++j, ++n) {
          const int st = n % NS, t0 = it.kv_lo + j * BK;
          const int done = (n / NS - 1) & 1;   // tile n - NS's release
          if (n >= NS) mbar_wait(k_empty(st), done);
          mbar_expect_tx(k_full(st), KT);
          for (int c = 0; c < NCK; ++c)
            tma_load(sK + st * KT + c * (BK * 128), &tmk, k_full(st),
                     c * kChunk, t0, hk, it.b);
          if (n >= NS) mbar_wait(v_empty(st), done);
          mbar_expect_tx(v_full(st), VT);
          for (int c = 0; c < NCV; ++c)
            tma_load(sV + st * VT + c * (BK * 128), &tmv, v_full(st),
                     c * kChunk, t0, hk, it.b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup w owns 64 rows of an item for its whole
    // softmax ----
    setmaxnreg_inc<kConsumerRegs>();
    const int w = wgi - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int gr = lane / 4, tig = lane % 4;  // fragment row, column pair
    const float c = scale * kLog2e;          // raw scores to log2 units

    // Ping-pong: the warpgroups take turns to issue, so the tensor cores
    // run one warpgroup's products while another computes its softmax.
    // Warpgroup w issues after a bar.sync on barrier 1 + w and then
    // arrives on the next one's (w + 1 mod NW); the last arrives once
    // first, so 0 goes first, and skips its block's last arrival, so each
    // barrier sees as many arrivals as syncs (ntiles + 1 issue turns an
    // item, the same for every warpgroup).
    auto turn = [&]() { bar_sync(1 + w); };
    auto yield = [&](bool last) {
      if (!(last && w == NW - 1)) bar_arrive(1 + (w + 1) % NW);
    };
    if (w == NW - 1) bar_arrive(1);

    int n = 0;                             // key tiles consumed so far
    for (int i = 0, wk; (wk = work(i)) >= 0; ++i) {
      const Item it = item(wk);
      const bool last_item = work(i + 1) < 0;
      const int qb = i % NQ, ntiles = it.ntiles, kv_lo = it.kv_lo;
      const int rw = it.row0 + w * kWGRows;  // the warpgroup's first row
      const int pw0 = rw + q_off;            // ... its first position
      const int pw1 = pw0 + kWGRows - 1;     // ... and its last
      const int pr = pw0 + 16 * warp + gr;   // this thread's row 0 position
      const uint32_t qw = sQ + qb * q_bytes<DK, DV>() + w * QWG;

      float o[DV / 2];
#pragma unroll
      for (int k = 0; k < DV / 2; ++k) o[k] = 0.f;
      float m[2] = {kMaskL2, kMaskL2}, l[2] = {0.f, 0.f};
      float s[BK / 2];                        // S_j, then its p
      uint32_t pa[BK / 16][4];                // P_{j-1}: the A operand
      float corr[2];

      // Every warpgroup runs every key tile of the item, so that each
      // wgmma sits in control flow the whole warpgroup shares (a wgmma
      // behind a per-warpgroup test was serialized by ptxas); a tile
      // wholly outside a warpgroup's band computes p = 0 there.
      //
      // S_j = Q K_j^T: DK / 16 steps of k16, a step 32 bytes along a
      // 128-byte chunk, four steps a chunk
      auto issue_s = [&](int j) {
        const uint32_t kt = sK + ((n + j) % NS) * KT;
#pragma unroll
        for (int kk = 0; kk < DK / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;
          const uint64_t da =
              desc(qw + (kk / 4) * (kWGRows * 128) + off, 16, 1024);
          const uint64_t db =
              desc(kt + (kk / 4) * (BK * 128) + off, 16, 1024);
          if constexpr (BK == 128) wgmma_ss_n128(s, da, db, kk > 0);
          else wgmma_ss_n64(s, da, db, kk > 0);
        }
        wgmma_commit();
      };
      // O += round_to_bf16(P_j) . V_j at n = DV: S's accumulator is, block
      // for block, the A fragment of P; V's [key][d] chunks are the
      // MN-major B operand (the next 64 columns LBO = BK * 128 bytes on,
      // the next 8 keys 1024)
      auto issue_pv = [&](int j) {
        const uint32_t vt = sV + ((n + j) % NS) * VT;
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t db = desc(vt + kk * 16 * 128, BK * 128, 1024);
          if constexpr (DV == 64) wgmma_rs_n64(o, pa[kk], db);
          else if constexpr (DV == 128) wgmma_rs_n128(o, pa[kk], db);
          else wgmma_rs_n256(o, pa[kk], db);
        }
        wgmma_commit();
      };
      // S_j's p in place, m and l updated, corr the rescale of O
      auto softmax = [&](int j) {
        const int t0 = kv_lo + j * BK;
        // scale to log2 units and mask; a tile inside every row's band of
        // the warpgroup skips the per-element test
        const bool inside = t0 + BK <= skv &&
                            (!causal || t0 + BK - 1 <= pw0) &&
                            (window <= 0 || t0 > pw1 - window);
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int nb = 0; nb < BK / 8; ++nb) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[4 * nb + e] * c;
            if (!inside) {
              const int row = pr + (e >> 1) * 8;
              const int key = t0 + nb * 8 + tig * 2 + (e & 1);
              bool keep = !causal || key <= row;
              if (window > 0) keep = keep && key > row - window;
              x = key < skv ? (keep ? x : kMaskL2) : -INFINITY;
            }
            s[4 * nb + e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          corr[r] = exp2_approx(m[r] - mx[r]);
          m[r] = mx[r];
          l[r] *= corr[r];
        }
#pragma unroll
        for (int nb = 0; nb < BK / 8; ++nb) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = exp2_approx(s[4 * nb + e] - m[e >> 1]);
            l[e >> 1] += p;                // the unrounded p, as the reference
            s[4 * nb + e] = p;
          }
        }
      };
      // O rescaled to the new row max, and P_j packed over P_{j-1}
      auto rescale_pack = [&]() {
#pragma unroll
        for (int nb = 0; nb < DV / 8; ++nb) {
          o[4 * nb] *= corr[0];
          o[4 * nb + 1] *= corr[0];
          o[4 * nb + 2] *= corr[1];
          o[4 * nb + 3] *= corr[1];
        }
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
          pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
          pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
          pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
        }
      };
      auto k_wait = [&](int j) {
        mbar_wait(k_full((n + j) % NS), ((n + j) / NS) & 1);
      };
      auto v_wait = [&](int j) {
        mbar_wait(v_full((n + j) % NS), ((n + j) / NS) & 1);
      };

      // tile j's S = Q K^T goes in while tile j - 1's O += P V still runs,
      // and j's softmax overlaps that product: iteration j issues S_j,
      // then PV_{j-1}, waits for S_j alone (wgmma groups complete in
      // order), computes j's p, then waits for PV_{j-1} before it
      // rescales O and packs P_j over P_{j-1}.  K_j is released once S_j
      // is done, V_{j-1} once PV_{j-1} is.
      mbar_wait(q_full(qb), (i / NQ) & 1);
      k_wait(0);
      turn();
      wgmma_fence();
      issue_s(0);
      yield(false);
      wgmma_wait<0>();
      fence_regs(s);
      mbar_arrive(k_empty(n % NS));
      softmax(0);
      rescale_pack();
      for (int j = 1; j < ntiles; ++j) {
        k_wait(j);
        v_wait(j - 1);
        fence_regs(o);
        turn();
        wgmma_fence();
        issue_s(j);
        issue_pv(j - 1);
        yield(false);
        wgmma_wait<1>();
        fence_regs(s);
        mbar_arrive(k_empty((n + j) % NS));
        softmax(j);
        wgmma_wait<0>();
        fence_regs(o);
        mbar_arrive(v_empty((n + j - 1) % NS));
        rescale_pack();
      }
      v_wait(ntiles - 1);
      fence_regs(o);
      turn();
      wgmma_fence();
      issue_pv(ntiles - 1);
      yield(last_item);
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(v_empty((n + ntiles - 1) % NS));
      n += ntiles;

      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float lr = l[r];
        lr += __shfl_xor_sync(0xffffffffu, lr, 1);
        lr += __shfl_xor_sync(0xffffffffu, lr, 2);
        const float den = fmaxf(lr, 1e-30f);
        inv[r] = 1.f / den;
        const int row = rw + 16 * warp + gr + 8 * r;
        // the row's log-sum-exp of the scaled scores, in natural units; a
        // row that saw only dropped keys sits at -1e30, as in the plain
        // version
        if (lse != nullptr && tig == 0 && row < sq)
          lse[(size_t(it.b) * H + it.h) * sq + row] =
              (m[r] == kMaskL2 ? kMaskAdd : m[r] * kLn2) + logf(den);
      }
      // out / l in bf16 over this warpgroup's Q rows (its last S has read
      // them; out's DV / 64 chunks take the first of Q's DK / 64), in the
      // layout the Q copy used: 64-column chunks of 64 rows of 128 bytes,
      // a row's 16-byte units XOR-swizzled by row % 8; then one thread
      // stores each chunk with TMA, rows past sq left out, and frees the
      // buffer for the item NQ on once the store has read it
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rr = 16 * warp + gr + 8 * r;
#pragma unroll
        for (int nb = 0; nb < DV / 8; ++nb)
          st_shared(qw + (nb / 8) * (kWGRows * 128) + rr * 128 +
                        (((nb % 8) ^ (rr % 8)) * 16) + tig * 4,
                    pack_bf16(o[4 * nb + 2 * r] * inv[r],
                              o[4 * nb + 2 * r + 1] * inv[r]));
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + NW + w) : "memory");
      if (threadIdx.x % 128 == 0) {
        for (int ch = 0; ch < NCV; ++ch)
          tma_store(&tmo, qw + ch * (kWGRows * 128), ch * kChunk, rw, it.h,
                    it.b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        mbar_arrive(q_empty(qb));
      }
    }
  }
}

}  // namespace wg

// ---- host side: tensor maps and the launch ------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library links no libcuda; null if the driver has none
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A 4-D map (d, s, h, b) of one bf16 operand over its own element strides,
// boxes of 64 columns x `rows` rows of one head, 128-byte swizzled; rows
// past S read as zeros.  A dim of size 1 is never stepped, so its stride
// (which PyTorch leaves free) is given as 16 bytes.
inline bool encode_operand(CUtensorMap* map, const void* p, int D, int S,
                           int Hx, int B, const Strides& st, int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(S), cuuint64_t(Hx),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {
      S > 1 ? cuuint64_t(st.s) * 2 : 16, Hx > 1 ? cuuint64_t(st.h) * 2 : 16,
      B > 1 ? cuuint64_t(st.b) * 2 : 16};
  const cuuint32_t box[4] = {cuuint32_t(wg::kChunk), cuuint32_t(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// flash_wgmma_kernel<DK, DV> on one call, its four tensor maps encoded
// here (q and k at DK, v and out at DV)
template <int DK, int DV>
cudaError_t launch_wgmma(void* out, const void* q, const void* k,
                         const void* v, Strides qs, Strides ks, Strides vs,
                         int B, int H, int Hkv, int sq, int skv, int causal,
                         int window, int q_off, float scale, float* lse,
                         cudaStream_t stream) {
  CUtensorMap tq, tk, tv, to;
  constexpr int BK = wg::keys<DK, DV>();
  const Strides os{(long long)sq * H * DV, (long long)H * DV, DV};
  if (!encode_operand(&tq, q, DK, sq, H, B, qs, wg::kWGRows) ||
      !encode_operand(&tk, k, DK, skv, Hkv, B, ks, BK) ||
      !encode_operand(&tv, v, DV, skv, Hkv, B, vs, BK) ||
      !encode_operand(&to, out, DV, sq, H, B, os, wg::kWGRows))
    return cudaErrorInvalidValue;
  constexpr size_t smem = wg::smem_bytes<DK, DV>();
  const cudaError_t err = cudaFuncSetAttribute(
      wg::flash_wgmma_kernel<DK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  // one persistent block an SM (one an item where there are fewer)
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  constexpr int R = wg::kConsumers * wg::kWGRows;
  const long long nwork = (long long)B * H * ((sq + R - 1) / R);
  const int grid = int(std::min<long long>(nwork, sms));
  // the work list in chunks of two passes where K and V exceed half the
  // L2, else one chunk (the header's note; ops.wgmma_chunk mirrors it)
  const long long kv_bytes = (long long)B * Hkv * skv * (DK + DV) * 2;
  const int chunk = kv_bytes > wg::kL2Bytes / 2 ? 2 * grid : int(nwork);
  wg::flash_wgmma_kernel<DK, DV><<<grid, wg::kThreads, smem, stream>>>(
      tq, tk, tv, to, lse, B, H, H / Hkv, sq, skv, causal, window, q_off,
      scale, chunk);
  return cudaGetLastError();
}

}  // namespace
