// K1: "valid" integer stencil convolution of a zero-pre-shifted plane.
//
// Replaces the TPU kernel src/repro/kernels/conv2d/kernel.py::_conv_kernel
// (launched by conv2d_strips, wrappers conv2d_stencil / conv2d_hwimg_site).
//
//   out[n, y, x] = ((sum_{dy<kh, dx<kw} P[n, y+dy, x+dx] * K[dy, dx]) >> shift) & 0xFF
//
// P (n, h+kh-1, w+kw-1) int32, K (kh, kw) int32, out (n, h, w) int32.
//
// Bound on an H100: at CONVOLUTION 1080p (out 1088x1936, 8x8 taps) the
// kernel moves ~16.9 MB and does 1.35e8 int32 multiply-adds (one IMAD
// each), so it is bound by integer operations, not bytes.  A thread per
// output that reads its 64 pixels and 64 taps issues two loads per IMAD,
// and a warp's loads then take longer than its IMADs: the design is about
// load instructions.
//
// Design: a thread computes kRows = 16 outputs down one column.  It slides
// down the plane, reading each of its kRows + kh - 1 input rows once (kw
// loads through the read-only cache, neighbouring threads on neighbouring
// columns), and every row feeds the up to kh accumulators whose window
// holds it: 184 plane loads for 16 outputs at 8x8 taps, 11.5 an output
// against 128.  Blocks of 32 x 4 threads cover 32 columns x 64 rows, so a
// block's threads stacked down a column share rows in L1.  The frame index
// is on grid z, so a batch of frames is one launch.  The TPU kernel's 8-row
// strips (and the row padding its wrapper adds) are a tiling artifact: a
// thread masks its own ragged edge (rows past the plane are clamped into
// it and feed only outputs past h, which are not written).
//
// Two forms behind one launcher, both K1: 8x8 taps (CONVOLUTION's) as a
// compile-time instance, every loop unrolled, its 64 taps loaded once per
// thread (64 + 184 global loads in all; the taps' address is the same
// across the warp, so ptxas moves most of them into uniform registers,
// which IMAD reads directly, and the thread needs 56 general registers);
// any other kh x kw in a general form that reads its taps through the
// read-only cache where it uses them.
//
// Exactness: the sum is accumulated in unsigned int, whose wrap is defined
// and equals int32 two's-complement wrap, the plain version's (torch)
// semantics.  The lowering's conv2d rule (_conv_guard) proves the sum stays
// below 2^31, so on the main path nothing wraps at all.  The shift is
// clamped at 31: an arithmetic shift by 31 or more yields the sign fill.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;              // threads across: a column each
constexpr int kStack = 4;              // threads down a block
constexpr int kRows = 16;              // output rows per thread
constexpr int kThreads = kCols * kStack;

__device__ __forceinline__ void store_rows(int32_t* o, const unsigned* acc,
                                           int rows_left, int w, int shift) {
  const int s = shift < 31 ? shift : 31;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    if (i < rows_left)
      o[static_cast<size_t>(i) * w] = (static_cast<int>(acc[i]) >> s) & 0xFF;
}

// KH x KW taps known at compile time: taps in registers, all unrolled
template <int KH, int KW>
__global__ void __launch_bounds__(kThreads)
conv2d_fixed_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ p,
                    const int32_t* __restrict__ k, int h, int w, int hp,
                    int wp, int shift) {
  const int x = blockIdx.x * kCols + threadIdx.x;
  const int y0 = (blockIdx.y * kStack + threadIdx.y) * kRows;
  if (x >= w || y0 >= h) return;
  unsigned tap[KH][KW];
#pragma unroll
  for (int dy = 0; dy < KH; ++dy)
#pragma unroll
    for (int dx = 0; dx < KW; ++dx)
      tap[dy][dx] = static_cast<unsigned>(__ldg(k + dy * KW + dx));
  const int32_t* plane = p + static_cast<size_t>(blockIdx.z) * hp * wp + x;
  unsigned acc[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i] = 0u;
#pragma unroll
  for (int r = 0; r < kRows + KH - 1; ++r) {
    const int32_t* row = plane + static_cast<size_t>(min(y0 + r, hp - 1)) * wp;
    unsigned v[KW];
#pragma unroll
    for (int dx = 0; dx < KW; ++dx) v[dx] = static_cast<unsigned>(__ldg(row + dx));
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int dy = r - i;          // output row y0 + i reads this row at dy
      if (dy >= 0 && dy < KH) {
#pragma unroll
        for (int dx = 0; dx < KW; ++dx) acc[i] += v[dx] * tap[dy][dx];
      }
    }
  }
  store_rows(out + static_cast<size_t>(blockIdx.z) * h * w +
                 static_cast<size_t>(y0) * w + x,
             acc, h - y0, w, shift);
}

// any kh x kw: the same slide, taps read where they are used
__global__ void __launch_bounds__(kThreads)
conv2d_general_kernel(int32_t* __restrict__ out,
                      const int32_t* __restrict__ p,
                      const int32_t* __restrict__ k, int h, int w, int hp,
                      int wp, int kh, int kw, int shift) {
  const int x = blockIdx.x * kCols + threadIdx.x;
  const int y0 = (blockIdx.y * kStack + threadIdx.y) * kRows;
  if (x >= w || y0 >= h) return;
  const int32_t* plane = p + static_cast<size_t>(blockIdx.z) * hp * wp + x;
  unsigned acc[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i] = 0u;
  for (int r = 0; r < kRows + kh - 1; ++r) {
    const int32_t* row = plane + static_cast<size_t>(min(y0 + r, hp - 1)) * wp;
    for (int dx = 0; dx < kw; ++dx) {
      const unsigned v = static_cast<unsigned>(__ldg(row + dx));
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int dy = r - i;
        if (dy >= 0 && dy < kh)
          acc[i] += v * static_cast<unsigned>(__ldg(k + dy * kw + dx));
      }
    }
  }
  store_rows(out + static_cast<size_t>(blockIdx.z) * h * w +
                 static_cast<size_t>(y0) * w + x,
             acc, h - y0, w, shift);
}

}  // namespace

extern "C" int conv2d_launch(void* out, const void* p, const void* k, int n,
                             int h, int w, int hp, int wp, int kh, int kw,
                             int shift, void* stream) {
  const dim3 block(kCols, kStack, 1);
  const dim3 grid((w + kCols - 1) / kCols,
                  (h + kStack * kRows - 1) / (kStack * kRows), n);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int32_t* o = static_cast<int32_t*>(out);
  const int32_t* pp = static_cast<const int32_t*>(p);
  const int32_t* kk = static_cast<const int32_t*>(k);
  if (kh == 8 && kw == 8) {
    conv2d_fixed_kernel<8, 8><<<grid, block, 0, st>>>(o, pp, kk, h, w, hp, wp,
                                                      shift);
  } else {
    conv2d_general_kernel<<<grid, block, 0, st>>>(o, pp, kk, h, w, hp, wp, kh,
                                                  kw, shift);
  }
  return static_cast<int>(cudaGetLastError());
}
