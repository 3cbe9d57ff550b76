// K1: "valid" integer stencil convolution of a zero-pre-shifted plane.
//
// Replaces the TPU kernel src/repro/kernels/conv2d/kernel.py::_conv_kernel
// (launched by conv2d_strips, wrappers conv2d_stencil / conv2d_hwimg_site).
//
//   out[n, y, x] = ((sum_{dy<kh, dx<kw} P[n, y+dy, x+dx] * K[dy, dx]) >> shift) & 0xFF
//
// P (n, h+kh-1, w+kw-1) int32, K (kh, kw) int32, out (n, h, w) int32.
//
// Design: one thread per output pixel in 32x8 blocks, the frame index on
// grid z, so a batch of frames is one launch.  The TPU kernel's 8-row
// strips (and the row padding its wrapper adds) are a tiling artifact: here
// every thread masks its own ragged edge.  Taps and coefficients are read
// through the read-only cache; neighbouring threads read neighbouring
// columns, so each tap row is one coalesced load per warp.
//
// Bound on an H100: at CONVOLUTION 1080p (out 1088x1936, 8x8 taps) the
// kernel moves ~16.9 MB and does 1.35e8 int32 multiply-adds (one IMAD
// each), so it is bound by integer operations, not bytes.
//
// Exactness: the sum is accumulated in unsigned int, whose wrap is defined
// and equals int32 two's-complement wrap, the plain version's (torch)
// semantics.  The lowering's conv2d rule (_conv_guard) proves the sum stays
// below 2^31, so on the main path nothing wraps at all.  The shift is
// clamped at 31: an arithmetic shift by 31 or more yields the sign fill.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

__global__ void conv2d_kernel(int32_t* __restrict__ out,
                              const int32_t* __restrict__ p,
                              const int32_t* __restrict__ k,
                              int h, int w, int hp, int wp, int kh, int kw,
                              int shift) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= w || y >= h) return;
  const int32_t* plane = p + static_cast<size_t>(blockIdx.z) * hp * wp;
  unsigned acc = 0u;
  for (int dy = 0; dy < kh; ++dy) {
    const int32_t* row = plane + static_cast<size_t>(y + dy) * wp + x;
    const int32_t* krow = k + dy * kw;
    for (int dx = 0; dx < kw; ++dx) {
      acc += static_cast<unsigned>(__ldg(row + dx)) *
             static_cast<unsigned>(__ldg(krow + dx));
    }
  }
  const int s = shift < 31 ? shift : 31;
  out[static_cast<size_t>(blockIdx.z) * h * w + static_cast<size_t>(y) * w + x] =
      (static_cast<int>(acc) >> s) & 0xFF;
}

}  // namespace

extern "C" int conv2d_launch(void* out, const void* p, const void* k, int n,
                             int h, int w, int hp, int wp, int kh, int kw,
                             int shift, void* stream) {
  const dim3 block(kBlockX, kBlockY, 1);
  const dim3 grid((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY, n);
  conv2d_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(out), static_cast<const int32_t*>(p),
      static_cast<const int32_t*>(k), h, w, hp, wp, kh, kw, shift);
  return static_cast<int>(cudaGetLastError());
}
