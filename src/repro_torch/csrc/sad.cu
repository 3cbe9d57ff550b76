// K2: SAD block matching, argmin over disparities (STEREO).
//
// Replaces the TPU kernel src/repro/kernels/sad/kernel.py::_sad_kernel
// (launched by sad_strips, wrappers sad_disparity / sad_hwimg_site).
//
//   sad[d]       = sum_{dy<bh, dx<bw} |L[n, y+dy, x+dx+nd-1] - R[n, y+dy, x+dx+d]|
//   out[n, y, x] = argmin_d sad[d], the FIRST minimum winning (strict <)
//
// L, R (n, h+bh-1, w+bw-1+nd-1) int32, out (n, h, w) int32.
//
// Design: one thread per output pixel in 32x8 blocks, the frame index on
// grid z, so a batch of frames is one launch.  Each thread walks d in
// 0..nd-1 and the bh x bw taps and keeps the running best with a strict <,
// exactly the TPU kernel's tie rule.  No box sums are reused across
// disparities: a later kernel that reuses them must keep that tie rule.
//
// Bound on an H100: at STEREO 720x400, nd=64, 8x8 blocks the function moves
// ~3.7 MB, and its least work is a box filter per disparity: one |L-R| per
// (padded pixel, d), a sliding add and subtract across and down, and one
// compare per (pixel, d), about 1.1e8 int32 operations.  So it is bound by
// integer operations.  This kernel sums every block directly, 1.18e9
// absolute-difference accumulations, about ten times that least work.
//
// Exactness: differences and sums are taken in unsigned int, whose wrap is
// defined and equals int32 two's-complement wrap (the plain version's
// semantics); the absolute value negates in unsigned arithmetic, so even
// |INT_MIN| matches torch.abs.  The lowering's sad rule (_sad_guard) proves
// the sum stays below 2^31 on the main path.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

__global__ void sad_kernel(int32_t* __restrict__ out,
                           const int32_t* __restrict__ l,
                           const int32_t* __restrict__ r,
                           int h, int w, int hp, int wp, int nd, int bh,
                           int bw) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t plane = static_cast<size_t>(blockIdx.z) * hp * wp;
  const int32_t* lp = l + plane + static_cast<size_t>(y) * wp + x + nd - 1;
  const int32_t* rp = r + plane + static_cast<size_t>(y) * wp + x;
  int best = INT_MAX;
  int best_d = 0;
  for (int d = 0; d < nd; ++d) {
    unsigned acc = 0u;
    for (int dy = 0; dy < bh; ++dy) {
      const int32_t* lrow = lp + static_cast<size_t>(dy) * wp;
      const int32_t* rrow = rp + static_cast<size_t>(dy) * wp + d;
      for (int dx = 0; dx < bw; ++dx) {
        const unsigned diff = static_cast<unsigned>(__ldg(lrow + dx)) -
                              static_cast<unsigned>(__ldg(rrow + dx));
        acc += static_cast<int>(diff) < 0 ? 0u - diff : diff;
      }
    }
    const int a = static_cast<int>(acc);
    if (a < best) {
      best = a;
      best_d = d;
    }
  }
  out[static_cast<size_t>(blockIdx.z) * h * w + static_cast<size_t>(y) * w + x] =
      best_d;
}

}  // namespace

extern "C" int sad_launch(void* out, const void* l, const void* r, int n,
                          int h, int w, int hp, int wp, int nd, int bh, int bw,
                          void* stream) {
  const dim3 block(kBlockX, kBlockY, 1);
  const dim3 grid((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY, n);
  sad_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(out), static_cast<const int32_t*>(l),
      static_cast<const int32_t*>(r), h, w, hp, wp, nd, bh, bw);
  return static_cast<int>(cudaGetLastError());
}
