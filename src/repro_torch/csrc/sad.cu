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
// Bound on an H100: at STEREO 720x400, nd=64, 8x8 blocks the function
// moves ~3.7 MB (0.0011 ms at 3.35 TB/s), and its least work is a box
// filter per disparity: one |L-R| per (padded pixel, d), a sliding add and
// subtract across and down, one compare per (pixel, d): 1.117e8 int32
// operations, 0.00668 ms on 132 SMs x 64 INT32 lanes at 1980 MHz.  So it
// is bound by integer operations.
//
// Design: a box filter per disparity, with no barrier inside the
// disparity loop.  A block owns a tile of kRows = 16 output rows and
// kStrips * (33 - bw) columns (50 at bw = 8), and stages its L window and
// its R window (wider by the disparities of a chunk, nd - 1 at nd <= 64)
// in shared memory once.  Its 8 warps are kStrips column strips times
// kGroups disparity groups: lane j of a strip owns column j of the strip's
// 32 column sums.  For each d of its group, in ascending order, a lane
// slides its bh-row column sum of |L-R| down the tile's rows (add the row
// entering, subtract the row leaving), and the strip forms each row's
// bw-column sums with log2(bw) warp shuffles (lanes 0..32-bw hold an
// output); each output pixel keeps its running best with a strict <.  The
// groups' results then meet through a shared-memory atomicMin on the pair
// (sum, d) packed into 64 bits, which keeps the first minimum: the
// smaller sum wins, and of equal sums the smaller d.  Frames are on grid
// z, so a batch of frames is one launch.
//
// A second form takes the blocks the tiled form cannot (bw > 32, or
// windows too tall for shared memory): a block of 8 output rows by 256
// columns, one thread per column, reads L and R through the read-only
// cache.  For each d it forms the bh-row column sums of a chunk of 256
// columns by sliding down, each warp takes the running prefix sums of one
// row across the chunk, and each output is the difference of the prefix
// sums bw columns apart.  So the kernel takes any nd, bh and bw.
//
// Exactness: differences and sums are taken in unsigned int, whose wrap is
// defined and equals int32 two's-complement wrap (the plain version's
// semantics); addition mod 2^32 is associative, so the sliding, shuffled
// and prefix-difference sums equal the direct ones bit for bit; the
// absolute value negates in unsigned arithmetic, so even |INT_MIN| matches
// torch.abs.  The lowering's sad rule (_sad_guard) proves the sum stays
// below 2^31 on the main path.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kStrips = 2;    // column strips (one warp each) per group
constexpr int kGroups = 4;    // disparity groups per block
constexpr int kThreads = 32 * kStrips * kGroups;
constexpr int kRows = 16;     // output rows per block
constexpr int kChunk = 64;    // disparities per staged R window
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kSmemLimit = 232448;

// output columns of a block, and the shared bytes of its windows
__host__ __device__ inline int tile_cols(int bw) { return kStrips * (33 - bw); }

inline size_t smem_bytes(int bh, int bw) {
  const size_t rows = kRows + bh - 1;
  const size_t lw = tile_cols(bw) + bw - 1;
  return sizeof(long long) * kRows * tile_cols(bw) +
         sizeof(int32_t) * rows * (lw + lw + kChunk - 1);
}

__device__ __forceinline__ unsigned absdiff(int32_t a, int32_t b) {
  const unsigned d = static_cast<unsigned>(a) - static_cast<unsigned>(b);
  return static_cast<int>(d) < 0 ? 0u - d : d;
}

// The sum of this lane's and the next bw-1 lanes' column sums (valid on
// lanes 0..32-bw): prefix sums over 1, 2, 4, ... lanes by shuffles, added
// along the binary digits of bw.
template <int BW>
__device__ __forceinline__ unsigned row_sum(unsigned c, int bw_arg) {
  const int bw = BW ? BW : bw_arg;
  unsigned s = 0u, p = c;
  int off = 0;
#pragma unroll
  for (int m = 1; m <= 32; m *= 2) {
    if (bw & m) {
      s += off ? __shfl_down_sync(kFull, p, off) : p;
      off += m;
    }
    if (2 * m <= bw) p += __shfl_down_sync(kFull, p, m);
  }
  return s;
}

template <int BW>
__global__ void __launch_bounds__(kThreads)
sad_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ l,
           const int32_t* __restrict__ r, int h, int w, int hp, int wp,
           int nd, int bh, int bw_arg) {
  const int bw = BW ? BW : bw_arg;
  const int step = 33 - bw;                 // outputs per strip
  const int tw = kStrips * step;
  const int rows = kRows + bh - 1;
  const int lw = tw + bw - 1;               // staged L columns
  const int rw = lw + kChunk - 1;           // staged R columns
  extern __shared__ __align__(16) unsigned char smem[];
  long long* keys = reinterpret_cast<long long*>(smem);   // kRows x tw
  int32_t* ls = reinterpret_cast<int32_t*>(keys + kRows * tw);
  int32_t* rs = ls + rows * lw;
  const int y0 = blockIdx.y * kRows;
  const int x0 = blockIdx.x * tw;
  const size_t plane = static_cast<size_t>(blockIdx.z) * hp * wp;
  const int32_t* lp = l + plane;
  const int32_t* rp = r + plane;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int group = warp / kStrips;
  const int cx = (warp % kStrips) * step + lane;   // this lane's column

  for (int i = threadIdx.x; i < kRows * tw; i += kThreads) keys[i] = LLONG_MAX;
  for (int i = threadIdx.x; i < rows * lw; i += kThreads) {
    const int y = y0 + i / lw, x = x0 + nd - 1 + i % lw;
    ls[i] = (y < hp && x < wp) ? lp[static_cast<size_t>(y) * wp + x] : 0;
  }
  int best[kRows], best_d[kRows];
#pragma unroll
  for (int y = 0; y < kRows; ++y) {
    best[y] = INT_MAX;
    best_d[y] = 0;
  }
  for (int d0 = 0; d0 < nd; d0 += kChunk) {
    __syncthreads();                        // the last chunk is read
    for (int i = threadIdx.x; i < rows * rw; i += kThreads) {
      const int y = y0 + i / rw, x = x0 + d0 + i % rw;
      rs[i] = (y < hp && x < wp) ? rp[static_cast<size_t>(y) * wp + x] : 0;
    }
    __syncthreads();
    const int n_d = min(kChunk, nd - d0);
    const int32_t* lc = ls + cx;
    for (int dd = group * n_d / kGroups; dd < (group + 1) * n_d / kGroups;
         ++dd) {
      const int32_t* rc = rs + cx + dd;
      unsigned acc = 0u;
      for (int k = 0; k < bh - 1; ++k) acc += absdiff(lc[k * lw], rc[k * rw]);
#pragma unroll
      for (int y = 0; y < kRows; ++y) {
        const int k = y + bh - 1;
        acc += absdiff(lc[k * lw], rc[k * rw]);
        const int a = static_cast<int>(row_sum<BW>(acc, bw));
        if (a < best[y]) {
          best[y] = a;
          best_d[y] = d0 + dd;
        }
        acc -= absdiff(lc[y * lw], rc[y * rw]);
      }
    }
  }
  if (lane < step && x0 + cx < w) {
#pragma unroll
    for (int y = 0; y < kRows; ++y) {
      if (y0 + y < h) {
        const unsigned long long key =
            (static_cast<unsigned long long>(static_cast<long long>(best[y]))
             << 32) | static_cast<unsigned>(best_d[y]);
        atomicMin(&keys[y * tw + cx], static_cast<long long>(key));
      }
    }
  }
  __syncthreads();
  int32_t* op = out + static_cast<size_t>(blockIdx.z) * h * w;
  for (int i = threadIdx.x; i < kRows * tw; i += kThreads) {
    const int y = y0 + i / tw, x = x0 + i % tw;
    if (y < h && x < w)
      op[static_cast<size_t>(y) * w + x] = static_cast<int32_t>(keys[i] & 0xffffffffLL);
  }
}

template <int BW>
int launch(int32_t* out, const int32_t* l, const int32_t* r, int n, int h,
           int w, int hp, int wp, int nd, int bh, int bw,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(bh, bw);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sad_kernel<BW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tw = tile_cols(bw);
  const dim3 grid((w + tw - 1) / tw, (h + kRows - 1) / kRows, n);
  sad_kernel<BW><<<grid, kThreads, smem, stream>>>(out, l, r, h, w, hp, wp,
                                                   nd, bh, bw);
  return static_cast<int>(cudaGetLastError());
}


// ---- the general form: any bw and bh ----

constexpr int kWRows = kThreads / 32;   // output rows per block, a warp each
constexpr int kWCols = kThreads;        // output columns, a thread each

__device__ __forceinline__ unsigned tap(const int32_t* lp, const int32_t* rp,
                                        int y, int hp, int wp, int xl,
                                        int xr) {
  if (y >= hp) return 0u;
  const size_t row = static_cast<size_t>(y) * wp;
  return absdiff(xl < wp ? __ldg(lp + row + xl) : 0,
                 xr < wp ? __ldg(rp + row + xr) : 0);
}

__global__ void __launch_bounds__(kThreads)
sad_wide_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ l,
                const int32_t* __restrict__ r, int h, int w, int hp, int wp,
                int nd, int bh, int bw) {
  __shared__ unsigned cs[kWRows][kThreads];   // a chunk's column sums
  __shared__ unsigned lo[kWRows][kWCols];     // row prefix sums at x
  __shared__ unsigned hi[kWRows][kWCols];     // and at x + bw
  const int y0 = blockIdx.y * kWRows;
  const int x0 = blockIdx.x * kWCols;
  const size_t plane = static_cast<size_t>(blockIdx.z) * hp * wp;
  const int32_t* lp = l + plane;
  const int32_t* rp = r + plane;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int span = kWCols + bw - 1;           // column sums of the tile
  if (t < kWRows) lo[t][0] = 0u;              // the empty prefix
  int best[kWRows], best_d[kWRows];
#pragma unroll
  for (int y = 0; y < kWRows; ++y) {
    best[y] = INT_MAX;
    best_d[y] = 0;
  }
  for (int d = 0; d < nd; ++d) {
    unsigned carry = 0u;                      // row `warp`'s prefix so far
    for (int c0 = 0; c0 < span; c0 += kThreads) {
      const int xl = x0 + c0 + t + nd - 1, xr = x0 + c0 + t + d;
      unsigned acc = 0u;
      for (int k = 0; k < bh - 1; ++k)
        acc += tap(lp, rp, y0 + k, hp, wp, xl, xr);
#pragma unroll
      for (int y = 0; y < kWRows; ++y) {
        acc += tap(lp, rp, y0 + y + bh - 1, hp, wp, xl, xr);
        cs[y][t] = acc;
        acc -= tap(lp, rp, y0 + y, hp, wp, xl, xr);
      }
      __syncthreads();
      // prefix sums of row `warp` over the chunk, 8 columns a lane
      unsigned v[8], run = 0u;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        run += cs[warp][lane * 8 + i];
        v[i] = run;
      }
      unsigned incl = run;
#pragma unroll
      for (int o = 1; o < 32; o *= 2) {
        const unsigned u = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += u;
      }
      const unsigned base = carry + incl - run;
      carry += __shfl_sync(kFull, incl, 31);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int k = c0 + lane * 8 + i + 1;  // the sum of columns < k
        if (k < kWCols) lo[warp][k] = base + v[i];
        if (k >= bw && k - bw < kWCols) hi[warp][k - bw] = base + v[i];
      }
      __syncthreads();
    }
#pragma unroll
    for (int y = 0; y < kWRows; ++y) {
      const int a = static_cast<int>(hi[y][t] - lo[y][t]);
      if (a < best[y]) {
        best[y] = a;
        best_d[y] = d;
      }
    }
  }
  int32_t* op = out + static_cast<size_t>(blockIdx.z) * h * w;
#pragma unroll
  for (int y = 0; y < kWRows; ++y)
    if (y0 + y < h && x0 + t < w)
      op[static_cast<size_t>(y0 + y) * w + x0 + t] = best_d[y];
}

}  // namespace

extern "C" int sad_launch(void* out, const void* l, const void* r, int n,
                          int h, int w, int hp, int wp, int nd, int bh, int bw,
                          void* stream) {
  auto* o = static_cast<int32_t*>(out);
  auto* lp = static_cast<const int32_t*>(l);
  auto* rp = static_cast<const int32_t*>(r);
  auto* s = static_cast<cudaStream_t>(stream);
  if (bw > 32 || smem_bytes(bh, bw) > kSmemLimit) {
    const dim3 grid((w + kWCols - 1) / kWCols, (h + kWRows - 1) / kWRows, n);
    sad_wide_kernel<<<grid, kThreads, 0, s>>>(o, lp, rp, h, w, hp, wp, nd,
                                              bh, bw);
    return static_cast<int>(cudaGetLastError());
  }
  // the 8-column box of the main path as its own instance, its shuffles
  // and loop bounds constant
  return bw == 8 ? launch<8>(o, lp, rp, n, h, w, hp, wp, nd, bh, bw, s)
                 : launch<0>(o, lp, rp, n, h, w, hp, wp, nd, bh, bw, s);
}
