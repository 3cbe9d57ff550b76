"""The card's own rate for the instruction K4's tensor-core forms issue:
``mma.sync.m16n8k16`` with bf16 operands and f32 accumulators.

    PYTHONPATH=src python -m repro_torch.launch.mma_probe [--iters 4096]

Each warp issues ``iters`` rounds of ACC independent products on register
operands (no memory traffic), so the products' issue rate alone bounds the
time; one block an SM, 4, 8 or 16 warps a block, ACC 4, 8 or 16.  Prints
one JSON object (TFLOP/s per layout, timed with CUDA events, the best of 5
launches after one warm-up), then the card's name and power limit.  The
probe is built from the text below through ``_build.generated_function``;
it is never on a path.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

from repro_torch.kernels import _build

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// out gets one sum a thread, so nothing is optimized away
template <int ACC>
__global__ void mma_probe_kernel(float* out, int iters) {
  const uint32_t t = threadIdx.x + 1;
  const uint32_t a[4] = {t * 0x3f803f80u, t ^ 0x3f003f00u, t, t * 7u};
  const uint32_t b0 = t * 0x3e803e80u, b1 = t + 0x3f803f80u;
  float c[ACC][4] = {};
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < ACC; ++j) mma_bf16(c[j], a, b0, b1);
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < ACC; ++j) sum += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

extern "C" int mma_probe_launch(float* out, int blocks, int threads,
                                int iters, int acc, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (acc == 4) mma_probe_kernel<4><<<blocks, threads, 0, st>>>(out, iters);
  else if (acc == 8)
    mma_probe_kernel<8><<<blocks, threads, 0, st>>>(out, iters);
  else if (acc == 16)
    mma_probe_kernel<16><<<blocks, threads, 0, st>>>(out, iters);
  else return int(cudaErrorInvalidValue);
  return int(cudaGetLastError());
}
"""

FLOPS_A_PRODUCT = 2 * 16 * 8 * 16


def probe(iters: int = 4096) -> list:
    """TFLOP/s of mma.sync alone for each (warps an SM, ACC)."""
    import torch
    fn = _build.generated_function(
        "mma_probe", SOURCE, "mma_probe_launch",
        (ctypes.c_void_p,) + (ctypes.c_int,) * 4 + (ctypes.c_void_p,))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 32 * 16, dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for warps in (4, 8, 16):
        for acc in (4, 8, 16):
            def run():
                _build.launch("mma_probe", fn, out.data_ptr(), sms,
                              32 * warps, iters, acc, stream)
            run()
            best = float("inf")
            for _ in range(5):
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
                run()
                end.record()
                end.synchronize()
                best = min(best, start.elapsed_time(end))
            flops = sms * warps * iters * acc * FLOPS_A_PRODUCT
            rows.append({"warps_an_sm": warps, "acc": acc, "ms": best,
                         "tflops": flops / best / 1e9})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=4096)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("mma_probe: needs a CUDA card")
    print(json.dumps({"mma_sync_bf16": probe(args.iters)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
