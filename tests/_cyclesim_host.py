"""The cycle kernel's CUDA source (``csrc/cyclesim.cu``) built with g++ as
host C++ and run on CPU tensors: each thread of a block is a host thread,
and the warp intrinsics and barriers meet at a ``std::barrier`` of the
block (every one of them is reached by the whole block in the kernel), so
the source's own index arithmetic, rings, votes and jumps run on the host
as they do on the card.  ``host_cycle_sim`` runs ``ops.run_kernel``
through it, in either form.  The card runs the rest
(``tests/test_torch_card.py``).
"""
from __future__ import annotations

import ctypes
import hashlib
import shutil
import subprocess
import textwrap
from pathlib import Path

from repro_torch.kernels import _build
from repro_torch.kernels.cyclesim import ops

SHIM = textwrap.dedent(r"""
    #pragma once
    #include <algorithm>
    #include <barrier>
    #include <cstring>
    #include <mutex>
    #include <thread>
    #include <vector>
    typedef void* cudaStream_t;
    typedef int cudaError_t;
    enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
    enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
    struct cyc_dim3 { unsigned x, y, z; };
    inline thread_local cyc_dim3 threadIdx;
    inline cyc_dim3 blockIdx, blockDim;
    inline int cyc_host_err = 0;
    #define __global__
    #define __device__
    #define __forceinline__ inline
    #define __launch_bounds__(...)
    #define __align__(n) alignas(n)
    #define __restrict__
    alignas(16) inline unsigned char cyc_host_smem[1 << 18];
    template <class T> T min(T a, T b) { return b < a ? b : a; }
    template <class T> T max(T a, T b) { return a < b ? b : a; }
    template <class T> T __ldg(const T* p) { return *p; }
    inline int __ffsll(long long x) { return __builtin_ffsll(x); }
    inline int __popcll(unsigned long long x) {
      return __builtin_popcountll(x);
    }
    template <class T>
    cudaError_t cudaFuncSetAttribute(T, cudaFuncAttribute, int) {
      return cudaSuccess;
    }
    inline cudaError_t cudaGetLastError() {
      const int e = cyc_host_err;
      cyc_host_err = 0;
      return e;
    }
    // the block's meeting point: each thread posts a value, all meet, each
    // combines its warp's (or the block's) values, all meet again
    struct CycBlock {
      std::barrier<>* bar;
      unsigned long long slot[1024];
      std::mutex mu;
    };
    inline CycBlock* cyc_blk;
    inline void __syncthreads() { cyc_blk->bar->arrive_and_wait(); }
    inline void __syncwarp(unsigned = 0) { __syncthreads(); }
    template <class F>
    unsigned long long cyc_meet(unsigned long long v, bool block, F f,
                                unsigned long long init) {
      const unsigned me = threadIdx.x;
      cyc_blk->slot[me] = v;
      __syncthreads();
      const unsigned lo = block ? 0 : me & ~31u;
      const unsigned hi = block ? blockDim.x
                                : std::min(lo + 32, blockDim.x);
      unsigned long long r = init;
      for (unsigned i = lo; i < hi; ++i) r = f(r, cyc_blk->slot[i], i - lo);
      __syncthreads();
      return r;
    }
    inline unsigned __ballot_sync(unsigned, int p) {
      return (unsigned)cyc_meet(p != 0, false,
          [](unsigned long long r, unsigned long long v, unsigned i) {
            return r | (v << i); }, 0);
    }
    inline int __any_sync(unsigned m, int p) {
      return __ballot_sync(m, p) != 0;
    }
    inline unsigned __reduce_min_sync(unsigned, unsigned v) {
      return (unsigned)cyc_meet(v, false,
          [](unsigned long long r, unsigned long long x, unsigned) {
            return std::min(r, x); }, 0xffffffffull);
    }
    inline int __syncthreads_or(int p) {
      return (int)cyc_meet(p != 0, true,
          [](unsigned long long r, unsigned long long v, unsigned) {
            return r | v; }, 0);
    }
    inline int atomicOr(int* a, int v) {
      std::lock_guard<std::mutex> g(cyc_blk->mu);
      const int old = *a;
      *a = old | v;
      return old;
    }
    inline unsigned long long atomicMin(unsigned long long* a,
                                        unsigned long long v) {
      std::lock_guard<std::mutex> g(cyc_blk->mu);
      const unsigned long long old = *a;
      *a = std::min(old, v);
      return old;
    }
    template <class F>
    void cyc_host_launch(unsigned grid, unsigned block, size_t smem, F f) {
      if (smem > sizeof(cyc_host_smem) || block > 1024) {
        cyc_host_err = 1;
        return;
      }
      for (unsigned b = 0; b < grid; ++b) {
        std::memset(cyc_host_smem, 0xa5, sizeof(cyc_host_smem));
        blockIdx = {b, 0, 0};
        blockDim = {block, 1, 1};
        std::barrier<> bar((std::ptrdiff_t)block);
        CycBlock blk;
        blk.bar = &bar;
        cyc_blk = &blk;
        std::vector<std::thread> ts;
        for (unsigned i = 0; i < block; ++i)
          ts.emplace_back([&f, i] { threadIdx = {i, 0, 0}; f(); });
        for (auto& t : ts) t.join();
      }
    }
    #define CYC_LAUNCH(kern, grid, block, smem, stream, ...) \
      cyc_host_launch(grid, block, smem, [&] { kern(__VA_ARGS__); })
""")

_SMEM_DECL = "extern __shared__ __align__(16) unsigned char cyc_smem[];"


def available() -> bool:
    return shutil.which("g++") is not None


def build(workdir: Path):
    """The host library of ``csrc/cyclesim.cu`` (cached in ``workdir``
    by the source's digest); its ``cyclesim_launch`` with argument types
    set."""
    text = (_build.CSRC / "cyclesim.cu").read_text()
    if text.count(_SMEM_DECL) != 2:
        raise AssertionError("the kernel's shared-memory declarations "
                             "changed; update the host shim")
    text = text.replace(_SMEM_DECL,
                        "unsigned char* cyc_smem = cyc_host_smem;")
    (workdir / "cuda_runtime.h").write_text(SHIM)
    digest = hashlib.sha256((SHIM + text).encode()).hexdigest()[:16]
    lib = workdir / f"cyclesim-{digest}.so"
    if not lib.exists():
        src = lib.with_suffix(".cpp")
        src.write_text(text)
        subprocess.run(
            ["g++", "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC",
             "-Wno-unused-variable", "-I", str(workdir), "-I",
             str(_build.CSRC), "-o", str(lib), str(src)],
            check=True, capture_output=True, text=True, timeout=600)
    fn = ctypes.CDLL(str(lib)).cyclesim_launch
    fn.argtypes = list(ops._ARGTYPES)
    fn.restype = ctypes.c_int
    return fn


def host_cycle_sim(fn, sim, caps, horizon, stall_limit, event_jump=True,
                   form=None):
    """``ops.run_kernel`` on CPU ``caps`` through the host build ``fn``."""
    return ops.run_kernel(sim, caps, horizon, stall_limit, event_jump,
                          form=form, launcher=fn)
