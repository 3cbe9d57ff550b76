// Helpers of the generated megakernels (K3).
//
// core/lowering/megakernel.py writes one CUDA C++ kernel per fused schedule
// segment; every such source includes this header.  These are the CUDA
// side of the window plumbing in kernels/stream.py and of the port's
// LOWERERS semantics:
//
//   - floor division and the minimum of window offsets, in int (Upsample's
//     demand floors offsets that go negative at the frame's top and left
//     edges; C++ `/` truncates toward zero);
//   - the wrap masks of torch_mask on the int64 carrier (unsigned widths
//     mask, signed widths mask and sign-extend);
//   - integer arithmetic in unsigned long long, cast back: signed overflow
//     is undefined in CUDA C++, while the carrier wraps;
//   - the float point functions, each one IEEE operation rounded to
//     nearest (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn,
//     __ll2float_rn), with FloatDiv's b == 0 -> 0 rule and FloatSqrt's
//     clamp at 0; FloatDiv by an integer and FloatSqrt of an integer in
//     double (__ddiv_rn, __dsqrt_rn), rounded once to float, as numpy
//     computes them.  Generated sources build with -fmad=false as well.
//
// Reads outside a node's frame are zero-filled by the generated code
// itself, which knows each node's frame size.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

typedef unsigned long long mk_u64;

// ---- tile geometry: window offsets and coordinates are int ---------------

__device__ __forceinline__ int mk_floordiv(int a, int b) {
  // b > 0
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ int mk_min(int a, int b) { return a < b ? a : b; }

// ---- wrap masks (torch_mask), widths of at most 62 bits -------------------

__device__ __forceinline__ long long mk_mask_u(long long v, int bits) {
  return static_cast<long long>(static_cast<mk_u64>(v) &
                                ((1ULL << bits) - 1ULL));
}

__device__ __forceinline__ long long mk_mask_s(long long v, int bits) {
  return static_cast<long long>(static_cast<mk_u64>(v) << (64 - bits)) >>
         (64 - bits);
}

// ---- integer point functions on the int64 carrier -------------------------

__device__ __forceinline__ long long mk_add(long long a, long long b) {
  return static_cast<long long>(static_cast<mk_u64>(a) +
                                static_cast<mk_u64>(b));
}

__device__ __forceinline__ long long mk_sub(long long a, long long b) {
  return static_cast<long long>(static_cast<mk_u64>(a) -
                                static_cast<mk_u64>(b));
}

__device__ __forceinline__ long long mk_mul(long long a, long long b) {
  return static_cast<long long>(static_cast<mk_u64>(a) *
                                static_cast<mk_u64>(b));
}

__device__ __forceinline__ long long mk_abs(long long a) {
  // |INT64_MIN| wraps to itself, as torch.abs does
  return a < 0 ? static_cast<long long>(0ULL - static_cast<mk_u64>(a)) : a;
}

__device__ __forceinline__ long long mk_max(long long a, long long b) {
  return a > b ? a : b;
}

__device__ __forceinline__ float mk_fmax(float a, float b) {
  // torch.maximum propagates NaN
  return (a != a || b != b) ? (a != a ? a : b) : (a > b ? a : b);
}

__device__ __forceinline__ float mk_fmin(float a, float b) {
  return (a != a || b != b) ? (a != a ? a : b) : (a < b ? a : b);
}

// ---- float point functions ------------------------------------------------

__device__ __forceinline__ float mk_f32(long long a) {
  return __ll2float_rn(a);
}
__device__ __forceinline__ float mk_f32(float a) { return a; }
__device__ __forceinline__ float mk_f32(bool a) { return a ? 1.0f : 0.0f; }

template <class A, class B>
__device__ __forceinline__ float mk_fdiv(A a, B b) {
  return b != static_cast<B>(0) ? __fdiv_rn(mk_f32(a), mk_f32(b)) : 0.0f;
}

// an integer divisor: numpy divides float32(a) by it in double, and the
// quotient is rounded once to float (a divisor above 2^24 would lose bits
// in float)
template <class A>
__device__ __forceinline__ float mk_fdiv(A a, long long b) {
  return b != 0LL ? __double2float_rn(__ddiv_rn(
                        static_cast<double>(mk_f32(a)), __ll2double_rn(b)))
                  : 0.0f;
}

template <class A>
__device__ __forceinline__ float mk_fsqrt(A a) {
  // np.maximum(a, 0): -0.0 becomes +0.0, NaN stays NaN
  const float x = mk_f32(a);
  return __fsqrt_rn(x <= 0.0f ? 0.0f : x);
}

// an integer radicand: numpy takes its root in double straight from the
// integer, then it is rounded once to float
__device__ __forceinline__ float mk_fsqrt(long long a) {
  return __double2float_rn(__dsqrt_rn(__ll2double_rn(a < 0LL ? 0LL : a)));
}
