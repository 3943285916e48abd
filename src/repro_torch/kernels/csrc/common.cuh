// Shared device helpers of the port's kernels: element conversion for the
// two input types (float32, bfloat16), warp-group sums and maxima by
// butterfly shuffles, and the box-cut bisection over one row held in
// registers across a group of lanes.
//
// Every sum here runs in a fixed order (sequential within a lane, then
// xor-butterfly across lanes), so results are bit-reproducible from run to
// run.  No atomics anywhere.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

// Effective -inf that stays finite in float32 arithmetic (the reference's
// `-1e30` fill for masked entries).
constexpr float kNeg = -1e30f;

// Input type codes shared with the Python wrappers.
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Product rounded to the input type, as the reference forms a ⊙ x.
__device__ __forceinline__ float mul_in_type(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float mul_in_type(__nv_bfloat16 a,
                                             __nv_bfloat16 b) {
  return __bfloat162float(__hmul(a, b));
}

// Sum / max over aligned groups of L lanes (L a power of two <= 32).  All
// 32 lanes of the warp must call these together.
template <int L>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int L>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// clip(v, 0, ub) as the reference computes it: min(max(v, 0), ub).
__device__ __forceinline__ float clip0(float v, float ub) {
  return fminf(fmaxf(v, 0.0f), ub);
}

// Threshold τ of the projection of one row onto {0 <= x <= ub, Σx <= s}.
//
// The row is spread over a group of L lanes, VPT values a lane; entries
// the row does not own (padding, or columns past its width) carry
// v = kNeg and mk = false.  `iters` bisection steps, the reference's
// arithmetic literally:
//   f0 = Σ mask·clip(v, 0, ub);  need = f0 > s
//   hi = max v;  lo = min(0, hi)
//   repeat: mid = 0.5(lo+hi); big = f(mid) > s; lo = big ? mid : lo;
//           hi = big ? hi : mid
//   τ = need ? 0.5(lo+hi) : 0
// Then x = mask ? clip(v − τ, 0, ub) : 0.
template <int L, int VPT>
__device__ __forceinline__ float boxcut_tau(const float (&v)[VPT],
                                            const float (&ub)[VPT],
                                            const bool (&mk)[VPT], float s,
                                            int iters) {
  float f0 = 0.0f, hi = kNeg;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    f0 += mk[i] ? clip0(v[i], ub[i]) : 0.0f;
    hi = fmaxf(hi, v[i]);
  }
  f0 = group_sum<L>(f0);
  hi = group_max<L>(hi);
  const bool need = f0 > s;
  float lo = fminf(0.0f, hi);
  for (int it = 0; it < iters; ++it) {
    const float mid = 0.5f * (lo + hi);
    float f = 0.0f;
#pragma unroll
    for (int i = 0; i < VPT; ++i)
      f += mk[i] ? clip0(v[i] - mid, ub[i]) : 0.0f;
    f = group_sum<L>(f);
    const bool big = f > s;
    lo = big ? mid : lo;
    hi = big ? hi : mid;
  }
  return need ? 0.5f * (lo + hi) : 0.0f;
}

}  // namespace repro_torch
