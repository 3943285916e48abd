// Shared device helpers of the port's kernels: element conversion for the
// two input types (float32, bfloat16), vector loads and stores, warp-group
// sums and maxima by butterfly shuffles, and the box-cut bisection over
// one row: held in registers across a group of lanes (rows up to 1,024
// wide), in strided columns (`boxcut_tau`, K5) or in contiguous chunks
// with an exact early exit (`boxcut_tau_chunk`, K1 and K3), or held in
// shared or global memory across a block (any width).
//
// Every sum here runs in a fixed order (sequential within a lane, then
// xor-butterfly across lanes), so results are bit-reproducible from run to
// run.  No atomics anywhere.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

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

// One load of a streamed (read once, evict first: `__ldcs`) or gathered
// (read-only path: `__ldg`) value.
template <bool kStream, typename T>
__device__ __forceinline__ T ld(const T* p) {
  if constexpr (kStream)
    return __ldcs(p);
  else
    return __ldg(p);
}

// The width in bytes of the vector loads and stores of N values of T: as
// wide as N·sizeof(T) allows, up to 16.  A pointer they touch must be
// aligned to it.
template <typename T, int N>
__host__ __device__ constexpr int vec_bytes() {
  constexpr int kBytes = N * (int)sizeof(T);
  return kBytes % 16 == 0 ? 16
         : kBytes % 8 == 0 ? 8
         : kBytes % 4 == 0 ? 4
         : kBytes % 2 == 0 ? 2 : 1;
}

// N values of T from p to v by vector loads of `vec_bytes<T, N>()` bytes.
template <bool kStream, typename T, int N>
__device__ __forceinline__ void ld_vec_n(const T* p, T* v) {
  constexpr int kBytes = N * (int)sizeof(T);
  constexpr int kVec = vec_bytes<T, N>();
  const char* s = reinterpret_cast<const char*>(p);
  char* d = reinterpret_cast<char*>(v);
#pragma unroll
  for (int i = 0; i < kBytes / kVec; ++i) {
    if constexpr (kVec == 16) {
      const uint4 u = ld<kStream>(reinterpret_cast<const uint4*>(s) + i);
      memcpy(d + 16 * i, &u, 16);
    } else if constexpr (kVec == 8) {
      const uint2 u = ld<kStream>(reinterpret_cast<const uint2*>(s) + i);
      memcpy(d + 8 * i, &u, 8);
    } else if constexpr (kVec == 4) {
      const unsigned u = ld<kStream>(reinterpret_cast<const unsigned*>(s) + i);
      memcpy(d + 4 * i, &u, 4);
    } else if constexpr (kVec == 2) {
      const unsigned short u =
          ld<kStream>(reinterpret_cast<const unsigned short*>(s) + i);
      memcpy(d + 2 * i, &u, 2);
    } else {
      const unsigned char u =
          ld<kStream>(reinterpret_cast<const unsigned char*>(s) + i);
      memcpy(d + i, &u, 1);
    }
  }
}

template <bool kStream, typename T, int N>
__device__ __forceinline__ void ld_vec(const T* p, T (&v)[N]) {
  ld_vec_n<kStream, T, N>(p, v);
}

// N values of T from v to p by streaming vector stores (`__stcs`: written
// once, not read back by this kernel) of `vec_bytes<T, N>()` bytes.
template <typename T, int N>
__device__ __forceinline__ void st_vec_n(T* p, const T* v) {
  constexpr int kBytes = N * (int)sizeof(T);
  constexpr int kVec = vec_bytes<T, N>();
  char* d = reinterpret_cast<char*>(p);
  const char* s = reinterpret_cast<const char*>(v);
#pragma unroll
  for (int i = 0; i < kBytes / kVec; ++i) {
    if constexpr (kVec == 16) {
      uint4 u;
      memcpy(&u, s + 16 * i, 16);
      __stcs(reinterpret_cast<uint4*>(d) + i, u);
    } else if constexpr (kVec == 8) {
      uint2 u;
      memcpy(&u, s + 8 * i, 8);
      __stcs(reinterpret_cast<uint2*>(d) + i, u);
    } else if constexpr (kVec == 4) {
      unsigned u;
      memcpy(&u, s + 4 * i, 4);
      __stcs(reinterpret_cast<unsigned*>(d) + i, u);
    } else {
      static_assert(kVec == 2, "stores of at least 2 bytes");
      unsigned short u;
      memcpy(&u, s + 2 * i, 2);
      __stcs(reinterpret_cast<unsigned short*>(d) + i, u);
    }
  }
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

// Threshold τ of one row held in contiguous chunks: lane l of a group of
// L lanes holds columns [l·VPT, (l+1)·VPT) of the row.  The function of
// `boxcut_tau`, with the row sums taken in this layout's order (in order
// within a lane's chunk, then the xor butterfly over the L lanes), and a
// loop that stops once its result is fixed:
//   - a row whose f0 <= s skips the loop (τ = 0, as after any count);
//   - a row is done after the step in which mid == lo or mid == hi, once
//     that step's update is applied: the bracket either did not move or
//     collapsed onto mid, and 0.5·(mid + mid) == mid (mid = 0.5·(lo + hi)
//     is at most half the largest float, so mid + mid does not overflow).
//     From then on every step recomputes the same mid, f(mid) and update,
//     so τ equals the `iters`-step result bit for bit.  fmaxf and fminf
//     drop a NaN entry of v (it adds 0, as padding does), so lo, hi and
//     mid stay numbers.
// The warp loops while any of its groups is not done; done groups keep
// their bracket and stay in the full-mask shuffles.  Entries a row does
// not own (padding, columns past its width) carry v = kNeg and ub = 0,
// which add exactly +0 to every f(·), so the loop needs no mask.  `iters`
// stays the cap.  `ref.bisect_lanes_ref` repeats this in plain torch.
template <int L, int VPT>
__device__ __forceinline__ float boxcut_tau_chunk(const float (&v)[VPT],
                                                  const float (&ub)[VPT],
                                                  float s, int iters) {
  float f0 = 0.0f, hi = kNeg;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    f0 += clip0(v[i], ub[i]);
    hi = fmaxf(hi, v[i]);
  }
  f0 = group_sum<L>(f0);
  hi = group_max<L>(hi);
  const bool need = f0 > s;
  float lo = fminf(0.0f, hi);
  bool done = !need;
#pragma unroll 1
  for (int it = 0; it < iters && __any_sync(0xffffffffu, !done); ++it) {
    const float mid = 0.5f * (lo + hi);
    float f = 0.0f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) f += clip0(v[i] - mid, ub[i]);
    f = group_sum<L>(f);
    const bool big = f > s;
    if (!done) {
      done = mid == lo || mid == hi;
      lo = big ? mid : lo;
      hi = big ? hi : mid;
    }
  }
  return need ? 0.5f * (lo + hi) : 0.0f;
}

// K5's register-path layout of a row of width w <= kNarrowMaxWidth: lanes
// a row (32 for w >= 32, else the next power of two of w) and values a
// lane (a power of two), the lanes striding over the row.
inline int lanes_for(int w) {
  int L = 1;
  while (L < w && L < 32) L <<= 1;
  return L;
}

inline int vpt_for(int w) {
  int vpt = 1;
  while (vpt * 32 < w) vpt <<= 1;
  return vpt;
}

// ---- Rows wider than one warp's registers hold: one block a row --------
//
// Threads a block on the wide path, and the widest row kept in dynamic
// shared memory (v and ub, 8 bytes an entry: 128 KB of the 227 KB a block
// may opt in to).  Wider rows live in a global scratch row instead.
constexpr int kWideThreads = 256;
constexpr int kWideSmemMaxWidth = 16384;
constexpr int kNarrowMaxWidth = 32 * 32;  // the register path's widest row

// Sum / max over the block, in a fixed order: each warp's butterfly, then
// the kWideThreads/32 warp results in warp order.  Every thread gets the
// result.  `red` is kWideThreads/32 floats of shared memory; all threads
// must call these together.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = group_sum<32>(v);
  __syncthreads();  // the previous call's readers are done with `red`
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.0f;
#pragma unroll
  for (int i = 0; i < kWideThreads / 32; ++i) t += red[i];
  return t;
}

__device__ __forceinline__ float block_max(float v, float* red) {
  v = group_max<32>(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = kNeg;
#pragma unroll
  for (int i = 0; i < kWideThreads / 32; ++i) t = fmaxf(t, red[i]);
  return t;
}

// `boxcut_tau` for one row of any width held in memory (shared or global),
// spread over the kWideThreads threads of a block: thread t owns entries
// t, t + kWideThreads, ...  Entries the row does not own hold v = kNeg and
// ub = 0, which add exactly 0 to every f(·) (clip0(kNeg − mid, 0) = 0),
// so no mask is needed.  Same arithmetic as `boxcut_tau`; only the order
// of the row sums differs.  Each thread reads only the entries it wrote.
__device__ __forceinline__ float boxcut_tau_row(const float* v,
                                                const float* ub, int w,
                                                float s, int iters,
                                                float* red) {
  float f0 = 0.0f, hi = kNeg;
  for (int i = threadIdx.x; i < w; i += kWideThreads) {
    f0 += clip0(v[i], ub[i]);
    hi = fmaxf(hi, v[i]);
  }
  f0 = block_sum(f0, red);
  hi = block_max(hi, red);
  const bool need = f0 > s;
  float lo = fminf(0.0f, hi);
  for (int it = 0; it < iters; ++it) {
    const float mid = 0.5f * (lo + hi);
    float f = 0.0f;
    for (int i = threadIdx.x; i < w; i += kWideThreads)
      f += clip0(v[i] - mid, ub[i]);
    f = block_sum(f, red);
    const bool big = f > s;
    lo = big ? mid : lo;
    hi = big ? hi : mid;
  }
  return need ? 0.5f * (lo + hi) : 0.0f;
}

// Where a wide row's v and ub live: dynamic shared memory up to
// kWideSmemMaxWidth, else 2·w floats of global scratch a row.
__host__ __device__ inline bool wide_in_smem(int w) {
  return w <= kWideSmemMaxWidth;
}

// Opt the wide kernel `fn` in to the dynamic shared memory a row of width
// w needs; returns the bytes to launch with.
template <typename F>
inline size_t wide_smem_bytes(F fn, int w) {
  if (!wide_in_smem(w)) return 0;
  const size_t bytes = 2 * sizeof(float) * (size_t)w;
  if (bytes > 48 * 1024)
    cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
  return bytes;
}

}  // namespace repro_torch
