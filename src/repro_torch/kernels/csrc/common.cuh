// Shared device helpers of the port's kernels: element conversion for the
// two input types (float32, bfloat16), vector loads and stores, warp-group
// sums and maxima by butterfly shuffles, and the box-cut bisection that
// K1, K3 and K5 share: a row in contiguous chunks with an exact early
// exit, held in registers across a group of lanes (rows up to 1,024 wide,
// `boxcut_tau_chunk`) or across a block (wider rows, `boxcut_tau_block`,
// in registers or staged in shared or global memory).
//
// Every sum here runs in a fixed order (sequential within a chunk, then
// xor-butterfly across lanes, then warps in order), so results are
// bit-reproducible from run to run.  No atomics anywhere.
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

// Threshold τ of the projection of one row onto {0 <= x <= ub, Σx <= s},
// the reference's τ-bisection of at most `iters` steps:
//   f0 = Σ clip(v, 0, ub);  need = f0 > s
//   hi = max v;  lo = min(0, hi)
//   repeat: mid = 0.5(lo+hi); big = f(mid) > s; lo = big ? mid : lo;
//           hi = big ? hi : mid
//   τ = need ? 0.5(lo+hi) : 0
// Then x = mask ? clip(v − τ, 0, ub) : 0.
//
// The row is held in contiguous chunks: lane l of a group of L lanes
// holds columns [l·VPT, (l+1)·VPT).  Row sums run in this layout's order
// (in order within a lane's chunk, then the xor butterfly over the L
// lanes), and the loop stops once its result is fixed:
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

// ---- Rows wider than 1,024: one block a row ----------------------------
//
// A row goes to one block of kWideThreads threads.  Thread t holds the
// contiguous chunk [t·C, (t+1)·C) of C values, C·kWideThreads >= w, where
// the caller's layout puts it (`kernels/ref.py::block_layout` gives C,
// `kernels/dual_grad.py::wide_store` the storage): in registers
// (kStoreRegs, at the C a kernel is instantiated for), or staged in
// dynamic shared memory (kStoreShared) or in a global scratch row
// (kStoreGlobal).  The staged chunk is interleaved, value i of thread t at
// i·kWideThreads + t, so that a warp's reads of a step fall on 32 banks
// (shared) or one coalesced line (global).  Threads load their chunks
// kWidePiece values at a time, by vector loads where the row's width is a
// multiple of it.
constexpr int kWideThreads = 256;
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kWidePiece = 8;
constexpr int kStoreRegs = 0, kStoreShared = 1, kStoreGlobal = 2;
constexpr size_t kMaxSharedBytes = 227 * 1024;  // an H100 block's opt-in
// The chunks C with a register instance of each wide kernel
// (`kernels/dual_grad.py::WIDE_REG_CHUNKS`).
#define REPRO_WIDE_REG_CHUNKS(X) X(8) X(16) X(32)

// Bytes of a staged row of chunk C: v, then ub.
inline size_t wide_stage_bytes(int chunk) {
  return 2 * sizeof(float) * (size_t)chunk * kWideThreads;
}

// Whether (lanes, chunk, store) is a wide layout for rows of width w.
inline bool wide_layout_ok(int w, int lanes, int chunk, int store) {
  return lanes == kWideThreads && chunk > 0 && chunk % kWidePiece == 0 &&
         (long long)chunk * kWideThreads >= w && store >= kStoreRegs &&
         store <= kStoreGlobal &&
         (store != kStoreShared || wide_stage_bytes(chunk) <= kMaxSharedBytes);
}

// The chunk of the calling thread, values v and bounds ub.
// kC > 0: held in registers, kC values; kC == 0: staged in memory at
// `buf` (v) and `buf + P` (ub), P = C·kWideThreads.  Each thread reads
// only what it wrote, so staging needs no barrier.
template <int kC>
struct WideChunk {
  float v_[kC], ub_[kC];
  __device__ WideChunk(float*, int) {}
  __host__ __device__ static constexpr int size() { return kC; }
  __device__ float& v(int i) { return v_[i]; }
  __device__ float& ub(int i) { return ub_[i]; }
};

template <>
struct WideChunk<0> {
  float* vs;
  float* us;
  int n;
  __device__ WideChunk(float* buf, int chunk)
      : vs(buf + threadIdx.x), us(buf + chunk * kWideThreads + threadIdx.x),
        n(chunk) {}
  __device__ int size() const { return n; }
  __device__ float& v(int i) { return vs[i * kWideThreads]; }
  __device__ float& ub(int i) { return us[i * kWideThreads]; }
};

// Block sums in a fixed order: each thread's value, the warp's xor
// butterfly over its 32 lanes, then the kWideWarps warp results in warp
// order, by one barrier.  Every thread gets the same bits.  `buf` is
// 2 x kWideWarps floats of shared memory; two calls in a row must pass
// different buffers (a thread may still read the previous call's while a
// faster one writes), which is all the barrier they need.
__device__ __forceinline__ void block_sum2(float& a, float& b,
                                           float (*buf)[kWideWarps],
                                           bool b_max = false) {
  a = group_sum<32>(a);
  b = b_max ? group_max<32>(b) : group_sum<32>(b);
  if ((threadIdx.x & 31) == 0) {
    buf[0][threadIdx.x >> 5] = a;
    buf[1][threadIdx.x >> 5] = b;
  }
  __syncthreads();
  float ta = 0.0f, tb = b_max ? kNeg : 0.0f;
#pragma unroll
  for (int i = 0; i < kWideWarps; ++i) {
    ta += buf[0][i];
    tb = b_max ? fmaxf(tb, buf[1][i]) : tb + buf[1][i];
  }
  a = ta;
  b = tb;
}

__device__ __forceinline__ float block_sum(float a, float* buf) {
  a = group_sum<32>(a);
  if ((threadIdx.x & 31) == 0) buf[threadIdx.x >> 5] = a;
  __syncthreads();
  float t = 0.0f;
#pragma unroll
  for (int i = 0; i < kWideWarps; ++i) t += buf[i];
  return t;
}

// The shared memory of the wide path's reductions: the first one's (f0
// and max v), then one each step, alternating two buffers, and the last
// (the row's scalar partials) in a third.
struct WideRed {
  alignas(16) float first[2][kWideWarps];
  alignas(16) float step[2][kWideWarps];  // 16-byte aligned: vector reads
  alignas(16) float last[2][kWideWarps];
};

// `boxcut_tau_chunk` for a row held by a block as `WideChunk`s: the same
// steps and stopping rule, with the block sums of `block_sum`.  After a
// block sum every thread holds the same f, so lo, hi and mid, and with
// them the exit, are the same in every thread: the loop stops together,
// with no vote.  One barrier a step.  `ref.bisect_block_ref` repeats
// this in plain torch.
template <int kC>
__device__ __forceinline__ float boxcut_tau_block(WideChunk<kC>& ch, float s,
                                                  int iters, WideRed& red) {
  float f0 = 0.0f, hi = kNeg;
#pragma unroll (kC > 0 ? kC : 4)
  for (int i = 0; i < ch.size(); ++i) {
    f0 += clip0(ch.v(i), ch.ub(i));
    hi = fmaxf(hi, ch.v(i));
  }
  block_sum2(f0, hi, red.first, true);
  const bool need = f0 > s;
  float lo = fminf(0.0f, hi);
  if (need) {
#pragma unroll 1
    for (int it = 0; it < iters; ++it) {
      const float mid = 0.5f * (lo + hi);
      float f = 0.0f;
#pragma unroll (kC > 0 ? kC : 4)
      for (int i = 0; i < ch.size(); ++i) f += clip0(ch.v(i) - mid, ch.ub(i));
      f = block_sum(f, red.step[it & 1]);
      const bool big = f > s;
      const bool done = mid == lo || mid == hi;
      lo = big ? mid : lo;
      hi = big ? hi : mid;
      if (done) break;
    }
  }
  return need ? 0.5f * (lo + hi) : 0.0f;
}

// Floats of global scratch a row of chunk C needs at `store` (0: none).
inline long long wide_scratch_row(int chunk, int store) {
  return store == kStoreGlobal ? 2LL * chunk * kWideThreads : 0;
}

// Opt the wide kernel `fn` in to the dynamic shared memory a staged row of
// chunk C needs; returns the bytes to launch with.
template <typename F>
inline size_t wide_smem_bytes(F fn, int chunk, int store) {
  if (store != kStoreShared) return 0;
  const size_t bytes = wide_stage_bytes(chunk);
  if (bytes > 48 * 1024)
    cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
  return bytes;
}

// The staging buffer of the calling block's row: its dynamic shared
// memory, or its row of global scratch.
__device__ __forceinline__ float* wide_buffer(float* smem, float* rows,
                                              int chunk, int store) {
  return store == kStoreShared
             ? smem
             : rows + (size_t)blockIdx.x * 2 * (size_t)chunk * kWideThreads;
}

}  // namespace repro_torch
