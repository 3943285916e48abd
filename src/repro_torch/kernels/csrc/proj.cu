// proj_boxcut: the batched box-cut projection of an (n, w) slab,
//
//   x[r, :] = Π_{0 <= x <= ub, Σx <= s[r]}(v[r, :])   (masked entries 0),
//
// by `iters` τ-bisection steps with per-row budget s.
//
// Replaces the Pallas kernel `_proj_kernel` / `proj_boxcut` of
// src/repro/kernels/proj.py.  The bisection is `boxcut_tau` /
// `boxcut_tau_row` of common.cuh, the one K1 and K3 run, with K1's lane
// layout: fed the pre-projection u of a slab, this kernel gives K1's x.
//
// What bounds it on an H100: device-memory bytes (v, ub, mask read once,
// x written once: 13 bytes an entry at float32); the 40 bisection steps
// cost ~170 float32 operations an entry, below that line at 67 TFLOP/s.
//
// What the design does about it: rows up to 1,024 wide live in registers
// across a group of L lanes (L = 32 for w >= 32, else the next power of
// two of w), read once, coalesced; wider rows go one row per 256-thread
// block with v and ub staged once in dynamic shared memory (global
// scratch past 16,384 entries).  Fixed-order sums, no atomics.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;

template <typename T, int L, int VPT>
__global__ void __launch_bounds__(kThreads)
proj_rows_kernel(const T* __restrict__ vin, const T* __restrict__ ub,
                 const T* __restrict__ s, const uint8_t* __restrict__ mask,
                 T* __restrict__ x, long long n, int w, int iters) {
  constexpr int kGroups = 32 / L;
  const int lane = threadIdx.x & 31;
  const int gl = lane % L;
  const long long row =
      ((long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) *
          kGroups + lane / L;
  const bool row_ok = row < n;
  const float s_row = row_ok ? to_float(s[row]) : 1.0f;
  float v[VPT], ubv[VPT];
  bool mk[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int col = gl + i * L;
    const size_t e = (size_t)row * (size_t)w + (size_t)col;
    mk[i] = row_ok && col < w && mask[e] != 0;
    v[i] = mk[i] ? to_float(vin[e]) : kNeg;
    ubv[i] = mk[i] ? to_float(ub[e]) : 0.0f;
  }
  const float tau = boxcut_tau<L, VPT>(v, ubv, mk, s_row, iters);
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int col = gl + i * L;
    if (row_ok && col < w)
      x[(size_t)row * (size_t)w + (size_t)col] =
          from_float<T>(mk[i] ? clip0(v[i] - tau, ubv[i]) : 0.0f);
  }
}

template <typename T>
__global__ void __launch_bounds__(kWideThreads)
proj_wide_kernel(const T* __restrict__ vin, const T* __restrict__ ub,
                 const T* __restrict__ s, const uint8_t* __restrict__ mask,
                 T* __restrict__ x, float* __restrict__ rows, int w,
                 int iters) {
  extern __shared__ float smem[];
  __shared__ float red[kWideThreads / 32];
  const long long row = blockIdx.x;
  float* vrow = wide_in_smem(w) ? smem : rows + (size_t)row * 2 * (size_t)w;
  float* ubrow = vrow + w;
  for (int col = threadIdx.x; col < w; col += kWideThreads) {
    const size_t e = (size_t)row * (size_t)w + (size_t)col;
    const bool mk = mask[e] != 0;
    vrow[col] = mk ? to_float(vin[e]) : kNeg;
    ubrow[col] = mk ? to_float(ub[e]) : 0.0f;
  }
  const float tau =
      boxcut_tau_row(vrow, ubrow, w, to_float(s[row]), iters, red);
  for (int col = threadIdx.x; col < w; col += kWideThreads) {
    const size_t e = (size_t)row * (size_t)w + (size_t)col;
    x[e] = from_float<T>(mask[e] != 0 ? clip0(vrow[col] - tau, ubrow[col])
                                      : 0.0f);
  }
}

template <typename T>
int dispatch(const void* v, const void* ub, const void* s, const void* mask,
             void* x, float* rows, long long n, int w, int iters,
             cudaStream_t st) {
  if (w > kNarrowMaxWidth) {
    if (n > 0x7fffffffLL) return -1;
    auto fn = proj_wide_kernel<T>;
    const size_t smem = wide_smem_bytes(fn, w);
    fn<<<(int)n, kWideThreads, smem, st>>>((const T*)v, (const T*)ub,
                                           (const T*)s,
                                           (const uint8_t*)mask, (T*)x, rows,
                                           w, iters);
    return 0;
  }
  const int L = lanes_for(w);
  const long long rows_per_block = (long long)(kThreads / 32) * (32 / L);
  const long long nb = (n + rows_per_block - 1) / rows_per_block;
  if (nb > 0x7fffffffLL) return -1;
#define REPRO_PROJ(L_, V_)                                                 \
  proj_rows_kernel<T, L_, V_><<<(int)nb, kThreads, 0, st>>>(               \
      (const T*)v, (const T*)ub, (const T*)s, (const uint8_t*)mask, (T*)x, \
      n, w, iters)
  if (L < 32) {
    switch (L) {
      case 1: REPRO_PROJ(1, 1); break;
      case 2: REPRO_PROJ(2, 1); break;
      case 4: REPRO_PROJ(4, 1); break;
      case 8: REPRO_PROJ(8, 1); break;
      default: REPRO_PROJ(16, 1); break;
    }
    return 0;
  }
  switch (vpt_for(w)) {
    case 1: REPRO_PROJ(32, 1); break;
    case 2: REPRO_PROJ(32, 2); break;
    case 4: REPRO_PROJ(32, 4); break;
    case 8: REPRO_PROJ(32, 8); break;
    case 16: REPRO_PROJ(32, 16); break;
    default: REPRO_PROJ(32, 32); break;
  }
#undef REPRO_PROJ
  return 0;
}

}  // namespace
}  // namespace repro_torch

extern "C" {

// Length of the float scratch vector `proj_launch` needs (0: none): the
// global row buffer of rows too wide for shared memory.
long long proj_scratch(long long n, int w) {
  using namespace repro_torch;
  if (w <= kNarrowMaxWidth || wide_in_smem(w)) return 0;
  return 2 * n * (long long)w;
}

// Launches the projection on `stream`.  Returns cudaGetLastError() (0 on
// success), or -1 for a shape or type it does not take.
int proj_launch(int dtype, const void* v, const void* ub, const void* s,
                const void* mask, void* x, void* scratch, long long n, int w,
                int iters, void* stream) {
  using namespace repro_torch;
  if (n <= 0 || w <= 0) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  int rc;
  if (dtype == kFloat32)
    rc = dispatch<float>(v, ub, s, mask, x, (float*)scratch, n, w, iters, st);
  else if (dtype == kBFloat16)
    rc = dispatch<__nv_bfloat16>(v, ub, s, mask, x, (float*)scratch, n, w,
                                 iters, st);
  else
    return -1;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

}  // extern "C"
