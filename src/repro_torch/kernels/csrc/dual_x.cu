// dual_x: x*(λ) of one slab with its cᵀx and ‖x‖² partials.
//
// Replaces the Pallas kernel `_dual_x_kernel` / `dual_x_slab` of
// src/repro/kernels/dual_grad.py.  Per source row of a (n, w, m) slab:
// gather λ[k, dest], form u = −(Σ_k a_k·λ_k + c)/γ, project onto the
// box-cut {0 <= x <= ub, Σx <= s} by `iters` τ-bisection steps, write x,
// and sum c·x and x·x in float32.
//
// What bounds it on an H100: device-memory bytes.  Each edge is read once
// (a, c, ub, dest, mask: 17 bytes at float32, m = 1) and x written once
// (4 bytes); the 40 bisection steps cost ~170 float32 operations an edge,
// which at 67 TFLOP/s is below the 21 bytes at 3.35 TB/s.  λ (m·J floats,
// 40 KB at J = 10⁴) stays in L2.
//
// What the design does about it: one row per group of L lanes (L = 32 for
// w >= 32, else the next power of two of w), lanes striding over the row
// so a warp's loads are coalesced; the row's values stay in registers
// (VPT <= 32 a lane) for all bisection steps, so the slab is read from
// device memory exactly once; row sums go through xor shuffles.  λ is
// read through the read-only path (__ldg).  The scalar partials are
// reduced per block and written to a scratch vector; a second one-block
// pass sums them in a fixed order.  No atomics: results are bit-identical
// from run to run.  γ is read from device memory (a 0-d tensor in the
// slab's type, as the Pallas kernel reads gamma_ref), so a schedule that
// moves γ needs no host synchronisation.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;  // 8 warps a block

template <typename T, int L, int VPT>
__global__ void __launch_bounds__(kThreads)
dual_x_kernel(const T* __restrict__ a, const T* __restrict__ c,
              const int32_t* __restrict__ dest,
              const uint8_t* __restrict__ mask, const T* __restrict__ ub,
              const T* __restrict__ s, const float* __restrict__ lam,
              const T* __restrict__ gamma, T* __restrict__ x,
              float* __restrict__ partials, long long n, int w, int m,
              int J, int iters) {
  constexpr int kGroups = 32 / L;  // rows a warp
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gl = lane % L;
  const long long row =
      ((long long)blockIdx.x * (kThreads / 32) + warp) * kGroups + lane / L;
  const bool row_ok = row < n;
  const float gam = to_float(gamma[0]);
  const float s_row = row_ok ? to_float(s[row]) : 1.0f;

  float v[VPT], ubv[VPT];
  bool mk[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int col = gl + i * L;
    const size_t e = (size_t)row * (size_t)w + (size_t)col;
    mk[i] = row_ok && col < w && mask[e] != 0;
    v[i] = kNeg;
    ubv[i] = 0.0f;
    if (mk[i]) {
      const int d = dest[e];
      float atl = 0.0f;
      for (int k = 0; k < m; ++k)
        atl = __fadd_rn(atl, __fmul_rn(to_float(a[e * (size_t)m + k]),
                                       __ldg(lam + (size_t)k * J + d)));
      v[i] = -__fadd_rn(atl, to_float(c[e])) / gam;
      ubv[i] = to_float(ub[e]);
    }
  }

  const float tau = boxcut_tau<L, VPT>(v, ubv, mk, s_row, iters);

  float cx = 0.0f, xsq = 0.0f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int col = gl + i * L;
    if (row_ok && col < w) {
      const size_t e = (size_t)row * (size_t)w + (size_t)col;
      const float xi = mk[i] ? clip0(v[i] - tau, ubv[i]) : 0.0f;
      x[e] = from_float<T>(xi);
      if (mk[i]) {
        cx += __fmul_rn(to_float(c[e]), xi);
        xsq += __fmul_rn(xi, xi);
      }
    }
  }

  // block partials: warp butterfly, then the 8 warp sums in order
  cx = group_sum<32>(cx);
  xsq = group_sum<32>(xsq);
  __shared__ float sh[2][kThreads / 32];
  if (lane == 0) {
    sh[0][warp] = cx;
    sh[1][warp] = xsq;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a0 = 0.0f, a1 = 0.0f;
    for (int i = 0; i < kThreads / 32; ++i) {
      a0 += sh[0][i];
      a1 += sh[1][i];
    }
    partials[blockIdx.x] = a0;
    partials[gridDim.x + blockIdx.x] = a1;
  }
}

// Second stage: one block sums the per-block partials in a fixed order.
__global__ void __launch_bounds__(1024)
sum_partials_kernel(const float* __restrict__ partials, int nb,
                    float* __restrict__ cx, float* __restrict__ xsq) {
  __shared__ float sh[2][1024];
  float a0 = 0.0f, a1 = 0.0f;
  for (int i = threadIdx.x; i < nb; i += blockDim.x) {
    a0 += partials[i];
    a1 += partials[nb + i];
  }
  sh[0][threadIdx.x] = a0;
  sh[1][threadIdx.x] = a1;
  __syncthreads();
  for (int half = blockDim.x / 2; half > 0; half >>= 1) {
    if ((int)threadIdx.x < half) {
      sh[0][threadIdx.x] += sh[0][threadIdx.x + half];
      sh[1][threadIdx.x] += sh[1][threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    *cx = sh[0][0];
    *xsq = sh[1][0];
  }
}

// Lanes a row: 32 for w >= 32, else the next power of two of w.
int lanes_for(int w) {
  int L = 1;
  while (L < w && L < 32) L <<= 1;
  return L;
}

// Values a lane, a power of two (rows wider than 32·32 are refused).
int vpt_for(int w) {
  int vpt = 1;
  while (vpt * 32 < w) vpt <<= 1;
  return vpt;
}

long long blocks_for(long long n, int w) {
  const long long rows_per_block = (long long)(kThreads / 32) * (32 / lanes_for(w));
  return (n + rows_per_block - 1) / rows_per_block;
}

template <typename T, int L, int VPT>
void launch_rows(const void* a, const void* c, const void* dest,
                 const void* mask, const void* ub, const void* s,
                 const void* lam, const void* gamma, void* x, float* partials,
                 long long n, int w, int m, int J, int iters, int nb,
                 cudaStream_t stream) {
  dual_x_kernel<T, L, VPT><<<nb, kThreads, 0, stream>>>(
      (const T*)a, (const T*)c, (const int32_t*)dest, (const uint8_t*)mask,
      (const T*)ub, (const T*)s, (const float*)lam, (const T*)gamma, (T*)x,
      partials, n, w, m, J, iters);
}

template <typename T>
int dispatch(const void* a, const void* c, const void* dest, const void* mask,
             const void* ub, const void* s, const void* lam,
             const void* gamma, void* x, float* partials, long long n, int w,
             int m, int J, int iters, int nb, cudaStream_t stream) {
#define REPRO_ROWS(L_, V_)                                                  \
  launch_rows<T, L_, V_>(a, c, dest, mask, ub, s, lam, gamma, x, partials, \
                         n, w, m, J, iters, nb, stream)
  const int L = lanes_for(w);
  if (L < 32) {
    switch (L) {
      case 1: REPRO_ROWS(1, 1); break;
      case 2: REPRO_ROWS(2, 1); break;
      case 4: REPRO_ROWS(4, 1); break;
      case 8: REPRO_ROWS(8, 1); break;
      default: REPRO_ROWS(16, 1); break;
    }
    return 0;
  }
  switch (vpt_for(w)) {
    case 1: REPRO_ROWS(32, 1); break;
    case 2: REPRO_ROWS(32, 2); break;
    case 4: REPRO_ROWS(32, 4); break;
    case 8: REPRO_ROWS(32, 8); break;
    case 16: REPRO_ROWS(32, 16); break;
    case 32: REPRO_ROWS(32, 32); break;
    default: return -1;
  }
#undef REPRO_ROWS
  return 0;
}

}  // namespace
}  // namespace repro_torch

extern "C" {

// Widest row the kernel takes (32 lanes × 32 values in registers).
int dual_x_max_width() { return 32 * 32; }

// Length of the float scratch vector `dual_x_launch` needs.
long long dual_x_scratch(long long n, int w) {
  return 2 * repro_torch::blocks_for(n, w);
}

// Launches the slab kernel and the partial-sum pass on `stream`.  Returns
// cudaGetLastError() (0 on success), or -1 for a shape it does not take.
int dual_x_launch(int dtype, const void* a, const void* c, const void* dest,
                  const void* mask, const void* ub, const void* s,
                  const void* lam, const void* gamma, void* x,
                  void* scratch, void* cx, void* xsq, long long n, int w,
                  int m, int J, int iters, void* stream) {
  using namespace repro_torch;
  if (n <= 0 || w <= 0 || w > dual_x_max_width() || m <= 0) return -1;
  const long long nb = blocks_for(n, w);
  if (nb > 0x7fffffffLL) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  float* partials = (float*)scratch;
  int rc;
  if (dtype == kFloat32)
    rc = dispatch<float>(a, c, dest, mask, ub, s, lam, gamma, x, partials, n,
                         w, m, J, iters, (int)nb, st);
  else if (dtype == kBFloat16)
    rc = dispatch<__nv_bfloat16>(a, c, dest, mask, ub, s, lam, gamma, x,
                                 partials, n, w, m, J, iters, (int)nb, st);
  else
    return -1;
  if (rc != 0) return rc;
  sum_partials_kernel<<<1, 1024, 0, st>>>(partials, (int)nb, (float*)cx,
                                         (float*)xsq);
  return (int)cudaGetLastError();
}

}  // extern "C"
