// dual_x / dual_grad: x*(λ) of one slab with its cᵀx and ‖x‖² partials,
// and (dual_grad) the per-edge gradient values gvals = a ⊙ x.
//
// Replaces the Pallas kernels of src/repro/kernels/dual_grad.py:
// `_dual_x_kernel` / `dual_x_slab` (K1) and `_dual_grad_kernel` /
// `dual_grad_slab` (K3).  Per source row of a (n, w, m) slab: gather
// λ[k, dest], form u = −(Σ_k a_k·λ_k + c)/γ, project onto the box-cut
// {0 <= x <= ub, Σx <= s} by `iters` τ-bisection steps, write x (and
// gvals), and sum c·x and x·x in float32.  K3 is K1's body with the
// template flag kGvals set, so its x, cᵀx and ‖x‖² are K1's bit for bit.
//
// What bounds it on an H100: device-memory bytes.  Each edge is read once
// (a, c, ub, dest, mask: 17 bytes at float32, m = 1) and x written once
// (4 bytes), plus m·4 bytes of gvals for K3; the 40 bisection steps cost
// ~170 float32 operations an edge, which at 67 TFLOP/s is below the
// 21 bytes at 3.35 TB/s.  λ (m·J floats, 40 KB at J = 10⁴) stays in L2.
//
// What the design does about it: rows up to 1,024 wide go one row per
// group of L lanes (L = 32 for w >= 32, else the next power of two of w),
// lanes striding over the row so a warp's loads are coalesced; the row's
// values stay in registers (VPT <= 32 a lane) for all bisection steps, so
// the slab is read from device memory exactly once; row sums go through
// xor shuffles.  K3 re-reads a for its gvals write rather than holding
// m·VPT more values in registers (K1 already runs at 128 registers).
// Wider rows go one row per 256-thread block: u and ub are formed once
// into dynamic shared memory (global scratch past 16,384 entries) and the
// same bisection runs with fixed-order block sums (`boxcut_tau_row`).
// λ is read through the read-only path (__ldg).  The scalar partials are
// reduced per block and written to a scratch vector; a second one-block
// pass sums them in a fixed order.  No atomics: results are bit-identical
// from run to run.  γ is read from device memory (a 0-d tensor in the
// slab's type, as the Pallas kernel reads gamma_ref), so a schedule that
// moves γ needs no host synchronisation.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;  // 8 warps a block

// u = −(Σ_k a_k·λ_k[dest] + c)/γ of one real edge, in K1's literal order.
template <typename T>
__device__ __forceinline__ float edge_u(const T* __restrict__ a,
                                        const T* __restrict__ c,
                                        const int32_t* __restrict__ dest,
                                        const float* __restrict__ lam,
                                        size_t e, int m, int J, float gam) {
  const int d = dest[e];
  float atl = 0.0f;
  for (int k = 0; k < m; ++k)
    atl = __fadd_rn(atl, __fmul_rn(to_float(a[e * (size_t)m + k]),
                                   __ldg(lam + (size_t)k * J + d)));
  return -__fadd_rn(atl, to_float(c[e])) / gam;
}

// gvals[e, :] = a[e, :] ⊙ x[e] in the slab's type, 0 on padding.
template <typename T>
__device__ __forceinline__ void write_gvals(const T* __restrict__ a,
                                            T* __restrict__ g, size_t e,
                                            int m, bool mk, float xi) {
  const T xt = from_float<T>(xi);
  for (int k = 0; k < m; ++k)
    g[e * (size_t)m + k] =
        mk ? from_float<T>(mul_in_type(a[e * (size_t)m + k], xt))
           : from_float<T>(0.0f);
}

template <typename T, int L, int VPT, bool kGvals>
__global__ void __launch_bounds__(kThreads)
dual_x_kernel(const T* __restrict__ a, const T* __restrict__ c,
              const int32_t* __restrict__ dest,
              const uint8_t* __restrict__ mask, const T* __restrict__ ub,
              const T* __restrict__ s, const float* __restrict__ lam,
              const T* __restrict__ gamma, T* __restrict__ x,
              T* __restrict__ g, float* __restrict__ partials, long long n,
              int w, int m, int J, int iters) {
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
      v[i] = edge_u<T>(a, c, dest, lam, e, m, J, gam);
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
      if constexpr (kGvals) write_gvals<T>(a, g, e, m, mk[i], xi);
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

// Rows wider than 1,024: one block of kWideThreads a row.  `rows` is the
// global scratch (2·w floats a row) when the row does not fit in shared
// memory, else unused.
template <typename T, bool kGvals>
__global__ void __launch_bounds__(kWideThreads)
dual_x_wide_kernel(const T* __restrict__ a, const T* __restrict__ c,
                   const int32_t* __restrict__ dest,
                   const uint8_t* __restrict__ mask, const T* __restrict__ ub,
                   const T* __restrict__ s, const float* __restrict__ lam,
                   const T* __restrict__ gamma, T* __restrict__ x,
                   T* __restrict__ g, float* __restrict__ partials,
                   float* __restrict__ rows, int w, int m, int J, int iters) {
  extern __shared__ float smem[];
  __shared__ float red[kWideThreads / 32];
  const long long row = blockIdx.x;
  float* vrow = wide_in_smem(w) ? smem : rows + (size_t)row * 2 * (size_t)w;
  float* ubrow = vrow + w;
  const float gam = to_float(gamma[0]);
  for (int col = threadIdx.x; col < w; col += kWideThreads) {
    const size_t e = (size_t)row * (size_t)w + (size_t)col;
    const bool mk = mask[e] != 0;
    vrow[col] = mk ? edge_u<T>(a, c, dest, lam, e, m, J, gam) : kNeg;
    ubrow[col] = mk ? to_float(ub[e]) : 0.0f;
  }
  const float tau =
      boxcut_tau_row(vrow, ubrow, w, to_float(s[row]), iters, red);
  float cx = 0.0f, xsq = 0.0f;
  for (int col = threadIdx.x; col < w; col += kWideThreads) {
    const size_t e = (size_t)row * (size_t)w + (size_t)col;
    const bool mk = mask[e] != 0;
    const float xi = mk ? clip0(vrow[col] - tau, ubrow[col]) : 0.0f;
    x[e] = from_float<T>(xi);
    if constexpr (kGvals) write_gvals<T>(a, g, e, m, mk, xi);
    if (mk) {
      cx += __fmul_rn(to_float(c[e]), xi);
      xsq += __fmul_rn(xi, xi);
    }
  }
  cx = block_sum(cx, red);
  xsq = block_sum(xsq, red);
  if (threadIdx.x == 0) {
    partials[row] = cx;
    partials[gridDim.x + row] = xsq;
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

long long blocks_for(long long n, int w) {
  if (w > kNarrowMaxWidth) return n;  // one block a row
  const long long rows_per_block = (long long)(kThreads / 32) * (32 / lanes_for(w));
  return (n + rows_per_block - 1) / rows_per_block;
}

struct Args {
  const void *a, *c, *dest, *mask, *ub, *s, *lam, *gamma;
  void *x, *g;
  float *partials, *rows;
  long long n;
  int w, m, J, iters, nb;
  cudaStream_t stream;
};

template <typename T, int L, int VPT, bool kGvals>
void launch_rows(const Args& p) {
  dual_x_kernel<T, L, VPT, kGvals><<<p.nb, kThreads, 0, p.stream>>>(
      (const T*)p.a, (const T*)p.c, (const int32_t*)p.dest,
      (const uint8_t*)p.mask, (const T*)p.ub, (const T*)p.s,
      (const float*)p.lam, (const T*)p.gamma, (T*)p.x, (T*)p.g, p.partials,
      p.n, p.w, p.m, p.J, p.iters);
}

template <typename T, bool kGvals>
void launch_wide(const Args& p) {
  auto fn = dual_x_wide_kernel<T, kGvals>;
  const size_t smem = wide_smem_bytes(fn, p.w);
  fn<<<p.nb, kWideThreads, smem, p.stream>>>(
      (const T*)p.a, (const T*)p.c, (const int32_t*)p.dest,
      (const uint8_t*)p.mask, (const T*)p.ub, (const T*)p.s,
      (const float*)p.lam, (const T*)p.gamma, (T*)p.x, (T*)p.g, p.partials,
      p.rows, p.w, p.m, p.J, p.iters);
}

template <typename T, bool kGvals>
void dispatch(const Args& p) {
#define REPRO_ROWS(L_, V_) launch_rows<T, L_, V_, kGvals>(p)
  if (p.w > kNarrowMaxWidth) {
    launch_wide<T, kGvals>(p);
    return;
  }
  const int L = lanes_for(p.w);
  if (L < 32) {
    switch (L) {
      case 1: REPRO_ROWS(1, 1); break;
      case 2: REPRO_ROWS(2, 1); break;
      case 4: REPRO_ROWS(4, 1); break;
      case 8: REPRO_ROWS(8, 1); break;
      default: REPRO_ROWS(16, 1); break;
    }
    return;
  }
  switch (vpt_for(p.w)) {
    case 1: REPRO_ROWS(32, 1); break;
    case 2: REPRO_ROWS(32, 2); break;
    case 4: REPRO_ROWS(32, 4); break;
    case 8: REPRO_ROWS(32, 8); break;
    case 16: REPRO_ROWS(32, 16); break;
    default: REPRO_ROWS(32, 32); break;
  }
#undef REPRO_ROWS
}

int launch(int dtype, Args p, void* cx, void* xsq, void* scratch) {
  if (p.n <= 0 || p.w <= 0 || p.m <= 0) return -1;
  const long long nb = blocks_for(p.n, p.w);
  if (nb > 0x7fffffffLL) return -1;
  p.nb = (int)nb;
  p.partials = (float*)scratch;
  p.rows = p.partials + 2 * nb;
  const bool gv = p.g != nullptr;
  if (dtype == kFloat32)
    gv ? dispatch<float, true>(p) : dispatch<float, false>(p);
  else if (dtype == kBFloat16)
    gv ? dispatch<__nv_bfloat16, true>(p) : dispatch<__nv_bfloat16, false>(p);
  else
    return -1;
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  sum_partials_kernel<<<1, 1024, 0, p.stream>>>(p.partials, p.nb, (float*)cx,
                                                (float*)xsq);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

extern "C" {

// Length of the float scratch vector `dual_x_launch` / `dual_grad_launch`
// need: the per-block partials, and the global row buffer of rows too
// wide for shared memory.
long long dual_x_scratch(long long n, int w) {
  using namespace repro_torch;
  long long len = 2 * blocks_for(n, w);
  if (w > kNarrowMaxWidth && !wide_in_smem(w)) len += 2 * n * (long long)w;
  return len;
}

// K1: launches the slab kernel and the partial-sum pass on `stream`.
// Returns cudaGetLastError() (0 on success), or -1 for a shape or type it
// does not take.
int dual_x_launch(int dtype, const void* a, const void* c, const void* dest,
                  const void* mask, const void* ub, const void* s,
                  const void* lam, const void* gamma, void* x,
                  void* scratch, void* cx, void* xsq, long long n, int w,
                  int m, int J, int iters, void* stream) {
  repro_torch::Args p{a, c, dest, mask, ub, s, lam, gamma, x, nullptr,
                      nullptr, nullptr, n, w, m, J, iters, 0,
                      (cudaStream_t)stream};
  return repro_torch::launch(dtype, p, cx, xsq, scratch);
}

// K3: K1 plus the (n, w, m) gvals = a ⊙ x in the slab's type (0 on
// padding).
int dual_grad_launch(int dtype, const void* a, const void* c,
                     const void* dest, const void* mask, const void* ub,
                     const void* s, const void* lam, const void* gamma,
                     void* x, void* gvals, void* scratch, void* cx,
                     void* xsq, long long n, int w, int m, int J, int iters,
                     void* stream) {
  if (gvals == nullptr) return -1;
  repro_torch::Args p{a, c, dest, mask, ub, s, lam, gamma, x, gvals,
                      nullptr, nullptr, n, w, m, J, iters, 0,
                      (cudaStream_t)stream};
  return repro_torch::launch(dtype, p, cx, xsq, scratch);
}

}  // extern "C"
