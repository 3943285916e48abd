// proj_boxcut: the batched box-cut projection of an (n, w) slab,
//
//   x[r, :] = Π_{0 <= x <= ub, Σx <= s[r]}(v[r, :])   (masked entries 0),
//
// by a τ-bisection of at most `iters` steps with per-row budget s.
//
// Replaces the Pallas kernel `_proj_kernel` / `proj_boxcut` of
// src/repro/kernels/proj.py.  The bisection is the one K1 and K3 run
// (`boxcut_tau_chunk` / `boxcut_tau_block` of common.cuh) on K1's layout,
// so fed the pre-projection u of a float32 slab this kernel gives K1's x
// bit for bit.
//
// What bounds it on an H100: device-memory bytes (v, ub, mask read once,
// x written once: 13 bytes an entry at float32) against the bisection's
// issue, 4 float32 operations an entry a step at each row's own steps.
//
// What the design does about it, rows up to 1,024 wide: a row goes to a
// group of L lanes, lane l holding the contiguous columns [l·VPT,
// (l+1)·VPT) at the layout the wrapper gives
// (`kernels/dual_grad.py::row_layout`), loaded by 16-byte streaming vector
// loads and held in registers; a step sums the chunk in order and then
// runs a butterfly over the L lanes only (none at w <= 8, 3 levels at
// w = 64).  The bisection stops exactly once its bracket is fixed, and a
// row whose f0 <= s runs no step.  x leaves by streaming vector stores.
// A width that is not a multiple of VPT takes the same columns one by
// one.  Wider rows go one row per 256-thread block, each thread holding a
// contiguous chunk (`WideChunk`), with one barrier a step.  Fixed-order
// sums, no atomics.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;

// The N entries [e0, e0 + N) of a row, of which the first `nin` are the
// row's, by vector loads when `vec`: v at real entries, kNeg elsewhere;
// ub at real entries, 0 elsewhere; the mask bytes as loaded.
template <typename T, int N>
__device__ __forceinline__ void chunk_v(const T* __restrict__ vin,
                                        const T* __restrict__ ub,
                                        const uint8_t* __restrict__ mask,
                                        size_t e0, int nin, bool vec,
                                        uint8_t (&mv)[N], float (&v)[N],
                                        float (&ubv)[N]) {
  T vt[N], ubt[N];
  if (vec) {
    ld_vec<true>(vin + e0, vt);
    ld_vec<true>(ub + e0, ubt);
    ld_vec<true>(mask + e0, mv);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const bool in = i < nin;
      vt[i] = in ? vin[e0 + i] : from_float<T>(0.0f);
      ubt[i] = in ? ub[e0 + i] : from_float<T>(0.0f);
      mv[i] = in ? mask[e0 + i] : 0;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    v[i] = mv[i] ? to_float(vt[i]) : kNeg;
    ubv[i] = mv[i] ? to_float(ubt[i]) : 0.0f;
  }
}

// N values of x from x + e0, the first `nin` of them the row's.
template <typename T, int N>
__device__ __forceinline__ void store_x(T* __restrict__ x, size_t e0,
                                        int nin, bool vec, const T (&xo)[N]) {
  if (vec) {
    st_vec_n<T, N>(x + e0, xo);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (i < nin) x[e0 + i] = xo[i];
  }
}

// Rows up to 1,024 wide: a row to a group of L lanes, lane l holding
// columns [l·VPT, (l+1)·VPT).
template <typename T, int L, int VPT>
__global__ void __launch_bounds__(kThreads)
proj_rows_kernel(const T* __restrict__ vin, const T* __restrict__ ub,
                 const T* __restrict__ s, const uint8_t* __restrict__ mask,
                 T* __restrict__ x, long long n, int w, int iters) {
  constexpr int kGroups = 32 / L;  // rows a warp
  const int lane = threadIdx.x & 31;
  const int col0 = (lane % L) * VPT;
  const long long row =
      ((long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) *
          kGroups + lane / L;
  const bool row_ok = row < n;
  const float s_row = row_ok ? to_float(s[row]) : 1.0f;
  const int nin = row_ok ? min(max(w - col0, 0), VPT) : 0;
  const bool vec = nin == VPT && w % VPT == 0;
  const size_t e0 = row_ok ? (size_t)row * (size_t)w + (size_t)col0 : 0;
  uint8_t mv[VPT];
  float v[VPT], ubv[VPT];
  chunk_v<T, VPT>(vin, ub, mask, e0, nin, vec, mv, v, ubv);
  const float tau = boxcut_tau_chunk<L, VPT>(v, ubv, s_row, iters);
  T xo[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i)
    xo[i] = from_float<T>(mv[i] ? clip0(v[i] - tau, ubv[i]) : 0.0f);
  store_x<T, VPT>(x, e0, nin, vec, xo);
}

// Rows wider than 1,024: one block of kWideThreads a row, thread t
// holding the chunk [t·C, (t+1)·C) as a `WideChunk<kC>` (kC = C in
// registers, 0 staged in memory at `store`: shared, or `rows`, 2·C·256
// floats of global scratch a row).  An entry the row does not own holds
// v = kNeg and ub = 0, whose clip0(v − τ, ub) is +0: x needs no mask.
template <typename T, int kC>
__global__ void __launch_bounds__(kWideThreads)
proj_wide_kernel(const T* __restrict__ vin, const T* __restrict__ ub,
                 const T* __restrict__ s, const uint8_t* __restrict__ mask,
                 T* __restrict__ x, float* __restrict__ rows, int w,
                 int iters, int chunk_in, int store) {
  extern __shared__ float smem[];
  __shared__ WideRed red;
  constexpr int kP = kWidePiece;
  const int chunk = kC > 0 ? kC : chunk_in;
  WideChunk<kC> ch(wide_buffer(smem, rows, chunk, store), chunk);
  const size_t e_row = (size_t)blockIdx.x * (size_t)w;
  const int col0 = threadIdx.x * chunk;
  const bool vec_row = w % kP == 0;
#pragma unroll (kC > 0 ? kC / kWidePiece : 1)
  for (int p = 0; p < chunk / kP; ++p) {
    const int nin = min(max(w - (col0 + p * kP), 0), kP);
    uint8_t mv[kP];
    float v[kP], ubv[kP];
    chunk_v<T, kP>(vin, ub, mask, e_row + col0 + p * kP, nin,
                   vec_row && nin == kP, mv, v, ubv);
#pragma unroll
    for (int j = 0; j < kP; ++j) {
      ch.v(p * kP + j) = v[j];
      ch.ub(p * kP + j) = ubv[j];
    }
  }
  const float tau = boxcut_tau_block(ch, to_float(s[blockIdx.x]), iters, red);
#pragma unroll (kC > 0 ? kC / kWidePiece : 1)
  for (int p = 0; p < chunk / kP; ++p) {
    const int nin = min(max(w - (col0 + p * kP), 0), kP);
    T xo[kP];
#pragma unroll
    for (int j = 0; j < kP; ++j)
      xo[j] = from_float<T>(clip0(ch.v(p * kP + j) - tau, ch.ub(p * kP + j)));
    store_x<T, kP>(x, e_row + col0 + p * kP, nin, vec_row && nin == kP, xo);
  }
}

// The register path's layouts (L lanes a row, VPT values a lane): every
// (L, VPT) that `kernels/dual_grad.py::row_layout` gives at its default of
// 8 values a lane, for both types.
#define REPRO_PROJ_LAYOUTS(X)                                              \
  X(1, 1) X(1, 2) X(1, 4) X(1, 8) X(2, 8) X(4, 8) X(8, 8) X(16, 8)        \
  X(32, 8) X(32, 16) X(32, 32)

template <typename T, int kC>
int launch_wide(const void* v, const void* ub, const void* s,
                const void* mask, void* x, float* rows, long long n, int w,
                int iters, int chunk, int store, cudaStream_t st) {
  auto fn = proj_wide_kernel<T, kC>;
  const size_t smem = wide_smem_bytes(fn, chunk, store);
  fn<<<(int)n, kWideThreads, smem, st>>>((const T*)v, (const T*)ub,
                                         (const T*)s, (const uint8_t*)mask,
                                         (T*)x, rows, w, iters, chunk, store);
  return 0;
}

template <typename T>
int dispatch(const void* v, const void* ub, const void* s, const void* mask,
             void* x, float* rows, long long n, int w, int iters, int lanes,
             int vpt, int store, cudaStream_t st) {
  if (lanes == kWideThreads) {
    if (n > 0x7fffffffLL || !wide_layout_ok(w, lanes, vpt, store)) return -1;
    if (store != kStoreRegs)
      return launch_wide<T, 0>(v, ub, s, mask, x, rows, n, w, iters, vpt,
                               store, st);
#define REPRO_PROJ_WIDE(C_)                                               \
  if (vpt == C_)                                                           \
    return launch_wide<T, C_>(v, ub, s, mask, x, rows, n, w, iters, vpt,   \
                              store, st);
    REPRO_WIDE_REG_CHUNKS(REPRO_PROJ_WIDE)
#undef REPRO_PROJ_WIDE
    return -1;  // no register instance of this chunk
  }
  if (lanes <= 0 || lanes > 32 || lanes * vpt < w || store != kStoreRegs)
    return -1;
  const long long rows_per_block = (long long)(kThreads / 32) * (32 / lanes);
  const long long nb = (n + rows_per_block - 1) / rows_per_block;
  if (nb > 0x7fffffffLL) return -1;
#define REPRO_PROJ(L_, V_)                                                 \
  if (lanes == L_ && vpt == V_) {                                          \
    proj_rows_kernel<T, L_, V_><<<(int)nb, kThreads, 0, st>>>(             \
        (const T*)v, (const T*)ub, (const T*)s, (const uint8_t*)mask,      \
        (T*)x, n, w, iters);                                               \
    return 0;                                                              \
  }
  REPRO_PROJ_LAYOUTS(REPRO_PROJ)
#undef REPRO_PROJ
  return -1;  // a layout with no kernel instance
}

}  // namespace
}  // namespace repro_torch

extern "C" {

// Length of the float scratch vector `proj_launch` needs at a layout (0:
// none): the global rows of a wide layout staged there.
long long proj_scratch(long long n, int lanes, int vpt, int store) {
  using namespace repro_torch;
  return lanes == kWideThreads ? n * wide_scratch_row(vpt, store) : 0;
}

// Launches the projection on `stream` at the layout (lanes, vpt, store):
// a group of `lanes` <= 32 lanes a row, each holding `vpt` contiguous
// values in registers (store 0); or one block of 256 threads a row
// (lanes 256), each holding a chunk of `vpt` values where `store` says.
// Returns cudaGetLastError() (0 on success), or -1 for a shape, layout or
// type it does not take.
int proj_launch(int dtype, const void* v, const void* ub, const void* s,
                const void* mask, void* x, void* scratch, long long n, int w,
                int iters, int lanes, int vpt, int store, void* stream) {
  using namespace repro_torch;
  if (n <= 0 || w <= 0) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  int rc;
  if (dtype == kFloat32)
    rc = dispatch<float>(v, ub, s, mask, x, (float*)scratch, n, w, iters,
                         lanes, vpt, store, st);
  else if (dtype == kBFloat16)
    rc = dispatch<__nv_bfloat16>(v, ub, s, mask, x, (float*)scratch, n, w,
                                 iters, lanes, vpt, store, st);
  else
    return -1;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

}  // extern "C"
