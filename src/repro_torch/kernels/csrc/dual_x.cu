// dual_x / dual_grad: x*(λ) of one slab with its cᵀx and ‖x‖² partials,
// and (dual_grad) the per-edge gradient values gvals = a ⊙ x.
//
// Replaces the Pallas kernels of src/repro/kernels/dual_grad.py:
// `_dual_x_kernel` / `dual_x_slab` (K1) and `_dual_grad_kernel` /
// `dual_grad_slab` (K3).  Per source row of a (n, w, m) slab: gather
// λ[k, dest], form u = −(Σ_k a_k·λ_k + c)/γ, project onto the box-cut
// {0 <= x <= ub, Σx <= s} by a τ-bisection of at most `iters` steps, write
// x (and gvals), and sum c·x and x·x in float32.  K3 is K1's body with the
// template flag kGvals set, so its x, cᵀx and ‖x‖² are K1's bit for bit.
//
// What bounds it on an H100: device-memory bytes and the issue rate of
// the bisection, about equally.  Each real edge is read once (a, c, ub,
// dest: 16 bytes at float32, m = 1; the mask a byte an entry) and x
// written once (4 bytes), plus m·4 bytes of gvals for K3: ~0.34 ms on the
// main path.  Each bisection step costs ~4 instructions an entry (a
// subtraction, a max, a min, an add) over every padded entry of a row
// that has not converged, ~0.3 ms at 40 steps.  λ (m·J floats, 40 KB at
// J = 10⁴) stays in L2.
//
// What the design does about it, rows up to 1,024 wide: a row goes to a
// group of L lanes, lane l owning the contiguous columns [l·VPT,
// (l+1)·VPT); the layout (L, VPT) comes from the wrapper
// (`kernels/dual_grad.py::row_layout`: VPT = min(w, 8), w/32 past 256).
// A lane loads its chunk of a, c, ub, dest and mask with 16-byte
// streaming vector loads (`__ldcs`, evict first), so a warp reads whole
// sectors, and holds v and ub in registers for the whole bisection.  A
// bisection step sums the chunk in order inside the lane and then runs a
// butterfly over the L lanes only: 2 shuffle levels at w = 32 where a
// warp a row took 5.  The loop stops exactly when its bracket stops
// moving (`boxcut_tau_chunk`): a row whose f0 <= s runs no step, and a
// warp stops once all its rows' brackets are fixed, giving the result of
// all `iters` steps bit for bit.  x (and K3's gvals, formed from the a
// values the lane holds when VPT <= 8 and m <= 2) leave by streaming
// vector stores.  A row whose width is not a multiple of VPT (never made
// by the slab builder, whose widths are powers of two) takes the same
// columns one by one.
//
// Wider rows go one row per 256-thread block (`boxcut_tau_block`): thread
// t holds the contiguous chunk [t·C, (t+1)·C) at the layout the wrapper
// gives (`kernels/ref.py::block_layout`: C the next power of two of w over
// 256), in registers or staged in dynamic shared memory or global scratch
// (`kernels/dual_grad.py::wide_store`), loaded 8 values at a time by the
// same vector loads.  A bisection step sums the chunk in order, then
// the warp's butterfly, then the 8 warp sums in order, by one barrier; it
// stops exactly, as the register path does.  λ is read through the
// read-only path (__ldg).  The scalar partials are reduced per block in
// the same order and written to a scratch vector; a second one-block pass
// sums them in a fixed order.  No atomics: results are bit-identical from
// run to run.  γ is read from device memory (a 0-d tensor in the slab's
// type, as the Pallas kernel reads gamma_ref), so a schedule that moves γ
// needs no host synchronisation.
#include <type_traits>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;  // 8 warps a block

// atl + a·λ, K1's literal order (no contraction into an FMA).
template <typename T>
__device__ __forceinline__ float add_term(float atl, T a, float lam) {
  return __fadd_rn(atl, __fmul_rn(to_float(a), lam));
}

// The N entries [e0, e0 + N) of a slab row, of which the first `nin` are
// the row's, loaded by vector loads when `vec` (a whole chunk, the row's
// width a multiple of N): c and the mask bytes as loaded, and a (m values
// an entry) when `vec` and m <= 2; v = u = −(Σ_k a_k·λ_k[dest] + c)/γ at
// real entries, in K1's literal order, kNeg elsewhere; ub at real
// entries, 0 elsewhere.
template <typename T, int N>
__device__ __forceinline__ void chunk_u(
    const T* __restrict__ a, const T* __restrict__ c,
    const int32_t* __restrict__ dest, const uint8_t* __restrict__ mask,
    const T* __restrict__ ub, const float* __restrict__ lam, size_t e0,
    int nin, bool vec, int m, int J, float gam, T (&cv)[N],
    uint8_t (&mv)[N], T (&ar)[2 * N], float (&v)[N], float (&ubv)[N]) {
  const bool avec = vec && m <= 2;
  T ubt[N];
  int32_t dv[N];
  if (vec) {
    ld_vec<true>(c + e0, cv);
    ld_vec<true>(ub + e0, ubt);
    ld_vec<true>(dest + e0, dv);
    ld_vec<true>(mask + e0, mv);
    if (m == 1) ld_vec_n<true, T, N>(a + e0, ar);
    else if (m == 2) ld_vec_n<true, T, 2 * N>(a + 2 * e0, ar);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const bool in = i < nin;
      cv[i] = in ? c[e0 + i] : from_float<T>(0.0f);
      ubt[i] = in ? ub[e0 + i] : from_float<T>(0.0f);
      dv[i] = in ? dest[e0 + i] : 0;
      mv[i] = in ? mask[e0 + i] : 0;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    v[i] = kNeg;
    ubv[i] = 0.0f;
    if (mv[i]) {
      const int d = dv[i];
      float atl;
      if (avec && m == 1) {
        atl = add_term(0.0f, ar[i], __ldg(lam + d));
      } else if (avec) {
        atl = add_term(0.0f, ar[2 * i], __ldg(lam + d));
        atl = add_term(atl, ar[2 * i + 1], __ldg(lam + (size_t)J + d));
      } else {
        atl = 0.0f;
        for (int k = 0; k < m; ++k)
          atl = add_term(atl, a[(e0 + i) * (size_t)m + k],
                         __ldg(lam + (size_t)k * J + d));
      }
      v[i] = -__fadd_rn(atl, to_float(cv[i])) / gam;
      ubv[i] = to_float(ubt[i]);
    }
  }
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

// K1 (kGvals false) and K3 (true) on rows up to 1,024 wide: a row to a
// group of L lanes, lane l holding columns [l·VPT, (l+1)·VPT).
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
  // K3 keeps the chunk's a values for its gvals write up to VPT = 8
  constexpr bool kHoldA = kGvals && VPT <= 8;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col0 = (lane % L) * VPT;
  const long long row =
      ((long long)blockIdx.x * (kThreads / 32) + warp) * kGroups + lane / L;
  const bool row_ok = row < n;
  const float gam = to_float(gamma[0]);
  const float s_row = row_ok ? to_float(s[row]) : 1.0f;
  // this lane's columns of the row: [col0, col0 + nin)
  const int nin = row_ok ? min(max(w - col0, 0), VPT) : 0;
  // whole chunk, rows a multiple of the vector width: vector loads
  const bool vec = nin == VPT && w % VPT == 0;
  const bool avec = vec && m <= 2;
  const size_t e0 = row_ok ? (size_t)row * (size_t)w + (size_t)col0 : 0;

  T cv[VPT], ar[2 * VPT];
  uint8_t mv[VPT];
  float v[VPT], ubv[VPT];
  chunk_u<T, VPT>(a, c, dest, mask, ub, lam, e0, nin, vec, m, J, gam, cv, mv,
                  ar, v, ubv);

  const float tau = boxcut_tau_chunk<L, VPT>(v, ubv, s_row, iters);

  float cx = 0.0f, xsq = 0.0f;
  T xo[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const float xi = mv[i] ? clip0(v[i] - tau, ubv[i]) : 0.0f;
    xo[i] = from_float<T>(xi);
    if (mv[i]) {
      cx += __fmul_rn(to_float(cv[i]), xi);
      xsq += __fmul_rn(xi, xi);
    }
  }
  if (vec) {
    st_vec_n<T, VPT>(x + e0, xo);
  } else {
#pragma unroll
    for (int i = 0; i < VPT; ++i)
      if (i < nin) x[e0 + i] = xo[i];
  }
  if constexpr (kGvals) {
    const T zero = from_float<T>(0.0f);
    if (kHoldA && avec && m == 1) {
      T go[VPT];
#pragma unroll
      for (int i = 0; i < VPT; ++i)
        go[i] = mv[i] ? from_float<T>(mul_in_type(ar[i], xo[i])) : zero;
      st_vec_n<T, VPT>(g + e0, go);
    } else if (kHoldA && avec) {
      T go[2 * VPT];
#pragma unroll
      for (int i = 0; i < VPT; ++i)
#pragma unroll
        for (int k = 0; k < 2; ++k)
          go[2 * i + k] =
              mv[i] ? from_float<T>(mul_in_type(ar[2 * i + k], xo[i])) : zero;
      st_vec_n<T, 2 * VPT>(g + 2 * e0, go);
    } else {
#pragma unroll
      for (int i = 0; i < VPT; ++i)
        if (i < nin) write_gvals<T>(a, g, e0 + i, m, mv[i] != 0, to_float(xo[i]));
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

// Rows wider than 1,024: one block of kWideThreads a row, thread t holding
// the chunk [t·C, (t+1)·C) as a `WideChunk<kC>` (kC = C in registers, 0
// staged in memory at `store`: shared, or `rows`, 2·C·256 floats of
// global scratch a row).  On the register path c and the mask stay in registers for the
// partials; staged rows read them again.  K3 reads a again for gvals, by
// vector loads and stores for m <= 2.
template <typename T, int kC, bool kGvals>
__global__ void __launch_bounds__(kWideThreads)
dual_x_wide_kernel(const T* __restrict__ a, const T* __restrict__ c,
                   const int32_t* __restrict__ dest,
                   const uint8_t* __restrict__ mask, const T* __restrict__ ub,
                   const T* __restrict__ s, const float* __restrict__ lam,
                   const T* __restrict__ gamma, T* __restrict__ x,
                   T* __restrict__ g, float* __restrict__ partials,
                   float* __restrict__ rows, int w, int m, int J, int iters,
                   int chunk_in, int store) {
  extern __shared__ float smem[];
  __shared__ WideRed red;
  constexpr int kP = kWidePiece;
  constexpr int kHeld = kC > 0 ? kC : 1;
  const int chunk = kC > 0 ? kC : chunk_in;
  WideChunk<kC> ch(wide_buffer(smem, rows, chunk, store), chunk);
  const float gam = to_float(gamma[0]);
  const size_t e_row = (size_t)blockIdx.x * (size_t)w;
  const int col0 = threadIdx.x * chunk;
  const bool vec_row = w % kP == 0;
  T ch_c[kHeld];
  unsigned ch_mask = 0;  // bit i: entry i of the chunk is real
#pragma unroll (kC > 0 ? kC / kWidePiece : 1)
  for (int p = 0; p < chunk / kP; ++p) {
    const int nin = min(max(w - (col0 + p * kP), 0), kP);
    T cv[kP], ar[2 * kP];
    uint8_t mv[kP];
    float v[kP], ubv[kP];
    chunk_u<T, kP>(a, c, dest, mask, ub, lam, e_row + col0 + p * kP, nin,
                   vec_row && nin == kP, m, J, gam, cv, mv, ar, v, ubv);
#pragma unroll
    for (int j = 0; j < kP; ++j) {
      ch.v(p * kP + j) = v[j];
      ch.ub(p * kP + j) = ubv[j];
      if constexpr (kC > 0) {
        ch_c[p * kP + j] = cv[j];
        ch_mask |= (mv[j] ? 1u : 0u) << (p * kP + j);
      }
    }
  }

  const float tau = boxcut_tau_block(ch, to_float(s[blockIdx.x]), iters, red);

  float cx = 0.0f, xsq = 0.0f;
#pragma unroll (kC > 0 ? kC / kWidePiece : 1)
  for (int p = 0; p < chunk / kP; ++p) {
    const int nin = min(max(w - (col0 + p * kP), 0), kP);
    const bool vec = vec_row && nin == kP;
    const size_t e = e_row + col0 + p * kP;
    T cv[kP];
    uint8_t mv[kP];
    if constexpr (kC > 0) {
#pragma unroll
      for (int j = 0; j < kP; ++j) {
        cv[j] = ch_c[p * kP + j];
        mv[j] = (ch_mask >> (p * kP + j)) & 1u;
      }
    } else if (vec) {
      ld_vec<true>(c + e, cv);
      ld_vec<true>(mask + e, mv);
    } else {
#pragma unroll
      for (int j = 0; j < kP; ++j) {
        cv[j] = j < nin ? c[e + j] : from_float<T>(0.0f);
        mv[j] = j < nin ? mask[e + j] : 0;
      }
    }
    T xo[kP];
#pragma unroll
    for (int j = 0; j < kP; ++j) {
      const float xi =
          mv[j] ? clip0(ch.v(p * kP + j) - tau, ch.ub(p * kP + j)) : 0.0f;
      xo[j] = from_float<T>(xi);
      if (mv[j]) {
        cx += __fmul_rn(to_float(cv[j]), xi);
        xsq += __fmul_rn(xi, xi);
      }
    }
    if (vec) {
      st_vec_n<T, kP>(x + e, xo);
    } else {
#pragma unroll
      for (int j = 0; j < kP; ++j)
        if (j < nin) x[e + j] = xo[j];
    }
    if constexpr (kGvals) {
      const T zero = from_float<T>(0.0f);
      T ar[2 * kP], go[2 * kP];
      if (vec && m == 1) {
        ld_vec_n<true, T, kP>(a + e, ar);
#pragma unroll
        for (int j = 0; j < kP; ++j)
          go[j] = mv[j] ? from_float<T>(mul_in_type(ar[j], xo[j])) : zero;
        st_vec_n<T, kP>(g + e, go);
      } else if (vec && m == 2) {
        ld_vec_n<true, T, 2 * kP>(a + 2 * e, ar);
#pragma unroll
        for (int j = 0; j < 2 * kP; ++j)
          go[j] = mv[j / 2] ? from_float<T>(mul_in_type(ar[j], xo[j / 2]))
                            : zero;
        st_vec_n<T, 2 * kP>(g + 2 * e, go);
      } else {
#pragma unroll
        for (int j = 0; j < kP; ++j)
          if (j < nin)
            write_gvals<T>(a, g, e + j, m, mv[j] != 0, to_float(xo[j]));
      }
    }
  }
  block_sum2(cx, xsq, red.last);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = cx;
    partials[gridDim.x + blockIdx.x] = xsq;
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

// The register path's layouts (L lanes a row, VPT values a lane): every
// (L, VPT) that `kernels/dual_grad.py::row_layout` gives at its default of
// 8 values a lane, for both types; and, float32 only, those it gives at 4
// and 16 for rows up to 64 wide, which chip_smoke.py times on the main
// path's slabs.
#define REPRO_LAYOUTS(X)                                                   \
  X(1, 1) X(1, 2) X(1, 4) X(1, 8) X(2, 8) X(4, 8) X(8, 8) X(16, 8)        \
  X(32, 8) X(32, 16) X(32, 32)
#define REPRO_SWEEP_LAYOUTS(X)                                             \
  X(2, 4) X(4, 4) X(8, 4) X(16, 4) X(1, 16) X(2, 16) X(4, 16)

bool layout_ok(int dtype, int w, int lanes, int vpt, int store) {
  if (lanes == kWideThreads) {
    if (!wide_layout_ok(w, lanes, vpt, store)) return false;
    if (store != kStoreRegs) return true;
#define REPRO_HAS_WIDE(C_) \
  if (vpt == C_) return true;
    REPRO_WIDE_REG_CHUNKS(REPRO_HAS_WIDE)
#undef REPRO_HAS_WIDE
    return false;
  }
  if (lanes <= 0 || lanes > 32 || lanes * vpt < w || store != kStoreRegs)
    return false;
#define REPRO_HAS(L_, V_) \
  if (lanes == L_ && vpt == V_) return true;
  REPRO_LAYOUTS(REPRO_HAS)
  if (dtype == kFloat32) {
    REPRO_SWEEP_LAYOUTS(REPRO_HAS)
  }
#undef REPRO_HAS
  return false;
}

long long blocks_for(long long n, int lanes) {
  if (lanes == kWideThreads) return n;  // one block a row
  const long long rows_per_block = (long long)(kThreads / 32) * (32 / lanes);
  return (n + rows_per_block - 1) / rows_per_block;
}

struct Args {
  const void *a, *c, *dest, *mask, *ub, *s, *lam, *gamma;
  void *x, *g;
  float *partials, *rows;
  long long n;
  int w, m, J, iters, lanes, vpt, store, nb;
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

template <typename T, int kC, bool kGvals>
void launch_wide_chunk(const Args& p) {
  auto fn = dual_x_wide_kernel<T, kC, kGvals>;
  const size_t smem = wide_smem_bytes(fn, p.vpt, p.store);
  fn<<<p.nb, kWideThreads, smem, p.stream>>>(
      (const T*)p.a, (const T*)p.c, (const int32_t*)p.dest,
      (const uint8_t*)p.mask, (const T*)p.ub, (const T*)p.s,
      (const float*)p.lam, (const T*)p.gamma, (T*)p.x, (T*)p.g, p.partials,
      p.rows, p.w, p.m, p.J, p.iters, p.vpt, p.store);
}

// (`layout_ok` has checked the layout.)
template <typename T, bool kGvals>
void dispatch(const Args& p) {
  if (p.lanes == kWideThreads) {
    if (p.store != kStoreRegs) return launch_wide_chunk<T, 0, kGvals>(p);
#define REPRO_WIDE(C_) \
  if (p.vpt == C_) return launch_wide_chunk<T, C_, kGvals>(p);
    REPRO_WIDE_REG_CHUNKS(REPRO_WIDE)
#undef REPRO_WIDE
    return;
  }
#define REPRO_ROWS(L_, V_)                    \
  if (p.lanes == L_ && p.vpt == V_) {         \
    launch_rows<T, L_, V_, kGvals>(p);        \
    return;                                   \
  }
  REPRO_LAYOUTS(REPRO_ROWS)
  if constexpr (std::is_same_v<T, float>) {
    REPRO_SWEEP_LAYOUTS(REPRO_ROWS)
  }
#undef REPRO_ROWS
}

int launch(int dtype, Args p, void* cx, void* xsq, void* scratch) {
  if (p.n <= 0 || p.w <= 0 || p.m <= 0) return -1;
  if (!layout_ok(dtype, p.w, p.lanes, p.vpt, p.store)) return -1;
  const long long nb = blocks_for(p.n, p.lanes);
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
// need for a slab of n rows at the layout (lanes, vpt, store): the
// per-block partials, and the global rows of a wide layout staged there.
long long dual_x_scratch(long long n, int lanes, int vpt, int store) {
  using namespace repro_torch;
  if (lanes <= 0 || (lanes > 32 && lanes != kWideThreads)) return -1;
  return 2 * blocks_for(n, lanes) +
         (lanes == kWideThreads ? n * wide_scratch_row(vpt, store) : 0);
}

// K1: launches the slab kernel and the partial-sum pass on `stream` at
// the layout (lanes, vpt, store): a group of `lanes` <= 32 lanes a row,
// each holding `vpt` contiguous values in registers (store 0); or one
// block of 256 threads a row (lanes 256), each holding a chunk of `vpt`
// values where `store` says (0 registers, 1 shared memory, 2 global
// scratch).  Returns cudaGetLastError() (0 on success), or -1 for a
// shape, layout or type it does not take.
int dual_x_launch(int dtype, const void* a, const void* c, const void* dest,
                  const void* mask, const void* ub, const void* s,
                  const void* lam, const void* gamma, void* x,
                  void* scratch, void* cx, void* xsq, long long n, int w,
                  int m, int J, int iters, int lanes, int vpt, int store,
                  void* stream) {
  repro_torch::Args p{a, c, dest, mask, ub, s, lam, gamma, x, nullptr,
                      nullptr, nullptr, n, w, m, J, iters, lanes, vpt,
                      store, 0, (cudaStream_t)stream};
  return repro_torch::launch(dtype, p, cx, xsq, scratch);
}

// K3: K1 plus the (n, w, m) gvals = a ⊙ x in the slab's type (0 on
// padding).
int dual_grad_launch(int dtype, const void* a, const void* c,
                     const void* dest, const void* mask, const void* ub,
                     const void* s, const void* lam, const void* gamma,
                     void* x, void* gvals, void* scratch, void* cx,
                     void* xsq, long long n, int w, int m, int J, int iters,
                     int lanes, int vpt, int store, void* stream) {
  if (gvals == nullptr) return -1;
  repro_torch::Args p{a, c, dest, mask, ub, s, lam, gamma, x, gvals,
                      nullptr, nullptr, n, w, m, J, iters, lanes, vpt,
                      store, 0, (cudaStream_t)stream};
  return repro_torch::launch(dtype, p, cx, xsq, scratch);
}

}  // extern "C"
