// ax_reduce_x (K2): the value-carrying Ax reduction of a whole AxPlan,
//
//   ax[k, dest_ids[r]] = Σ_q mask[r,q] · a_dm[r,q,k] · x[edge_idx[r,q]],
//
// the product formed in the input type and the sum kept in float32.
//
// Replaces the Pallas kernel `_ax_reduce_x_kernel` / `ax_reduce_bucket_x`
// of src/repro/kernels/ax_reduce.py, which runs once a bucket; here one
// launch (plus the second pass) takes every bucket.  The row sums, what
// bounds them and the design are those of ax_rows.cuh; this file says
// only what one plan entry contributes: one gather of x, M products with
// the plan's static a_dm copy, which streams beside edge_idx.
#include "ax_rows.cuh"

namespace repro_torch {
namespace {

template <typename T, int M>
struct XSrc {
  const T* __restrict__ x;

  struct Entry {
    T a[M];
    T v;
  };

  // a_dm of the four entries e..e+3 of a bucket, by vector loads
  __device__ __forceinline__ void stream4(const void* vals, size_t e,
                                          Entry* en) const {
    T a[4 * M];
    ld_vec<true>(static_cast<const T*>(vals) + e * M, a);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < M; ++k) en[j].a[k] = a[j * M + k];
  }

  __device__ __forceinline__ void stream1(const void* vals, size_t e,
                                          Entry& en) const {
    const T* a = static_cast<const T*>(vals) + e * M;
#pragma unroll
    for (int k = 0; k < M; ++k) en.a[k] = ld<true>(a + k);
  }

  __device__ __forceinline__ void gather(int32_t i, Entry& en) const {
    en.v = __ldg(x + i);
  }

  __device__ __forceinline__ void add(const Entry& en,
                                      float (&acc)[M]) const {
#pragma unroll
    for (int k = 0; k < M; ++k) acc[k] += mul_in_type(en.a[k], en.v);
  }
};

template <typename T>
int launch(int m, const void* x, const Buckets& bk, const void* items,
           const void* item_dest, int n_items, const void* multi,
           int n_multi, void* out, void* partials, int J, cudaStream_t st) {
  return with_families(m, [&](auto fam) {
    constexpr int M = decltype(fam)::value;
    XSrc<T, M> src{(const T*)x};
    return launch_items<M>(src, bk, items, item_dest, n_items, multi,
                           n_multi, out, partials, J, st);
  });
}

}  // namespace
}  // namespace repro_torch

extern "C" {

int ax_reduce_x_max_families() { return repro_torch::kMaxFamilies; }

int ax_reduce_x_max_buckets() { return repro_torch::kMaxBuckets; }

// One Ax of a value-carrying plan on `stream`, writing the (m, J) float32
// `out` at every destination of the plan.  Bucket b is edge_idx[b],
// mask[b], a_dm[b] of width widths[b]; items (n_items, 4), item_dest
// (n_items,) and multi (n_multi, 3) are the work table, `partials` its
// float scratch (num_partials x m).  Returns cudaGetLastError() (0 on
// success), or -1 for a shape or type it does not take.
int ax_reduce_x_launch(int dtype, int m, const void* x, int nb,
                       const void* const* edge_idx, const void* const* mask,
                       const void* const* a_dm, const int* widths,
                       const void* items, const void* item_dest, int n_items,
                       const void* multi, int n_multi, void* out,
                       void* partials, int J, void* stream) {
  using namespace repro_torch;
  Buckets bk;
  if (fill_buckets(bk, nb, edge_idx, mask, a_dm, widths) != 0) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kFloat32)
    return launch<float>(m, x, bk, items, item_dest, n_items, multi,
                         n_multi, out, partials, J, st);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(m, x, bk, items, item_dest, n_items, multi,
                                 n_multi, out, partials, J, st);
  return -1;
}

}  // extern "C"
