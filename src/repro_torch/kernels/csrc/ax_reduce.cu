// ax_reduce (K4): the gvals-consuming Ax reduction of a whole index-only
// AxPlan,
//
//   ax[k, dest_ids[r]] = Σ_q mask[r,q] · gvals[edge_idx[r,q], k],
//
// over the materialized (E, m) per-edge gradient values, summed in
// float32.
//
// Replaces the Pallas kernel `_ax_reduce_kernel` / `ax_reduce_bucket` of
// src/repro/kernels/ax_reduce.py (the `aligned_gvals` mode), which runs
// once a bucket; here one launch (plus the second pass) takes every
// bucket.  The row sums, what bounds them and the design are those of
// ax_rows.cuh, shared with K2 (ax_reduce_x.cu): the same work table and
// the same order of the sums.  At float32 the gvals K3 writes are the
// products K2 forms, so `aligned_gvals` gives `aligned`'s Ax bit for bit.
// This file says only what one plan entry contributes: one gather of the
// entry's M gvals, a vector load when gvals is 16-byte aligned.
#include "ax_rows.cuh"

namespace repro_torch {
namespace {

template <typename T, int M>
struct GSrc {
  const T* __restrict__ g;
  bool vec;

  struct Entry {
    T v[M];
  };

  // nothing streams beside edge_idx
  __device__ __forceinline__ void stream4(const void*, size_t, Entry*) const {}
  __device__ __forceinline__ void stream1(const void*, size_t, Entry&) const {}

  __device__ __forceinline__ void gather(int32_t i, Entry& en) const {
    const T* p = g + (size_t)i * M;
    if (vec) {
      ld_vec<false>(p, en.v);
    } else {
#pragma unroll
      for (int k = 0; k < M; ++k) en.v[k] = __ldg(p + k);
    }
  }

  __device__ __forceinline__ void add(const Entry& en,
                                      float (&acc)[M]) const {
#pragma unroll
    for (int k = 0; k < M; ++k) acc[k] += to_float(en.v[k]);
  }
};

template <typename T>
int launch(int m, const void* g, const Buckets& bk, const void* items,
           const void* item_dest, int n_items, const void* multi,
           int n_multi, void* out, void* partials, int J, cudaStream_t st) {
  return with_families(m, [&](auto fam) {
    constexpr int M = decltype(fam)::value;
    GSrc<T, M> src{(const T*)g, aligned(g, 16)};
    return launch_items<M>(src, bk, items, item_dest, n_items, multi,
                           n_multi, out, partials, J, st);
  });
}

}  // namespace
}  // namespace repro_torch

extern "C" {

int ax_reduce_max_families() { return repro_torch::kMaxFamilies; }

int ax_reduce_max_buckets() { return repro_torch::kMaxBuckets; }

// One Ax of an index-only plan on `stream`, writing the (m, J) float32
// `out` at every destination of the plan.  Bucket b is edge_idx[b],
// mask[b] of width widths[b]; items, item_dest, multi and partials as in
// `ax_reduce_x_launch`.  Returns cudaGetLastError() (0 on success), or -1
// for a shape or type it does not take.
int ax_reduce_launch(int dtype, int m, const void* g, int nb,
                     const void* const* edge_idx, const void* const* mask,
                     const int* widths, const void* items,
                     const void* item_dest, int n_items, const void* multi,
                     int n_multi, void* out, void* partials, int J,
                     void* stream) {
  using namespace repro_torch;
  Buckets bk;
  if (fill_buckets(bk, nb, edge_idx, mask, nullptr, widths) != 0) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kFloat32)
    return launch<float>(m, g, bk, items, item_dest, n_items, multi,
                         n_multi, out, partials, J, st);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(m, g, bk, items, item_dest, n_items, multi,
                                 n_multi, out, partials, J, st);
  return -1;
}

}  // extern "C"
