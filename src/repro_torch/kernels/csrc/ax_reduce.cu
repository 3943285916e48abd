// ax_reduce (K4): the gvals-consuming Ax reduction of one index-only
// AxPlan bucket,
//
//   ax[k, dest_ids[r]] = Σ_q mask[r,q] · gvals[edge_idx[r,q], k],
//
// over the materialized (E, m) per-edge gradient values, summed in
// float32.
//
// Replaces the Pallas kernel `_ax_reduce_kernel` / `ax_reduce_bucket` of
// src/repro/kernels/ax_reduce.py (the `aligned_gvals` mode).  The row
// sums, what bounds them and the design are those of ax_rows.cuh, shared
// with K2 (ax_reduce_x.cu): the same threads a row and the same order of
// the sums.  At float32 the gvals K3 writes are the products K2 forms, so
// `aligned_gvals` gives `aligned`'s Ax bit for bit.  This file says only
// what one plan entry contributes: one gather of the entry's m gvals.
#include "ax_rows.cuh"

namespace repro_torch {
namespace {

template <typename T>
struct GSrc {
  const T* __restrict__ g;
  const int32_t* __restrict__ idx;

  __device__ __forceinline__ void add(size_t e, int m,
                                      float (&acc)[kMaxFamilies]) const {
    const size_t base = (size_t)idx[e] * (size_t)m;
#pragma unroll
    for (int k = 0; k < kMaxFamilies; ++k)
      if (k < m) acc[k] += to_float(g[base + k]);
  }
};

template <typename T>
int launch(const void* g, const void* idx, const void* mask,
           const void* dest_ids, void* out, void* scratch, int r, int w,
           int m, int J, cudaStream_t st) {
  GSrc<T> src{(const T*)g, (const int32_t*)idx};
  return launch_rows(src, mask, dest_ids, out, scratch, r, w, m, J, st);
}

}  // namespace
}  // namespace repro_torch

extern "C" {

int ax_reduce_max_families() { return repro_torch::kMaxFamilies; }

// Length of the float scratch vector `ax_reduce_launch` needs (0: none).
long long ax_reduce_scratch(int r, int w, int m) {
  return repro_torch::rows_scratch(r, w, m);
}

// Launches the bucket reduction on `stream`, writing columns dest_ids of
// the (m, J) float32 `out`.  Returns cudaGetLastError() (0 on success), or
// -1 for a shape or type it does not take.
int ax_reduce_launch(int dtype, const void* g, const void* idx,
                     const void* mask, const void* dest_ids, void* out,
                     void* scratch, int r, int w, int m, int J,
                     void* stream) {
  using namespace repro_torch;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kFloat32)
    return launch<float>(g, idx, mask, dest_ids, out, scratch, r, w, m, J,
                         st);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(g, idx, mask, dest_ids, out, scratch, r, w,
                                 m, J, st);
  return -1;
}

}  // extern "C"
