// ax_reduce_x (K2): the value-carrying Ax reduction of one AxPlan bucket,
//
//   ax[k, dest_ids[r]] = Σ_q mask[r,q] · a_dm[r,q,k] · x[edge_idx[r,q]],
//
// the product formed in the input type and the sum kept in float32.
//
// Replaces the Pallas kernel `_ax_reduce_x_kernel` / `ax_reduce_bucket_x`
// of src/repro/kernels/ax_reduce.py.  The row sums, what bounds them and
// the design are those of ax_rows.cuh; this file says only what one plan
// entry contributes: one gather of x, m products with the plan's static
// a_dm copy.
#include "ax_rows.cuh"

namespace repro_torch {
namespace {

template <typename T>
struct XSrc {
  const T* __restrict__ x;
  const T* __restrict__ a_dm;
  const int32_t* __restrict__ idx;

  __device__ __forceinline__ void add(size_t e, int m,
                                      float (&acc)[kMaxFamilies]) const {
    const T xv = x[idx[e]];
#pragma unroll
    for (int k = 0; k < kMaxFamilies; ++k)
      if (k < m) acc[k] += mul_in_type(a_dm[e * (size_t)m + k], xv);
  }
};

template <typename T>
int launch(const void* x, const void* a_dm, const void* idx,
           const void* mask, const void* dest_ids, void* out, void* scratch,
           int r, int w, int m, int J, cudaStream_t st) {
  XSrc<T> src{(const T*)x, (const T*)a_dm, (const int32_t*)idx};
  return launch_rows(src, mask, dest_ids, out, scratch, r, w, m, J, st);
}

}  // namespace
}  // namespace repro_torch

extern "C" {

int ax_reduce_x_max_families() { return repro_torch::kMaxFamilies; }

// Length of the float scratch vector `ax_reduce_x_launch` needs (0: none).
long long ax_reduce_x_scratch(int r, int w, int m) {
  return repro_torch::rows_scratch(r, w, m);
}

// Launches the bucket reduction on `stream`, writing columns dest_ids of
// the (m, J) float32 `out`.  Returns cudaGetLastError() (0 on success), or
// -1 for a shape or type it does not take.
int ax_reduce_x_launch(int dtype, const void* x, const void* a_dm,
                       const void* idx, const void* mask,
                       const void* dest_ids, void* out, void* scratch, int r,
                       int w, int m, int J, void* stream) {
  using namespace repro_torch;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kFloat32)
    return launch<float>(x, a_dm, idx, mask, dest_ids, out, scratch, r, w, m,
                         J, st);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(x, a_dm, idx, mask, dest_ids, out, scratch,
                                 r, w, m, J, st);
  return -1;
}

}  // extern "C"
