// ax_reduce_x: the value-carrying Ax reduction of one AxPlan bucket,
//
//   ax[k, dest_ids[r]] = Σ_q mask[r,q] · a_dm[r,q,k] · x[edge_idx[r,q]],
//
// the product formed in the input type and the sum kept in float32.
//
// Replaces the Pallas kernel `_ax_reduce_x_kernel` / `ax_reduce_bucket_x`
// of src/repro/kernels/ax_reduce.py.  Each destination owns exactly one
// plan row, so the kernel stores straight to ax[k, dest_ids[r]] of the
// (m, J) result: the reference's separate `inv_perm` gather
// (kernels/ops.py:164) is gone.
//
// What bounds it on an H100: device-memory bytes, and latency on the
// widest rows.  Each plan entry streams a_dm, edge_idx and mask once
// (9 bytes at float32, m = 1) plus a 4-byte gather of x, which is random
// but mostly served from L2 (x is 4·E bytes).  A handful of operations an
// entry is far below the memory line.  Row widths span five orders of
// magnitude (4 to 131,072 and beyond on the main path), so one warp per
// row would leave the widest row to a single warp's dependent loads while
// the card idles.
//
// What the design does about it: the threads a row gets follow the
// bucket's width.  Rows up to 1,024 wide get one warp (lanes stride over
// the row, a coalesced stream of a_dm/edge_idx/mask, warp butterfly sum).
// Wider rows are cut into chunks of 8,192 entries, each chunk a block of
// 256 threads (32 entries a thread) reduced in shared memory in a fixed
// order.  A row of one chunk is stored directly; a row of several writes
// one partial a chunk to a scratch vector and a second pass sums them in
// chunk order.  No atomics: the result is bit-identical run to run.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kMaxFamilies = 8;   // m <= 8 (the reference's m is 1-4)
constexpr int kWarpRowsMax = 1024;
constexpr int kBlockThreads = 256;
constexpr int kChunk = 8192;

template <typename T>
__device__ __forceinline__ void accumulate(const T* __restrict__ x,
                                           const T* __restrict__ a_dm,
                                           const int32_t* __restrict__ idx,
                                           const uint8_t* __restrict__ mask,
                                           size_t e, int m,
                                           float (&acc)[kMaxFamilies]) {
  if (mask[e] == 0) return;
  const T xv = x[idx[e]];
#pragma unroll
  for (int k = 0; k < kMaxFamilies; ++k)
    if (k < m) acc[k] += mul_in_type(a_dm[e * (size_t)m + k], xv);
}

// One warp a row: rows of width <= 1024.
template <typename T>
__global__ void __launch_bounds__(256)
ax_rows_warp_kernel(const T* __restrict__ x, const T* __restrict__ a_dm,
                    const int32_t* __restrict__ idx,
                    const uint8_t* __restrict__ mask,
                    const int32_t* __restrict__ dest_ids,
                    float* __restrict__ out, int r, int w, int m, int J) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) +
                        (threadIdx.x >> 5);
  if (row >= r) return;  // whole warps leave together
  float acc[kMaxFamilies];
#pragma unroll
  for (int k = 0; k < kMaxFamilies; ++k) acc[k] = 0.0f;
  for (int q = lane; q < w; q += 32)
    accumulate<T>(x, a_dm, idx, mask, (size_t)row * (size_t)w + q, m, acc);
#pragma unroll
  for (int k = 0; k < kMaxFamilies; ++k) {
    if (k < m) {
      const float v = group_sum<32>(acc[k]);
      if (lane == 0) out[(size_t)k * J + dest_ids[row]] = v;
    }
  }
}

// One block a chunk of kChunk entries of one row: rows wider than 1024.
// With one chunk a row the block stores the result; otherwise it writes its
// partial to partials[(row * splits + chunk) * m + k].
template <typename T>
__global__ void __launch_bounds__(kBlockThreads)
ax_rows_block_kernel(const T* __restrict__ x, const T* __restrict__ a_dm,
                     const int32_t* __restrict__ idx,
                     const uint8_t* __restrict__ mask,
                     const int32_t* __restrict__ dest_ids,
                     float* __restrict__ out, float* __restrict__ partials,
                     int w, int m, int J, int splits) {
  const long long row = blockIdx.x / splits;
  const int chunk = blockIdx.x % splits;
  const int q0 = chunk * kChunk;
  const int q1 = min(w, q0 + kChunk);
  float acc[kMaxFamilies];
#pragma unroll
  for (int k = 0; k < kMaxFamilies; ++k) acc[k] = 0.0f;
  for (int q = q0 + threadIdx.x; q < q1; q += kBlockThreads)
    accumulate<T>(x, a_dm, idx, mask, (size_t)row * (size_t)w + q, m, acc);

  __shared__ float sh[kMaxFamilies][kBlockThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kMaxFamilies; ++k) {
    if (k < m) {
      const float v = group_sum<32>(acc[k]);
      if (lane == 0) sh[k][warp] = v;
    }
  }
  __syncthreads();
  if ((int)threadIdx.x < m) {
    const int k = threadIdx.x;
    float v = 0.0f;
    for (int i = 0; i < kBlockThreads / 32; ++i) v += sh[k][i];
    if (splits == 1)
      out[(size_t)k * J + dest_ids[row]] = v;
    else
      partials[((size_t)row * splits + chunk) * m + k] = v;
  }
}

// Second pass for multi-chunk rows: one thread a (row, family).
__global__ void sum_chunks_kernel(const float* __restrict__ partials,
                                  const int32_t* __restrict__ dest_ids,
                                  float* __restrict__ out, int r, int m,
                                  int J, int splits) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)r * m) return;
  const long long row = t / m;
  const int k = (int)(t % m);
  float v = 0.0f;
  for (int c = 0; c < splits; ++c)
    v += partials[((size_t)row * splits + c) * m + k];
  out[(size_t)k * J + dest_ids[row]] = v;
}

int splits_for(int w) { return (w + kChunk - 1) / kChunk; }

template <typename T>
void launch(const void* x, const void* a_dm, const void* idx,
            const void* mask, const void* dest_ids, void* out, void* scratch,
            int r, int w, int m, int J, cudaStream_t st) {
  if (w <= kWarpRowsMax) {
    const int rows_per_block = 256 / 32;
    const int nb = (r + rows_per_block - 1) / rows_per_block;
    ax_rows_warp_kernel<T><<<nb, 256, 0, st>>>(
        (const T*)x, (const T*)a_dm, (const int32_t*)idx,
        (const uint8_t*)mask, (const int32_t*)dest_ids, (float*)out, r, w, m,
        J);
    return;
  }
  const int splits = splits_for(w);
  ax_rows_block_kernel<T><<<r * splits, kBlockThreads, 0, st>>>(
      (const T*)x, (const T*)a_dm, (const int32_t*)idx, (const uint8_t*)mask,
      (const int32_t*)dest_ids, (float*)out, (float*)scratch, w, m, J,
      splits);
  if (splits > 1) {
    const long long work = (long long)r * m;
    sum_chunks_kernel<<<(int)((work + 255) / 256), 256, 0, st>>>(
        (const float*)scratch, (const int32_t*)dest_ids, (float*)out, r, m,
        J, splits);
  }
}

}  // namespace
}  // namespace repro_torch

extern "C" {

int ax_reduce_x_max_families() { return repro_torch::kMaxFamilies; }

// Length of the float scratch vector `ax_reduce_x_launch` needs (0: none).
long long ax_reduce_x_scratch(int r, int w, int m) {
  using namespace repro_torch;
  if (w <= kWarpRowsMax || splits_for(w) == 1) return 0;
  return (long long)r * splits_for(w) * m;
}

// Launches the bucket reduction on `stream`, writing columns dest_ids of
// the (m, J) float32 `out`.  Returns cudaGetLastError() (0 on success), or
// -1 for a shape it does not take.
int ax_reduce_x_launch(int dtype, const void* x, const void* a_dm,
                       const void* idx, const void* mask,
                       const void* dest_ids, void* out, void* scratch, int r,
                       int w, int m, int J, void* stream) {
  using namespace repro_torch;
  if (r <= 0 || w <= 0 || m <= 0 || m > kMaxFamilies) return -1;
  if ((long long)r * splits_for(w) > 0x7fffffffLL) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kFloat32)
    launch<float>(x, a_dm, idx, mask, dest_ids, out, scratch, r, w, m, J, st);
  else if (dtype == kBFloat16)
    launch<__nv_bfloat16>(x, a_dm, idx, mask, dest_ids, out, scratch, r, w, m,
                          J, st);
  else
    return -1;
  return (int)cudaGetLastError();
}

}  // extern "C"
