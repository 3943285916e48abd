// The gather row-sum of one AxPlan bucket, shared by the two Ax kernels:
//
//   ax[k, dest_ids[r]] = Σ_q mask[r,q] · term(r, q, k),   summed in float32,
//
// where `Src` says what one plan entry contributes:
//   ax_reduce_x.cu (K2)  term = a_dm[r,q,k] · x[edge_idx[r,q]]
//                        (the product formed in the input type)
//   ax_reduce.cu   (K4)  term = gvals[edge_idx[r,q], k]
// At float32 K4's gvals = a ⊙ x are the very products K2 forms, and both
// sum them in this one order, so the two give the same Ax bit for bit.
//
// What bounds it on an H100: device-memory bytes, and latency on the
// widest rows.  Each plan entry streams edge_idx and mask once (and K2's
// a_dm) plus a gather of x or of m gvals, which is random but partly
// served from L2.  A handful of operations an entry is far below the
// memory line.  Row widths span five orders of magnitude (4 to 262,144 on
// the main path), so one warp per row would leave the widest row to a
// single warp's dependent loads while the card idles.
//
// What the design does about it: the threads a row gets follow the
// bucket's width.  Rows up to 1,024 wide get one warp (lanes stride over
// the row, a coalesced stream of the plan, warp butterfly sum).  Wider
// rows are cut into chunks of 8,192 entries, each chunk a block of 256
// threads (32 entries a thread) reduced in shared memory in a fixed
// order.  A row of one chunk is stored directly; a row of several writes
// one partial a chunk to a scratch vector and a second pass sums them in
// chunk order.  Each destination owns exactly one plan row, so the
// result goes straight to ax[k, dest_ids[r]] of the (m, J) output: the
// reference's `inv_perm` gather is gone.  No atomics: the result is
// bit-identical run to run.
#pragma once

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kMaxFamilies = 8;   // m <= 8 (the reference's m is 1-4)
constexpr int kWarpRowsMax = 1024;
constexpr int kBlockThreads = 256;
constexpr int kChunk = 8192;

// One warp a row: rows of width <= 1024.
template <typename Src>
__global__ void __launch_bounds__(256)
ax_rows_warp_kernel(Src src, const uint8_t* __restrict__ mask,
                    const int32_t* __restrict__ dest_ids,
                    float* __restrict__ out, int r, int w, int m, int J) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) +
                        (threadIdx.x >> 5);
  if (row >= r) return;  // whole warps leave together
  float acc[kMaxFamilies];
#pragma unroll
  for (int k = 0; k < kMaxFamilies; ++k) acc[k] = 0.0f;
  for (int q = lane; q < w; q += 32) {
    const size_t e = (size_t)row * (size_t)w + q;
    if (mask[e] != 0) src.add(e, m, acc);
  }
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
template <typename Src>
__global__ void __launch_bounds__(kBlockThreads)
ax_rows_block_kernel(Src src, const uint8_t* __restrict__ mask,
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
  for (int q = q0 + threadIdx.x; q < q1; q += kBlockThreads) {
    const size_t e = (size_t)row * (size_t)w + q;
    if (mask[e] != 0) src.add(e, m, acc);
  }

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

// Length of the float scratch vector a bucket needs (0: none).
long long rows_scratch(int r, int w, int m) {
  if (w <= kWarpRowsMax || splits_for(w) == 1) return 0;
  return (long long)r * splits_for(w) * m;
}

// Launches the bucket reduction on `st`; -1 for a shape it does not take,
// else cudaGetLastError().
template <typename Src>
int launch_rows(Src src, const void* mask, const void* dest_ids, void* out,
                void* scratch, int r, int w, int m, int J, cudaStream_t st) {
  if (r <= 0 || w <= 0 || m <= 0 || m > kMaxFamilies) return -1;
  if ((long long)r * splits_for(w) > 0x7fffffffLL) return -1;
  const uint8_t* mk = (const uint8_t*)mask;
  const int32_t* dest = (const int32_t*)dest_ids;
  if (w <= kWarpRowsMax) {
    const int rows_per_block = 256 / 32;
    const int nb = (r + rows_per_block - 1) / rows_per_block;
    ax_rows_warp_kernel<Src><<<nb, 256, 0, st>>>(src, mk, dest, (float*)out,
                                                 r, w, m, J);
    return (int)cudaGetLastError();
  }
  const int splits = splits_for(w);
  ax_rows_block_kernel<Src><<<r * splits, kBlockThreads, 0, st>>>(
      src, mk, dest, (float*)out, (float*)scratch, w, m, J, splits);
  if (splits > 1) {
    const long long work = (long long)r * m;
    sum_chunks_kernel<<<(int)((work + 255) / 256), 256, 0, st>>>(
        (const float*)scratch, dest, (float*)out, r, m, J, splits);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch
