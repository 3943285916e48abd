// The gather row-sum of a whole AxPlan, shared by the two Ax kernels:
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
// What bounds it on an H100: device-memory latency and bytes.  Each real
// entry streams edge_idx and mask (and K2's a_dm) once and gathers x (or m
// gvals) at a random index: a 32-byte sector for 4 useful bytes.  x is
// 269 MB on the main path, five times the 50 MB L2, so gathers in plan
// order mostly miss it.  Row widths span five orders of magnitude (4 to
// 262,144 on the main path) and a row's padding can be a third of it.
//
// What the design does about it:
//  - A work table over real entries, built once a plan on the host side of
//    the wrapper (`kernels/ax_reduce.py::plan_work`): each row's extent
//    (its last set mask entry plus one) is cut where its edge indices enter
//    the next band of 2^22 edges, and into items of at most C entries.
//    The items run band by band, so the gathers in flight at one time hit
//    one band of x (16 MB), which L2 holds: each sector of x comes from
//    device memory about once an Ax.  Padding past the extent is never
//    read, and every item is one warp's work, so all buckets of the plan
//    run in one launch that the card balances by real length.
//  - Many gathers in flight: a warp takes its item in tiles of 256
//    entries, 8 a lane.  A lane loads its 8 indices, mask bytes (and K2's
//    a_dm) with 16-byte (mask: 4-byte) streaming loads, evicted first so
//    that L2 keeps x, issues its up to 8 read-only gathers, and only then
//    adds.  A masked entry issues no gather and adds nothing.  The 4-entry
//    groups that reach past the item's end, and every group of a bucket
//    whose rows are not 16-byte aligned (or of an item that starts off a
//    multiple of 4), take the same entries one by one.
//  - A fixed order, no atomics: lane l sums entries q + s·128 + 4l + j
//    (s = 0, 1; j = 0..3) of each tile from the item's start, in that
//    order, tile after tile, then the warp's butterfly.  A row of one item
//    stores straight to ax[k, dest_ids[r]]; a row of several writes one
//    partial an item, and a second launch sums the partials in entry
//    order.  The result is bit-identical from run to run, independent of
//    which load path a group took, and equal to `ref.ax_items_ref`.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kMaxFamilies = 8;   // m <= 8 (the reference's m is 1-4)
constexpr int kMaxBuckets = 32;   // one bucket per power-of-two width
constexpr int kItemThreads = 256; // 8 warps a block, one item a warp
constexpr int kTile = 256;        // entries a warp takes per step, 8 a lane

// The plan's buckets, passed by value (a __grid_constant__ kernel
// parameter, read from the constant bank at the item's bucket index):
// their tensors are not copied.
struct Buckets {
  const int32_t* idx[kMaxBuckets];   // (r, w) edge_idx
  const uint8_t* mask[kMaxBuckets];  // (r, w) mask
  const void* vals[kMaxBuckets];     // K2: (r, w, m) a_dm; K4: unused
  int width[kMaxBuckets];
  unsigned vec;                      // bit b: bucket b takes vector loads
};

// One warp an item: the sum of entries [q0, q1) of one plan row.  items[i]
// = (bucket, row, q0, q1); item_dest[i] = j >= 0 stores to out[k, j], and
// -1 - p writes the p-th partial.
template <typename Src, int M>
__global__ void __launch_bounds__(kItemThreads)
ax_items_kernel(Src src, const __grid_constant__ Buckets bk,
                const int4* __restrict__ items,
                const int32_t* __restrict__ item_dest, int n_items,
                float* __restrict__ out, float* __restrict__ partials,
                int J) {
  using Entry = typename Src::Entry;
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * (kItemThreads / 32) + (threadIdx.x >> 5);
  if (item >= n_items) return;  // whole warps leave together
  const int4 it = __ldg(items + item);
  const int b = it.x;
  const size_t row = (size_t)it.y * (size_t)bk.width[b];
  const int32_t* idx = bk.idx[b] + row;
  const uint8_t* mk = bk.mask[b] + row;
  const void* vals = bk.vals[b];
  const int q1 = it.w;
  int q = it.z;
  float acc[M];
#pragma unroll
  for (int k = 0; k < M; ++k) acc[k] = 0.0f;

  // 4-entry groups wholly inside the item take vector loads when the
  // bucket and the item's start allow them; the rest go one by one.
  const bool vec = ((bk.vec >> b) & 1u) && (q & 3) == 0;
  for (; q < q1; q += kTile) {
    Entry en[8];
    int32_t ix[8];
    bool on[8];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int q4 = q + s * 128 + 4 * lane;
      if (vec && q4 + 4 <= q1) {
        const int4 i4 = __ldcs(reinterpret_cast<const int4*>(idx + q4));
        const unsigned m4 = __ldcs(reinterpret_cast<const unsigned*>(mk + q4));
        ix[4 * s + 0] = i4.x;
        ix[4 * s + 1] = i4.y;
        ix[4 * s + 2] = i4.z;
        ix[4 * s + 3] = i4.w;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          on[4 * s + j] = ((m4 >> (8 * j)) & 0xffu) != 0;
        src.stream4(vals, row + q4, en + 4 * s);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qe = q4 + j;
          on[4 * s + j] = qe < q1 && __ldcs(mk + qe) != 0;
          ix[4 * s + j] = 0;
          if (on[4 * s + j]) {
            ix[4 * s + j] = __ldcs(idx + qe);
            src.stream1(vals, row + qe, en[4 * s + j]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (on[j]) src.gather(ix[j], en[j]);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (on[j]) src.add(en[j], acc);
  }

  const int dst = __ldg(item_dest + item);
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const float v = group_sum<32>(acc[k]);
    if (lane == 0) {
      if (dst >= 0)
        out[(size_t)k * J + dst] = v;
      else
        partials[(size_t)(-1 - dst) * M + k] = v;
    }
  }
}

// Second pass: one thread a (row of several items, family).  multi[i] =
// (j, p0, p1): out[k, j] = Σ_{p0 <= p < p1} partials[p, k], in item order.
__global__ void sum_items_kernel(const int32_t* __restrict__ multi,
                                 int n_multi, int m,
                                 const float* __restrict__ partials,
                                 float* __restrict__ out, int J) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n_multi * m) return;
  const int i = (int)(t / m);
  const int k = (int)(t % m);
  const int j = __ldg(multi + 3 * i);
  const int p0 = __ldg(multi + 3 * i + 1);
  const int p1 = __ldg(multi + 3 * i + 2);
  float v = 0.0f;
  for (int p = p0; p < p1; ++p) v += __ldg(partials + (size_t)p * m + k);
  out[(size_t)k * J + j] = v;
}

inline bool aligned(const void* p, uintptr_t bytes) {
  return ((uintptr_t)p % bytes) == 0;
}

// Fills `bk` from the wrapper's per-bucket arrays (`vals` may be null).  A
// bucket takes vector loads when its rows are a multiple of 4 entries and
// its tensors are 16-byte aligned (the mask 4-byte).  -1 for too many
// buckets.
inline int fill_buckets(Buckets& bk, int nb, const void* const* idx,
                        const void* const* mask, const void* const* vals,
                        const int* widths) {
  if (nb < 0 || nb > kMaxBuckets) return -1;
  memset(&bk, 0, sizeof(bk));
  for (int b = 0; b < nb; ++b) {
    bk.idx[b] = (const int32_t*)idx[b];
    bk.mask[b] = (const uint8_t*)mask[b];
    bk.vals[b] = vals ? vals[b] : nullptr;
    bk.width[b] = widths[b];
    const bool vec = widths[b] % 4 == 0 && aligned(idx[b], 16) &&
                     aligned(mask[b], 4) && (!vals || aligned(vals[b], 16));
    if (vec) bk.vec |= 1u << b;
  }
  return 0;
}

// Calls f(std::integral_constant<int, m>) for m in 1..kMaxFamilies; -1
// otherwise.
template <typename F>
int with_families(int m, F&& f) {
  switch (m) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    case 8: return f(std::integral_constant<int, 8>{});
  }
  return -1;
}

// Launches one Ax on `st`: the item launch, then the second pass when a
// row has several items.  Returns cudaGetLastError().
template <int M, typename Src>
int launch_items(Src src, const Buckets& bk, const void* items,
                 const void* item_dest, int n_items, const void* multi,
                 int n_multi, void* out, void* partials, int J,
                 cudaStream_t st) {
  if (n_items < 0 || n_multi < 0) return -1;
  if (n_items > 0) {
    const int per_block = kItemThreads / 32;
    ax_items_kernel<Src, M><<<(n_items + per_block - 1) / per_block,
                              kItemThreads, 0, st>>>(
        src, bk, (const int4*)items, (const int32_t*)item_dest, n_items,
        (float*)out, (float*)partials, J);
  }
  if (n_multi > 0) {
    const long long work = (long long)n_multi * M;
    sum_items_kernel<<<(int)((work + 255) / 256), 256, 0, st>>>(
        (const int32_t*)multi, n_multi, M, (const float*)partials,
        (float*)out, J);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch
