// EmbeddingBag (weighted row sums of a table) for Hopper (sm_90a):
//
//   out[b, :] = sum_j w[b, j] * table[idx[b, j], :]       idx < 0 = pad
//   mean mode: out[b, :] /= max(sum_j w[b, j] * (idx[b, j] >= 0), 1e-9)
//
// Replaces the Pallas TPU kernel `embedding_bag_pallas` (body
// `_bag_kernel`) in src/repro/kernels/embedding_bag/kernel.py, and the
// reference ops.py's mean-mode division.  Same function: a pad reads row
// 0 with weight 0, so an all-pad bag gives 0; without weights every
// weight is 1.  table (V, D) and w (B, L) are fp32 or bf16 (one type; the
// wrapper casts w to the table's), idx (B, L) int32 or int64, out (B, D)
// in the table's type.  Sums are taken in fp32, in index order, and
// rounded once.
//
// Bound: bytes.  The function must read the indices and weights once,
// each referenced row once and write B*D*s; it does two flops per
// element read, far below the card's compute-to-bandwidth ratio.  What
// limits a gather of short random rows is the number of row loads in
// flight, so the design is about keeping many of them outstanding:
//
// - A group of g lanes (g = 4..32, the power of two at or above the
//   row's vector count, capped at 32) serves `per_group` consecutive
//   bags; a warp holds 32 / g groups.  A lane owns one vector of V bytes
//   (16, 8 or 4 bytes, or one element: the widest that divides the row
//   stride and the pointers' alignment, chosen by the wrapper) and walks
//   the row in slices of g vectors when it has more than 32.
// - The group's positions (its bags' indices, contiguous in idx) are
//   staged 32 at a time in shared memory with their weights; the group
//   then issues kUnroll independent row loads before any FMA.  A group
//   walks positions across bag boundaries, so one-index bags (SASRec's
//   lookups: per_group = kUnroll) keep kUnroll rows in flight too.
// - The FMAs run in index order, as the previous one-bag-per-warp kernel
//   did, so a one-index bag is its row bit for bit and an all-pad bag an
//   exact 0; mean mode sums the effective weights beside the rows and
//   divides once before the single store.
// - Every non-pad index is checked against V on the device; an index
//   >= V executes __trap(), which ends the context with a CUDA error at
//   the next synchronisation (as F.embedding_bag's device assert does).
//   The wrapper reads nothing back from the card.
//
// No atomics; 64-bit offsets.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "vec.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMinGroup = 4;          // lanes per group, at least
constexpr int kUnroll = 8;            // row loads in flight per group
constexpr int kStage = 32;            // positions staged per group at once
constexpr int kStride = kStage + 1;   // per-group shared stride (banks)

template <typename T, typename I, int V, bool kMean>
__global__ void __launch_bounds__(kThreads)
bag_kernel(const T* __restrict__ table, const I* __restrict__ idx,
           const T* __restrict__ w, T* __restrict__ out, int64_t n_bags,
           int l, int nv, int g, int per_group, int64_t n_rows) {
  constexpr int kE = V / static_cast<int>(sizeof(T));
  __shared__ int32_t s_rows[kThreads / kMinGroup * kStride];
  __shared__ float s_wts[kThreads / kMinGroup * kStride];
  const int lane = threadIdx.x & 31;
  const int sub = lane & (g - 1);
  const int grp = threadIdx.x / g;
  const unsigned mask = vec::group_mask(lane, g);
  int32_t* s_r = s_rows + grp * kStride;
  float* s_w = s_wts + grp * kStride;
  const int64_t bag0 =
      (static_cast<int64_t>(blockIdx.x) * (kThreads / g) + grp) * per_group;
  if (bag0 >= n_bags) return;                 // the whole group leaves
  const int64_t bag_end =
      bag0 + per_group < n_bags ? bag0 + per_group : n_bags;
  const int64_t p0 = bag0 * l, p1 = bag_end * l;
  const int64_t d = static_cast<int64_t>(nv) * kE;

  for (int base = 0; base < nv; base += g) {
    const int c = base + sub;
    const bool col_ok = c < nv;
    float acc[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[e] = 0.f;
    float wsum = 0.f;
    int left = l;
    int64_t bag = bag0;
    for (int64_t q = p0; q < p1; q += kStage) {
      const int cnt = static_cast<int>(p1 - q < kStage ? p1 - q : kStage);
      __syncwarp(mask);                       // the last stage is consumed
      for (int j = sub; j < cnt; j += g) {
        const int64_t r = static_cast<int64_t>(idx[q + j]);
        const bool pad = r < 0;
        if (!pad && r >= n_rows) __trap();    // index past the table
        s_r[j] = pad ? -1 : static_cast<int32_t>(r);
        s_w[j] = pad ? 0.f : (w ? vec::to_f32(w[q + j]) : 1.f);
      }
      __syncwarp(mask);
      for (int j0 = 0; j0 < cnt; j0 += kUnroll) {
        vec::Cols<T, kE> rows[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int j = j0 + u;
          if (j < cnt && col_ok) {
            const int64_t r = max(s_r[j], 0);  // a pad reads row 0
            rows[u].load(table + r * d + static_cast<int64_t>(c) * kE);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (j0 + u < cnt) {
            const float wt = s_w[j0 + u];
            if (col_ok) {
#pragma unroll
              for (int e = 0; e < kE; ++e)
                acc[e] = fmaf(rows[u].get(e), wt, acc[e]);
            }
            if (kMean) wsum += wt;
            if (--left == 0) {                // the bag's last position
              if (col_ok) {
                if (kMean) {
                  const float den = fmaxf(wsum, 1e-9f);
#pragma unroll
                  for (int e = 0; e < kE; ++e) acc[e] = acc[e] / den;
                }
                vec::store_cols<T, kE>(
                    out + bag * d + static_cast<int64_t>(c) * kE, acc);
              }
#pragma unroll
              for (int e = 0; e < kE; ++e) acc[e] = 0.f;
              wsum = 0.f;
              left = l;
              ++bag;
            }
          }
        }
      }
    }
  }
}

template <typename T, typename I, int V>
int launch(const void* table, const void* idx, const void* w, void* out,
           int64_t n_bags, int l, int nv, int g, int per_group,
           int64_t n_rows, bool mean, cudaStream_t stream) {
  const int64_t per_block = static_cast<int64_t>(kThreads / g) * per_group;
  const unsigned blocks =
      static_cast<unsigned>((n_bags + per_block - 1) / per_block);
  const T* t = static_cast<const T*>(table);
  const I* ix = static_cast<const I*>(idx);
  const T* wt = static_cast<const T*>(w);
  T* o = static_cast<T*>(out);
  if (mean)
    bag_kernel<T, I, V, true><<<blocks, kThreads, 0, stream>>>(
        t, ix, wt, o, n_bags, l, nv, g, per_group, n_rows);
  else
    bag_kernel<T, I, V, false><<<blocks, kThreads, 0, stream>>>(
        t, ix, wt, o, n_bags, l, nv, g, per_group, n_rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename I>
int by_vec(int vec_bytes, const void* table, const void* idx, const void* w,
           void* out, int64_t n_bags, int l, int d, int g, int per_group,
           int64_t n_rows, bool mean, cudaStream_t s) {
  const int nv = d * static_cast<int>(sizeof(T)) / vec_bytes;
  switch (vec_bytes) {
    case 16:
      return launch<T, I, 16>(table, idx, w, out, n_bags, l, nv, g,
                              per_group, n_rows, mean, s);
    case 8:
      return launch<T, I, 8>(table, idx, w, out, n_bags, l, nv, g,
                             per_group, n_rows, mean, s);
    case 4:
      return launch<T, I, 4>(table, idx, w, out, n_bags, l, nv, g,
                             per_group, n_rows, mean, s);
    case 2:
      if constexpr (sizeof(T) == 2)
        return launch<T, I, 2>(table, idx, w, out, n_bags, l, nv, g,
                               per_group, n_rows, mean, s);
      break;
    default:
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int by_index(int idx64, int vec_bytes, const void* table, const void* idx,
             const void* w, void* out, int64_t n_bags, int l, int d, int g,
             int per_group, int64_t n_rows, bool mean, cudaStream_t s) {
  if (idx64)
    return by_vec<T, int64_t>(vec_bytes, table, idx, w, out, n_bags, l, d, g,
                              per_group, n_rows, mean, s);
  return by_vec<T, int32_t>(vec_bytes, table, idx, w, out, n_bags, l, d, g,
                            per_group, n_rows, mean, s);
}

}  // namespace

// Plain C interface (loaded with ctypes).  Launches on the given stream,
// does not synchronise, and returns cudaGetLastError() (0 if none), or
// cudaErrorInvalidValue for a width or group the kernel does not take.
// w may be null (every weight 1).  dtype: 0 = fp32, 1 = bf16; idx64: 0 =
// int32 indices, 1 = int64; vec_bytes: 16, 8, 4 or the element size,
// dividing both d * element size and the pointers' alignment; group: a
// power of two in [4, 32]; per_group >= 1 bags per group; mean: 0 = sum,
// 1 = mean.  Needs n_bags >= 1, l >= 1 and n_rows < 2^31.
extern "C" int embedding_bag(const void* table, const void* idx,
                             const void* w, void* out, int64_t n_bags,
                             int32_t l, int32_t d, int64_t n_rows,
                             int32_t dtype, int32_t idx64, int32_t vec_bytes,
                             int32_t group, int32_t per_group, int32_t mean,
                             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (group < kMinGroup || group > 32 || (group & (group - 1)) ||
      per_group < 1 || vec_bytes < 2 || vec_bytes > 16 ||
      (d * (dtype == 0 ? 4 : 2)) % vec_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return by_index<float>(idx64, vec_bytes, table, idx, w, out, n_bags, l,
                           d, group, per_group, n_rows, mean != 0, s);
  return by_index<__nv_bfloat16>(idx64, vec_bytes, table, idx, w, out, n_bags,
                                 l, d, group, per_group, n_rows, mean != 0,
                                 s);
}
