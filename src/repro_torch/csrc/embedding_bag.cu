// EmbeddingBag (weighted row sums of a table) for Hopper (sm_90a):
//
//   out[b, :] = sum_j w[b, j] * table[idx[b, j], :]       idx -1 = pad
//
// Replaces the Pallas TPU kernel `embedding_bag_pallas` (body
// `_bag_kernel`) in src/repro/kernels/embedding_bag/kernel.py.  Same
// function: a pad (idx < 0) reads row 0 with weight 0, so an all-pad bag
// gives 0; without weights every weight is 1.  Mean mode stays in the
// wrapper (division by the clamped sum of the weights), as in the
// reference's ops.py.  table (V, D) and w (B, L) are fp32 or bf16 (one
// type; the wrapper casts w to the table's), idx (B, L) int32, out (B, D)
// in the table's type.  Sums are taken in fp32, in index order.
//
// Design.  The TPU kernel ran a (B, L) grid with the indices in scalar
// prefetch, one table row DMA per grid step.  Here one warp owns one bag:
// it loads its own indices and weights, 32 at a time (one per lane), and
// broadcasts them with shuffles; every lane then adds its columns of the
// indexed row into fp32 registers (lane l owns columns l, l+32, ... of a
// 128-column slice; wider rows take more slices).  Loads are scalar: at
// SASRec's D = 50 an fp32 row is 200 bytes, so rows do not start on 16-
// byte boundaries, and one warp's scalar loads of a row are contiguous
// (two 128-byte requests).  No atomics, no shared memory; 64-bit offsets.
//
// Bound: bytes.  The function must read the indices and weights once,
// each referenced row once (B*L*D*s bytes for distinct rows) and write
// B*D*s; it does two flops per element read, far below the card's
// compute-to-bandwidth ratio.  Rows repeated across bags are served from
// L2.  Left for later: 8-byte loads where rows allow, and more bags in
// flight per warp to hide the latency of the dependent row load.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPerLane = 4;          // 128 columns per slice
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bag_kernel(const T* __restrict__ table, const int32_t* __restrict__ idx,
           const T* __restrict__ w, T* __restrict__ out, int64_t n_bags,
           int l, int d) {
  const int lane = threadIdx.x & 31;
  const int64_t bag = static_cast<int64_t>(blockIdx.x) * kWarps +
                      (threadIdx.x >> 5);
  if (bag >= n_bags) return;
  const int32_t* my_idx = idx + bag * l;
  const T* my_w = w ? w + bag * l : nullptr;
  for (int c0 = 0; c0 < d; c0 += 32 * kPerLane) {
    float acc[kPerLane] = {0.f, 0.f, 0.f, 0.f};
    for (int j0 = 0; j0 < l; j0 += 32) {
      const int cnt = min(32, l - j0);
      int32_t r_mine = 0;
      float w_mine = 0.f;
      if (lane < cnt) {
        r_mine = __ldg(my_idx + j0 + lane);
        w_mine = my_w ? to_f32(my_w[j0 + lane]) : 1.f;
        if (r_mine < 0) {          // pad: row 0, weight 0
          r_mine = 0;
          w_mine = 0.f;
        }
      }
      for (int j = 0; j < cnt; ++j) {
        const int64_t r = __shfl_sync(kFull, r_mine, j);
        const float wj = __shfl_sync(kFull, w_mine, j);
        const T* row = table + r * d + c0;
#pragma unroll
        for (int t = 0; t < kPerLane; ++t) {
          const int c = lane + 32 * t;
          if (c0 + c < d) acc[t] = fmaf(to_f32(row[c]), wj, acc[t]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      const int c = lane + 32 * t;
      if (c0 + c < d) out[bag * d + c0 + c] = from_f32<T>(acc[t]);
    }
  }
}

template <typename T>
int launch(const void* table, const int32_t* idx, const void* w, void* out,
           int64_t n_bags, int32_t l, int32_t d, cudaStream_t stream) {
  const unsigned blocks =
      static_cast<unsigned>((n_bags + kWarps - 1) / kWarps);
  bag_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(table), idx, static_cast<const T*>(w),
      static_cast<T*>(out), n_bags, l, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes).  Launches on the given stream,
// does not synchronise, and returns cudaGetLastError() (0 if none).  w may
// be null (every weight 1).  dtype: 0 = fp32, 1 = bf16.  Needs n_bags >= 1
// and every idx < V (the wrapper checks).
extern "C" int embedding_bag(const void* table, const int32_t* idx,
                             const void* w, void* out, int64_t n_bags,
                             int32_t l, int32_t d, int32_t dtype,
                             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(table, idx, w, out, n_bags, l, d, s);
  return launch<__nv_bfloat16>(table, idx, w, out, n_bags, l, d, s);
}
