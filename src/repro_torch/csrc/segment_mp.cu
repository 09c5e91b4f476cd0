// Fused message passing for Hopper (sm_90a):
//
//   y[v] = sum_{(u, v) in E} x[u] @ W        x (N, D), W (D, F), y (N, F)
//
// Replaces the Pallas TPU kernel `segment_mp_pallas` (body `_mp_kernel`)
// in src/repro/kernels/segment_mp/kernel.py.  The TPU kernel packed the
// dst-sorted edges into a block-ELL layout, gathered x[src] in XLA, and
// reduced each (dst block, edge tile) with a one-hot matmul on the MXU,
// i.e. 2*E*D*F flops.  This kernel computes the function instead, using
// linearity:  y[v] = (sum_{u -> v} x[u]) @ W,  which is 2*N*D*F + E*D
// flops (about 25x less at ogb-products' mean in-degree of 25).
//
// Layout: dst-sorted CSR.  `indptr` (N+1, int32) holds each dst node's
// edge range in `src` (E, int32).  x, W and y are row-major; x and W are
// fp32 or bf16 (one type), y has W's type.  Sums are taken in fp32.
//
// Design (simple and deterministic: no atomics, a fixed summation order):
// - Pass B, `node_kernel`: one CTA of 8 warps per block of 8 dst nodes,
//   one warp per node.  D is walked in tiles of TD columns (TD = 128, 64
//   or 32, so that a W tile fits in shared memory for F up to 512; this
//   covers gat-cora's D = 1433).  For each tile the CTA stages W[d0:d0+TD,
//   :] in shared memory as fp32; each warp sums the tile's slice of its
//   node's x[u] rows in fp32 registers (lane l holds columns l, l+32, ...:
//   a warp's load of one row slice is contiguous), writes the sum to its
//   shared-memory row, and multiplies it into its fp32 accumulator row of
//   F values (lane l owns outputs l, l+32, ...).  The output row is
//   written once, in W's type.
// - A dst node with more than `chunk` edges (a hub of a power-law graph,
//   or the pipeline's padding sentinel) would serialise one warp on it.
//   Pass A, `chunk_kernel`, splits such rows into chunks of `chunk`
//   edges, one warp per chunk, each writing its fp32 partial row sum over
//   all D columns to scratch; pass B then sums that row's partials (in
//   chunk order) instead of its x rows.  Rows at or below `chunk` edges
//   never touch scratch.
// - 64-bit element offsets throughout (u * D, v * F, c * D).
//
// Bound.  The function must read E*4 + (N+1)*4 index bytes, x (N*D*s), W
// and write y (N*F*s), and do 2*N*D*F + E*D fp32 operations.  At
// ogb-products' shape (N = 2.45M, E = 61.9M, D = 100, F = 64, fp32) the
// bytes bound it (~0.55 ms at 3.35 TB/s).  This kernel gathers one x row
// slice per edge, E*D*s bytes (~25 GB at that shape, mostly from device
// memory: x does not fit in L2), so it is gather-bound, some 10-40x above
// the bound.  Left for later: reusing gathered rows across dst nodes
// (tiling by src), 16-byte loads, and tensor cores for the @ W step.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxPerLane = 4;        // TD / 32 <= 4
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

// acc[k] += sum over rows r = idx(j), j in [lo, hi), of M[r * ld + c0 +
// lane + 32 k] for the k with lane + 32 k < width.  When `idx` is null the
// rows are j itself (pass B summing a hub's contiguous partials).
template <typename T>
__device__ __forceinline__ void sum_rows(const T* __restrict__ m, int64_t ld,
                                         const int32_t* __restrict__ idx,
                                         int64_t lo, int64_t hi, int64_t c0,
                                         int width, int lane,
                                         float (&acc)[kMaxPerLane]) {
  for (int64_t base = lo; base < hi; base += 32) {
    const int cnt = static_cast<int>(hi - base < 32 ? hi - base : 32);
    int64_t mine = 0;
    if (lane < cnt) mine = idx ? __ldg(idx + base + lane) : base + lane;
#pragma unroll 4
    for (int j = 0; j < cnt; ++j) {
      const int64_t r = __shfl_sync(kFull, mine, j);
      const T* row = m + r * ld + c0;
#pragma unroll
      for (int k = 0; k < kMaxPerLane; ++k) {
        const int c = lane + 32 * k;
        if (c < width) acc[k] += to_f32(row[c]);
      }
    }
  }
}

// Binary search of v in the sorted heavy-row list; -1 if absent.
__device__ __forceinline__ int find_heavy(const int32_t* __restrict__ rows,
                                          int n_heavy, int32_t v) {
  int lo = 0, hi = n_heavy;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int32_t r = __ldg(rows + mid);
    if (r == v) return mid;
    if (r < v) lo = mid + 1; else hi = mid;
  }
  return -1;
}

// Pass A: partial[c, :] = sum of x[src[e]] over chunk c's edges, fp32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
chunk_kernel(const T* __restrict__ x, const int32_t* __restrict__ src,
             const int32_t* __restrict__ chunk_lo,
             const int32_t* __restrict__ chunk_hi,
             float* __restrict__ partial, int64_t n_chunks, int d) {
  const int lane = threadIdx.x & 31;
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kWarps +
                    (threadIdx.x >> 5);
  if (c >= n_chunks) return;
  const int64_t lo = __ldg(chunk_lo + c), hi = __ldg(chunk_hi + c);
  for (int d0 = 0; d0 < d; d0 += 32 * kMaxPerLane) {
    const int width = min(32 * kMaxPerLane, d - d0);
    float acc[kMaxPerLane] = {0.f, 0.f, 0.f, 0.f};
    sum_rows(x, d, src, lo, hi, d0, width, lane, acc);
#pragma unroll
    for (int k = 0; k < kMaxPerLane; ++k) {
      const int col = lane + 32 * k;
      if (col < width) partial[c * d + d0 + col] = acc[k];
    }
  }
}

// Pass B: y[v, :] = (sum of x[u] over v's edges, or of v's partials) @ W.
template <typename T>
__global__ void __launch_bounds__(kThreads)
node_kernel(const T* __restrict__ x, const T* __restrict__ w,
            const int32_t* __restrict__ src,
            const int32_t* __restrict__ indptr,
            const int32_t* __restrict__ heavy_rows,
            const int32_t* __restrict__ heavy_ptr,
            const float* __restrict__ partial, T* __restrict__ y, int64_t n,
            int d, int f, int td, int n_heavy, int chunk) {
  extern __shared__ float smem[];
  float* w_tile = smem;                          // (td, f)
  float* agg = w_tile + td * f;                  // (kWarps, td)
  float* acc = agg + kWarps * td;                // (kWarps, f)
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t v = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  const bool live = v < n;
  float* my_agg = agg + warp * td;
  float* my_acc = acc + warp * f;
  for (int j = lane; j < f; j += 32) my_acc[j] = 0.f;

  int64_t lo = 0, hi = 0;
  int h = -1;
  if (live) {
    lo = __ldg(indptr + v);
    hi = __ldg(indptr + v + 1);
    if (hi - lo > chunk) {
      h = find_heavy(heavy_rows, n_heavy, static_cast<int32_t>(v));
      lo = __ldg(heavy_ptr + h);
      hi = __ldg(heavy_ptr + h + 1);
    }
  }
  for (int d0 = 0; d0 < d; d0 += td) {
    const int width = min(td, d - d0);
    __syncthreads();                       // previous tile fully consumed
    for (int i = threadIdx.x; i < width * f; i += kThreads)
      w_tile[i] = to_f32(w[static_cast<int64_t>(d0) * f + i]);
    __syncthreads();
    if (!live) continue;
    float part[kMaxPerLane] = {0.f, 0.f, 0.f, 0.f};
    if (h < 0)
      sum_rows(x, d, src, lo, hi, d0, width, lane, part);
    else
      sum_rows(partial, d, static_cast<const int32_t*>(nullptr), lo, hi, d0,
               width, lane, part);
#pragma unroll
    for (int k = 0; k < kMaxPerLane; ++k) {
      const int col = lane + 32 * k;
      if (col < width) my_agg[col] = part[k];
    }
    __syncwarp();
    for (int j = lane; j < f; j += 32) {
      float s = my_acc[j];
      for (int c = 0; c < width; ++c) s += my_agg[c] * w_tile[c * f + j];
      my_acc[j] = s;
    }
    __syncwarp();                          // my_agg is rewritten next tile
  }
  if (!live) return;
  for (int j = lane; j < f; j += 32) y[v * f + j] = from_f32<T>(my_acc[j]);
}

template <typename T>
int launch(const void* x, const void* w, const int32_t* src,
           const int32_t* indptr, const int32_t* heavy_rows,
           const int32_t* heavy_ptr, const int32_t* chunk_lo,
           const int32_t* chunk_hi, float* partial, void* y, int64_t n,
           int32_t d, int32_t f, int32_t td, int32_t n_heavy,
           int64_t n_chunks, int32_t chunk, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  if (n_chunks > 0) {
    const unsigned blocks =
        static_cast<unsigned>((n_chunks + kWarps - 1) / kWarps);
    chunk_kernel<T><<<blocks, kThreads, 0, stream>>>(xt, src, chunk_lo,
                                                     chunk_hi, partial,
                                                     n_chunks, d);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(td) * f + kWarps * td + kWarps * f);
  cudaError_t err = cudaFuncSetAttribute(
      node_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((n + kWarps - 1) / kWarps);
  node_kernel<T><<<blocks, kThreads, smem, stream>>>(
      xt, static_cast<const T*>(w), src, indptr, heavy_rows, heavy_ptr,
      partial, static_cast<T*>(y), n, d, f, td, n_heavy, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes).  Launches pass A (when
// n_chunks > 0) and pass B on the given stream, does not synchronise, and
// returns the first CUDA error (0 if none), so that a refused launch is
// reported.  dtype: 0 = fp32, 1 = bf16.  n must be > 0 and td a multiple of
// 32 no larger than 128.
extern "C" int segment_mp(const void* x, const void* w, const int32_t* src,
                          const int32_t* indptr, const int32_t* heavy_rows,
                          const int32_t* heavy_ptr, const int32_t* chunk_lo,
                          const int32_t* chunk_hi, float* partial, void* y,
                          int64_t n, int32_t d, int32_t f, int32_t td,
                          int32_t n_heavy, int64_t n_chunks, int32_t chunk,
                          int32_t dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w, src, indptr, heavy_rows, heavy_ptr, chunk_lo,
                         chunk_hi, partial, y, n, d, f, td, n_heavy, n_chunks,
                         chunk, s);
  return launch<__nv_bfloat16>(x, w, src, indptr, heavy_rows, heavy_ptr,
                               chunk_lo, chunk_hi, partial, y, n, d, f, td,
                               n_heavy, n_chunks, chunk, s);
}
