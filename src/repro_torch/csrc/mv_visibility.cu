// Refinable-timestamp stamp compares for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in src/repro/kernels/mv_visibility/
// kernel.py: `before_pallas` (body `_before_kernel`) and
// `visibility_pallas` (body `_visibility_kernel`), plus the per-row-query
// compare that src/repro/core/writepath.py `before_pairs` ran as one fused
// jnp launch.  All three compute `row ≺ q` over packed int32 stamp rows
// `[epoch, c_0..c_{G-1}]` (width C = G + 1):
//
//   NO_STAMP (INT32_MAX) epoch  -> false
//   lower epoch                 -> true
//   same epoch                  -> all(c_i <= q_i) and not all(c_i == q_i)
//   higher epoch                -> false
//
// Layout: the rows are read as the host holds them, (N, C) row-major, with
// no transpose and no padding to a block multiple (the TPU kernel wanted
// component-major (C, N) padded to 1024).  Every kernel masks its own tail.
// The query stamp q (or the per-row qs) is read from device memory.  The
// output is torch.bool storage: exactly 0 or 1 per uint8.
//
// Bound: HBM bytes.  A pass reads N*C*4 bytes per stamp table (plus N*C*4
// for qs) and writes N bytes, and does C integer compares per row; at C=3
// that is ~0.25 ops per byte, far below the card's compute-to-bandwidth
// ratio.  Design: one thread per row, a grid-stride loop with 64-bit
// indices (N reaches ~69M rows), and a loop over C.  A warp's loads of
// component j hit C*128 contiguous bytes, so DRAM traffic stays at one
// read per byte while L1 absorbs the strided re-reads.  Left for later:
// staging a block's rows through shared memory with 16-byte vector loads,
// and packing the output as bits.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kNoStamp = 0x7fffffff;
constexpr int kThreads = 256;

__device__ __forceinline__ bool before_row(const int32_t* __restrict__ row,
                                           const int32_t* __restrict__ q,
                                           int c) {
  const int32_t e = row[0];
  const int32_t qe = __ldg(q);
  if (e == kNoStamp) return false;
  if (e < qe) return true;
  if (e != qe) return false;
  bool le = true;
  bool eq = true;
  for (int j = 1; j < c; ++j) {
    const int32_t x = row[j];
    const int32_t y = __ldg(q + j);
    le &= (x <= y);
    eq &= (x == y);
  }
  return le && !eq;
}

__global__ void before_kernel(const int32_t* __restrict__ rows,
                              const int32_t* __restrict__ q,
                              uint8_t* __restrict__ out, int64_t n, int c) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    out[i] = before_row(rows + i * c, q, c) ? 1 : 0;
  }
}

__global__ void visibility_kernel(const int32_t* __restrict__ create,
                                  const int32_t* __restrict__ del,
                                  const int32_t* __restrict__ q,
                                  uint8_t* __restrict__ out, int64_t n,
                                  int c) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const bool vis = before_row(create + i * c, q, c) &&
                     !before_row(del + i * c, q, c);
    out[i] = vis ? 1 : 0;
  }
}

__global__ void before_pairs_kernel(const int32_t* __restrict__ rows,
                                    const int32_t* __restrict__ qs,
                                    uint8_t* __restrict__ out, int64_t n,
                                    int c) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    out[i] = before_row(rows + i * c, qs + i * c, c) ? 1 : 0;
  }
}

// Enough blocks to cover n once, capped so the grid-stride loop takes over
// for very large n (132 SMs x 16 resident 256-thread blocks x 8 waves).
unsigned int grid_for(int64_t n) {
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int64_t cap = 132 * 16 * 8;
  return static_cast<unsigned int>(want < cap ? want : cap);
}

}  // namespace

// Plain C interface (loaded with ctypes).  Each function launches on the
// given stream, does not synchronise, and returns cudaGetLastError() so
// that a refused launch is reported to the caller.  n must be > 0.

extern "C" int mv_before(const int32_t* rows, const int32_t* q, uint8_t* out,
                         int64_t n, int32_t c, void* stream) {
  before_kernel<<<grid_for(n), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(rows, q, out, n, c);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mv_visibility(const int32_t* create, const int32_t* del,
                             const int32_t* q, uint8_t* out, int64_t n,
                             int32_t c, void* stream) {
  visibility_kernel<<<grid_for(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(create, del, q,
                                                           out, n, c);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mv_before_pairs(const int32_t* rows, const int32_t* qs,
                               uint8_t* out, int64_t n, int32_t c,
                               void* stream) {
  before_pairs_kernel<<<grid_for(n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(rows, qs, out,
                                                             n, c);
  return static_cast<int>(cudaGetLastError());
}
