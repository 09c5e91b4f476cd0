// Fused message passing for Hopper (sm_90a):
//
//   y[v] = sum_{(u, v) in E} x[u] @ W        x (N, D), W (D, F), y (N, F)
//
// Replaces the Pallas TPU kernel `segment_mp_pallas` (body `_mp_kernel`)
// in src/repro/kernels/segment_mp/kernel.py.  The TPU kernel packed the
// dst-sorted edges into a block-ELL layout, gathered x[src] in XLA, and
// reduced each (dst block, edge tile) with a one-hot matmul on the MXU,
// i.e. 2*E*D*F flops.  This kernel computes the function instead, using
// linearity:  y = A (x W) = (A x) W,  in whichever order gathers the
// narrower rows.
//
// Layout: dst-sorted CSR.  `indptr` (N+1, int32) holds each dst node's
// edge range in `src` (E, int32).  x, W and y are row-major; x and W are
// fp32 or bf16 (one type), y has W's type.  Sums are taken in fp32.
//
// Bound: bytes.  The function must read E*4 + (N+1)*4 index bytes, x, W
// and write y, and do 2*N*D*F + E*min(D, F) fp32 operations; at
// ogb-products' shape (N 2.45M, E 61.9M, D 100, F 64, fp32) the bytes
// bind (~0.56 ms at 3.35 TB/s).  What costs is the gather: one row per
// edge, from a matrix far larger than L2.  The design:
//
// - Order (the wrapper's static rule, kernel.select_order): transform
//   first when an fp32 row of h = x W (F*4 bytes) is narrower than a row
//   of x (D*s bytes): the product pass writes h in fp32 to scratch, then
//   the gather passes sum h rows into y (at ogb-products 256 bytes per
//   edge instead of 400).  Otherwise aggregate first: the gather passes
//   sum x rows into an fp32 scratch agg (N, D), then the product pass
//   writes y = agg W.
// - Product pass (`product_kernel`): a tiled fp32 product on the CUDA
//   cores (TF32 would miss the fp32 tolerance): 128 x 64 output tiles,
//   32-deep shared-memory tiles of A (transposed) and W, 8 x 4 outputs
//   in registers per thread; the next tile's loads are in flight while
//   this tile's products run.  (3xTF32 on the tensor cores, tried for
//   this pass, ran it in 1.03 ms against 1.26 at ogb-products on an
//   H100 but missed the reference tests' fp32 tolerance.)
// - Gather passes: a group of g lanes (g = 4..32, the power of two at or
//   above the row's vector count) serves one dst row; a lane owns one
//   vector of V bytes (16, 8 or 4 bytes, or one bf16: the widest that
//   divides the row stride and x's alignment, chosen by the wrapper), so
//   at F = 64 fp32 a 256-byte h row is 16 lanes x float4 and one warp
//   instruction loads two rows.  The group stages 32 src indices at a
//   time in shared memory and issues 8 (chunk pass) or 4 (row pass)
//   independent row loads before it adds them, in edge order.  No
//   atomics: deterministic.
// - Hubs: a row of more than `chunk` edges (a power-law hub, or the
//   pipeline's padding sentinel) would serialise its group.  The
//   plan gives each such row ceil(deg / chunk) chunks (`chunk_ptr`, an
//   exclusive prefix sum over the rows, built here by three small
//   kernels; the wrapper sizes the partials from N and E alone, so
//   nothing is read back).  `chunk_kernel` sums each chunk into an fp32 partial row (a
//   chunk finds its row by binary search in chunk_ptr); a row with more
//   than `chunk` partials (more than chunk^2 edges) gets a second level
//   of the same plan over its partials (`chunk2_ptr`), summed by a
//   second chunk pass; `row_kernel` then sums a row's top-level partials
//   in chunk order instead of its rows.  Every sum has at most `chunk`
//   terms per level, in a fixed order.
// - 64-bit element offsets throughout.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "vec.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMinGroup = 4;          // lanes per group, at least
constexpr int kChunkUnroll = 8;       // row loads in flight per group in
constexpr int kRowUnroll = 4;         // a chunk, and in a (short) dst row
constexpr int kStage = 32;            // src indices staged per group
constexpr int kStride = kStage + 1;   // per-group shared stride (banks)
constexpr int kBM = 128;              // product tile: rows
constexpr int kBN = 64;               //               columns
constexpr int kBK = 32;               //               depth
constexpr int kTM = 8;                // outputs per thread: rows
constexpr int kTN = 4;                //                     columns
constexpr int kLdA = kBM + 4;         // A tile row stride (16-byte rows)
constexpr int kPlanPer = 4;           // plan: rows per thread,
constexpr int kPlanRows = kThreads * kPlanPer;  //  and per block
constexpr unsigned kFull = 0xffffffffu;

// acc[e] += the lane's columns of every row r(j), j in [lo, hi), in order:
// r(j) = idx[j] when idx is given, else j (a hub's contiguous partials);
// kU row loads are issued before their adds.
template <typename TM, int kE, int kU>
__device__ __forceinline__ void sum_rows(const TM* __restrict__ m,
                                         int64_t ld,
                                         const int32_t* __restrict__ idx,
                                         int64_t lo, int64_t hi, int c,
                                         bool col_ok, int sub, int g,
                                         unsigned mask, int32_t* s_r,
                                         float (&acc)[kE]) {
  for (int64_t q = lo; q < hi; q += kStage) {
    const int cnt = static_cast<int>(hi - q < kStage ? hi - q : kStage);
    if (idx) {
      __syncwarp(mask);                     // the last stage is consumed
      for (int j = sub; j < cnt; j += g) s_r[j] = __ldg(idx + q + j);
      __syncwarp(mask);
    }
    for (int j0 = 0; j0 < cnt; j0 += kU) {
      vec::Cols<TM, kE> rows[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int j = j0 + u;
        if (j < cnt && col_ok) {
          const int64_t r = idx ? static_cast<int64_t>(s_r[j]) : q + j;
          rows[u].load(m + r * ld + static_cast<int64_t>(c) * kE);
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (j0 + u < cnt && col_ok) {
#pragma unroll
          for (int e = 0; e < kE; ++e) acc[e] += rows[u].get(e);
        }
      }
    }
  }
}

// partial[k, :] = sum of m[r] over chunk k's rows r, fp32: the rows
// src[e] of the chunk's edges e, or (src null, the second level) the
// chunk's range of partial rows itself.  A lane owns kE columns.
template <typename TM, int kE>
__global__ void __launch_bounds__(kThreads, 4)
chunk_kernel(const TM* __restrict__ m, int width,
             const int32_t* __restrict__ src,
             const int32_t* __restrict__ indptr,
             const int32_t* __restrict__ chunk_ptr,
             float* __restrict__ partial, int64_t n, int64_t max_chunks,
             int chunk, int g) {
  __shared__ int32_t s_rows[kThreads / kMinGroup * kStride];
  const int lane = threadIdx.x & 31;
  const int sub = lane & (g - 1);
  const int grp = threadIdx.x / g;
  const unsigned mask = vec::group_mask(lane, g);
  const int64_t k = static_cast<int64_t>(blockIdx.x) * (kThreads / g) + grp;
  if (k >= max_chunks || k >= __ldg(chunk_ptr + n)) return;
  // the row owning chunk k: chunk_ptr[a] <= k < chunk_ptr[a + 1]
  int64_t a = 0, b = n;
  while (b - a > 1) {
    const int64_t mid = (a + b) >> 1;
    if (__ldg(chunk_ptr + mid) <= k) a = mid; else b = mid;
  }
  const int64_t lo = __ldg(indptr + a) + (k - __ldg(chunk_ptr + a)) * chunk;
  const int64_t end = __ldg(indptr + a + 1);
  const int64_t hi = lo + chunk < end ? lo + chunk : end;
  const int nv = width / kE;
  for (int base = 0; base < nv; base += g) {
    const int c = base + sub;
    const bool col_ok = c < nv;
    float acc[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[e] = 0.f;
    sum_rows<TM, kE, kChunkUnroll>(m, width, src, lo, hi, c, col_ok, sub, g,
                                   mask, s_rows + grp * kStride, acc);
    if (col_ok)
      vec::store_cols<float, kE>(
          partial + k * width + static_cast<int64_t>(c) * kE, acc);
  }
}

// out[v, :] = sum of m[src[e]] over v's edges, or of v's partials (of
// the second level when it has any).
template <typename TM, typename TO, int kE>
__global__ void __launch_bounds__(kThreads)
row_kernel(const TM* __restrict__ m, int width,
           const int32_t* __restrict__ src,
           const int32_t* __restrict__ indptr,
           const int32_t* __restrict__ chunk_ptr,
           const float* __restrict__ partial,
           const int32_t* __restrict__ chunk2_ptr,
           const float* __restrict__ partial2, TO* __restrict__ out,
           int64_t n, int g) {
  __shared__ int32_t s_rows[kThreads / kMinGroup * kStride];
  const int lane = threadIdx.x & 31;
  const int sub = lane & (g - 1);
  const int grp = threadIdx.x / g;
  const unsigned mask = vec::group_mask(lane, g);
  const int64_t v = static_cast<int64_t>(blockIdx.x) * (kThreads / g) + grp;
  if (v >= n) return;
  const int64_t c0 = __ldg(chunk_ptr + v), c1 = __ldg(chunk_ptr + v + 1);
  const int64_t d0 = __ldg(chunk2_ptr + v), d1 = __ldg(chunk2_ptr + v + 1);
  const int64_t lo = __ldg(indptr + v), hi = __ldg(indptr + v + 1);
  const int nv = width / kE;
  for (int base = 0; base < nv; base += g) {
    const int c = base + sub;
    const bool col_ok = c < nv;
    float acc[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[e] = 0.f;
    if (d1 > d0)
      sum_rows<float, kE, kRowUnroll>(partial2, width, nullptr, d0, d1, c,
                                      col_ok, sub, g, mask,
                                      s_rows + grp * kStride, acc);
    else if (c1 > c0)
      sum_rows<float, kE, kRowUnroll>(partial, width, nullptr, c0, c1, c,
                                      col_ok, sub, g, mask,
                                      s_rows + grp * kStride, acc);
    else
      sum_rows<TM, kE, kRowUnroll>(m, width, src, lo, hi, c, col_ok, sub, g,
                                   mask, s_rows + grp * kStride, acc);
    if (col_ok)
      vec::store_cols<TO, kE>(out + v * width + static_cast<int64_t>(c) * kE,
                              acc);
  }
}

// Tile loads of the product pass into registers: A rows a_row, depths
// a_k + 2 i; W columns b_col, depths b_k + 4 i; zeros past the edges.
constexpr int kAL = kBK / (kThreads / kBM);       // A values per thread
constexpr int kBL = kBK / (kThreads / kBN);       // W values per thread

template <typename TA, typename TB>
__device__ __forceinline__ void fetch_tiles(
    const TA* __restrict__ a_ptr, bool row_ok, int a_k,
    const TB* __restrict__ b, int b_col, int b_k, int k0, int k, int n0,
    int n, float (&ra)[kAL], float (&rb)[kBL]) {
#pragma unroll
  for (int i = 0; i < kAL; ++i) {
    const int kk = k0 + a_k + (kThreads / kBM) * i;
    ra[i] = row_ok && kk < k ? vec::to_f32(a_ptr[kk]) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kBL; ++i) {
    const int kk = k0 + b_k + (kThreads / kBN) * i;
    rb[i] = kk < k && n0 + b_col < n
                ? vec::to_f32(b[static_cast<int64_t>(kk) * n + n0 + b_col])
                : 0.f;
  }
}

// acc += the (kTM x kTN) outer product at depth kk of the shared tiles.
__device__ __forceinline__ void mac(const float* as, const float* bs, int kk,
                                    int tx, int ty,
                                    float (&acc)[kTM][kTN]) {
  const float4 a0 = *reinterpret_cast<const float4*>(as + kk * kLdA + ty * kTM);
  const float4 a1 =
      *reinterpret_cast<const float4*>(as + kk * kLdA + ty * kTM + 4);
  const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * kBN + tx * kTN);
  const float av[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float bv[kTN] = {b0.x, b0.y, b0.z, b0.w};
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

// c (m, n) = a (m, k) @ b (k, n), all row-major, summed in fp32 in depth
// order.  The next depth tile's loads are in flight during this tile's
// products; the last tile runs only over the depths that exist.
template <typename TA, typename TB, typename TO>
__global__ void __launch_bounds__(kThreads)
product_kernel(const TA* __restrict__ a, const TB* __restrict__ b,
               TO* __restrict__ c, int64_t m, int k, int n) {
  __shared__ __align__(16) float as[kBK * kLdA];    // as[kk][row]
  __shared__ __align__(16) float bs[kBK * kBN];     // bs[kk][col]
  const int t = threadIdx.x;
  const int tx = t % (kBN / kTN), ty = t / (kBN / kTN);
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  const int a_row = t % kBM, a_k = t / kBM;         // loader of A
  const int b_col = t % kBN, b_k = t / kBN;         // loader of W
  const bool row_ok = m0 + a_row < m;
  const TA* a_ptr = a + (m0 + a_row) * k;
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  float ra[kAL], rb[kBL];
  fetch_tiles(a_ptr, row_ok, a_k, b, b_col, b_k, 0, k, n0, n, ra, rb);

  for (int k0 = 0; k0 < k; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < kAL; ++i)
      as[(a_k + (kThreads / kBM) * i) * kLdA + a_row] = ra[i];
#pragma unroll
    for (int i = 0; i < kBL; ++i)
      bs[(b_k + (kThreads / kBN) * i) * kBN + b_col] = rb[i];
    __syncthreads();
    if (k0 + kBK < k)
      fetch_tiles(a_ptr, row_ok, a_k, b, b_col, b_k, k0 + kBK, k, n0, n, ra,
                  rb);
    if (k - k0 >= kBK) {
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) mac(as, bs, kk, tx, ty, acc);
    } else {
      for (int kk = 0; kk < k - k0; ++kk) mac(as, bs, kk, tx, ty, acc);
    }
    __syncthreads();
  }

  const int col = n0 + tx * kTN;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int64_t r = m0 + ty * kTM + i;
    if (r >= m) continue;
    TO* crow = c + r * n;
    if constexpr (sizeof(TO) == 4) {
      if ((n & 3) == 0 && col + kTN <= n) {
        *reinterpret_cast<float4*>(crow + col) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        continue;
      }
    }
#pragma unroll
    for (int j = 0; j < kTN; ++j)
      if (col + j < n) crow[col + j] = vec::from_f32<TO>(acc[i][j]);
  }
}

// ---- The hub plan: chunk_ptr[v] = sum over rows u < v of chunks_of(u),
// an exclusive prefix sum built in three passes (per-block counts, one
// block scanning the block counts, per-block fill), all on the card.

// Chunks of a row of `deg` entries: ceil(deg / chunk) above `chunk`.
__device__ __forceinline__ int chunks_of(int64_t deg, int chunk) {
  return deg > chunk ? static_cast<int>((deg + chunk - 1) / chunk) : 0;
}

// The block's exclusive prefix sum of one value per thread; *total gets
// the block's sum.
__device__ __forceinline__ int block_scan(int x, int* total) {
  __shared__ int warp_sum[kThreads / 32 + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) warp_sum[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kThreads / 32 ? warp_sum[lane] : 0;
    int wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, wi, o);
      if (lane >= o) wi += y;
    }
    if (lane < kThreads / 32) warp_sum[lane] = wi - w;
    if (lane == kThreads / 32 - 1) warp_sum[kThreads / 32] = wi;
  }
  __syncthreads();
  const int excl = warp_sum[warp] + inc - x;
  *total = warp_sum[kThreads / 32];
  __syncthreads();                        // warp_sum is reused next call
  return excl;
}

// counts[b] = the chunks of block b's rows.
__global__ void __launch_bounds__(kThreads)
plan_count_kernel(const int32_t* __restrict__ ptr, int64_t n, int chunk,
                  int32_t* __restrict__ counts) {
  const int64_t v0 =
      static_cast<int64_t>(blockIdx.x) * kPlanRows + threadIdx.x * kPlanPer;
  int c = 0;
  for (int i = 0; i < kPlanPer && v0 + i < n; ++i)
    c += chunks_of(__ldg(ptr + v0 + i + 1) - __ldg(ptr + v0 + i), chunk);
  int total;
  block_scan(c, &total);
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

// counts[0..nb) := their exclusive prefix sum, counts[nb] := the total;
// one block.
__global__ void __launch_bounds__(kThreads)
plan_scan_kernel(int32_t* __restrict__ counts, int64_t nb) {
  int carry = 0;
  for (int64_t b0 = 0; b0 < nb; b0 += kThreads) {
    const int64_t b = b0 + threadIdx.x;
    const int x = b < nb ? counts[b] : 0;
    int total;
    const int excl = block_scan(x, &total);
    if (b < nb) counts[b] = carry + excl;
    carry += total;
  }
  if (threadIdx.x == 0) counts[nb] = carry;
}

// out[v] = offsets[block of v] + the chunks of the block's rows before v;
// out[n] = the total.
__global__ void __launch_bounds__(kThreads)
plan_fill_kernel(const int32_t* __restrict__ ptr, int64_t n, int chunk,
                 const int32_t* __restrict__ offsets, int64_t nb,
                 int32_t* __restrict__ out) {
  const int64_t v0 =
      static_cast<int64_t>(blockIdx.x) * kPlanRows + threadIdx.x * kPlanPer;
  int c[kPlanPer];
  int sum = 0;
#pragma unroll
  for (int i = 0; i < kPlanPer; ++i) {
    c[i] = v0 + i < n ? chunks_of(__ldg(ptr + v0 + i + 1) -
                                  __ldg(ptr + v0 + i), chunk)
                      : 0;
    sum += c[i];
  }
  int total;
  int at = offsets[blockIdx.x] + block_scan(sum, &total);
#pragma unroll
  for (int i = 0; i < kPlanPer; ++i) {
    if (v0 + i < n) out[v0 + i] = at;
    at += c[i];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) out[n] = offsets[nb];
}

// out (n+1) = the plan of row pointers ptr (n+1); counts holds nb + 1
// ints, nb = ceil(n / kPlanRows).
int build_plan(const int32_t* ptr, int64_t n, int chunk, int32_t* counts,
               int32_t* out, cudaStream_t s) {
  const int64_t nb = (n + kPlanRows - 1) / kPlanRows;
  plan_count_kernel<<<static_cast<unsigned>(nb), kThreads, 0, s>>>(
      ptr, n, chunk, counts);
  plan_scan_kernel<<<1, kThreads, 0, s>>>(counts, nb);
  plan_fill_kernel<<<static_cast<unsigned>(nb), kThreads, 0, s>>>(
      ptr, n, chunk, counts, nb, out);
  return static_cast<int>(cudaGetLastError());
}

// Where a call's rows and partials live.
struct Plan {
  const int32_t* src;
  const int32_t* indptr;
  const int32_t* chunk_ptr;       // first level: chunks of edges
  float* partial;
  int64_t max_chunks;
  const int32_t* chunk2_ptr;      // second level: chunks of partials
  float* partial2;
  int64_t max_chunks2;
  int64_t n;
  int chunk;
  int g;
};

// The gather passes: first-level partials of the hubs, second-level
// partials of the largest, then every row.
template <typename TM, typename TO, int kE>
int gather_e(const TM* m, int width, TO* out, const Plan& p,
             cudaStream_t s) {
  const int per_block = kThreads / p.g;
  if (p.max_chunks > 0) {
    chunk_kernel<TM, kE><<<static_cast<unsigned>(
        (p.max_chunks + per_block - 1) / per_block), kThreads, 0, s>>>(
        m, width, p.src, p.indptr, p.chunk_ptr, p.partial, p.n,
        p.max_chunks, p.chunk, p.g);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (p.max_chunks2 > 0) {
    chunk_kernel<float, kE><<<static_cast<unsigned>(
        (p.max_chunks2 + per_block - 1) / per_block), kThreads, 0, s>>>(
        p.partial, width, nullptr, p.chunk_ptr, p.chunk2_ptr, p.partial2,
        p.n, p.max_chunks2, p.chunk, p.g);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  row_kernel<TM, TO, kE><<<static_cast<unsigned>(
      (p.n + per_block - 1) / per_block), kThreads, 0, s>>>(
      m, width, p.src, p.indptr, p.chunk_ptr, p.partial, p.chunk2_ptr,
      p.partial2, out, p.n, p.g);
  return static_cast<int>(cudaGetLastError());
}

template <typename TM, typename TO>
int gather(int vec_bytes, const TM* m, int width, TO* out, const Plan& p,
           cudaStream_t s) {
  constexpr int kS = static_cast<int>(sizeof(TM));
  switch (vec_bytes) {
    case 16:
      return gather_e<TM, TO, 16 / kS>(m, width, out, p, s);
    case 8:
      return gather_e<TM, TO, 8 / kS>(m, width, out, p, s);
    case 4:
      return gather_e<TM, TO, 4 / kS>(m, width, out, p, s);
    case 2:
      if constexpr (kS == 2) return gather_e<TM, TO, 1>(m, width, out, p, s);
      break;
    default:
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch(const void* x_, const void* w_, float* scratch, void* y_,
           int d, int f, int order, int vec_bytes, const Plan& p,
           cudaStream_t s) {
  const T* x = static_cast<const T*>(x_);
  const T* w = static_cast<const T*>(w_);
  T* y = static_cast<T*>(y_);
  const dim3 grid(static_cast<unsigned>((p.n + kBM - 1) / kBM),
                  static_cast<unsigned>((f + kBN - 1) / kBN));
  if (order == 1) {                   // transform first: scratch = x W
    product_kernel<T, T, float><<<grid, kThreads, 0, s>>>(x, w, scratch,
                                                          p.n, d, f);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    return gather<float, T>(vec_bytes, scratch, f, y, p, s);
  }
  // aggregate first: scratch = A x, then y = scratch W
  const int rc = gather<T, float>(vec_bytes, x, d, scratch, p, s);
  if (rc != 0) return rc;
  product_kernel<float, T, T><<<grid, kThreads, 0, s>>>(scratch, w, y, p.n,
                                                        d, f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes).
//
// segment_mp_plan: out (n+1) = the hub plan of row pointers ptr (n+1)
// (chunks of `chunk` entries for the rows above `chunk`), built on the
// given stream; counts holds ceil(n / 1024) + 1 ints of workspace.
// Returns cudaGetLastError().
extern "C" int segment_mp_plan(const int32_t* ptr, int64_t n, int32_t chunk,
                               int32_t* counts, int32_t* out, void* stream) {
  if (n < 1 || chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  return build_plan(ptr, n, chunk, counts, out,
                    static_cast<cudaStream_t>(stream));
}

// segment_mp: builds the two levels of the hub plan (chunk_ptr over the
// edges, chunk2_ptr over chunk_ptr's partials; each n+1 ints, with
// counts as for segment_mp_plan), then launches the product pass and the
// gather passes (each chunk pass only when its max_chunks > 0) on the
// given stream; does not synchronise and returns the first CUDA error (0
// if none), or cudaErrorInvalidValue for a width or group the kernel
// does not take.  order: 0 = aggregate first (scratch (N, D) fp32), 1 =
// transform first (scratch (N, F) fp32).  partial holds max_chunks rows
// of the gathered width in fp32, partial2 max_chunks2 rows.  vec_bytes:
// 16, 8, 4 or the element size of the gathered rows, dividing their row
// bytes; group: a power of two in [4, 32].  dtype: 0 = fp32, 1 = bf16.
// Needs n > 0.
extern "C" int segment_mp(const void* x, const void* w, const int32_t* src,
                          const int32_t* indptr, int32_t* chunk_ptr,
                          float* partial, int32_t* chunk2_ptr,
                          float* partial2, int32_t* counts, float* scratch,
                          void* y, int64_t n, int32_t d, int32_t f,
                          int64_t max_chunks, int64_t max_chunks2,
                          int32_t chunk, int32_t order, int32_t vec_bytes,
                          int32_t group, int32_t dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_bytes = order == 1 ? f * 4 : d * (dtype == 0 ? 4 : 2);
  if (n < 1 || group < kMinGroup || group > 32 || (group & (group - 1)) ||
      vec_bytes < 2 || vec_bytes > 16 || row_bytes % vec_bytes ||
      (order != 0 && order != 1) || chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int rc = build_plan(indptr, n, chunk, counts, chunk_ptr, s);
  if (rc == 0) rc = build_plan(chunk_ptr, n, chunk, counts, chunk2_ptr, s);
  if (rc != 0) return rc;
  const Plan p{src, indptr, chunk_ptr, partial, max_chunks, chunk2_ptr,
               partial2, max_chunks2, n, chunk, group};
  if (dtype == 0)
    return launch<float>(x, w, scratch, y, d, f, order, vec_bytes, p, s);
  return launch<__nv_bfloat16>(x, w, scratch, y, d, f, order, vec_bytes, p,
                               s);
}
