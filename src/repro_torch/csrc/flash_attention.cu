// Online-softmax attention forward for Hopper (sm_90a):
//
//   o[b, i, h] = softmax_k(mask(q[b, i, h] . k[b, k, h / n_rep] * scale))
//                @ v[b, :, h / n_rep]
//
// Replaces the Pallas TPU kernel `flash_attention_pallas` (body
// `_flash_kernel`) in src/repro/kernels/flash_attention/kernel.py, and the
// KV-head repeat of its wrapper `ops.mha`.  Semantics kept exactly: fp32
// running max m, normaliser l and accumulator acc; masked logits are set
// to -1e30 (not -inf), so a query row with no valid key averages v over
// every key, as the reference does; the probabilities are cast to v's
// type before the p @ v product (fp32 or bf16, accumulated in fp32); the
// division by max(l, 1e-30) comes at the end; the output has q's type.
//
// Masks.  A key k of batch row b is valid for a query at position q_pos
// when k < min(kv_len[b], Sk) (Sk without kv_len), k <= q_pos (causal)
// and q_pos - k < window (window > 0).  The query at row i sits at q_pos =
// i + kv_len[b] - Sq (negative kv_len counts as 0): end-aligned, as the
// reference's `q_pos += Sk - Sq`, and decode's `kv_len - Sq + i`, also
// past a full cache (kv_len > Sk), where every slot is valid.  Keys at
// or past Sk do not exist (they are the tile's ragged edge): they take no
// part, not even as masked keys.
//
// Layout.  q (B, Sq, Hq, D) and k, v (B, Sk, Hkv, D) are read in place
// through their batch, sequence and head strides (the last dim is
// contiguous), so a padded KV cache is read without a copy and no KV head
// is repeated: q head h reads KV head h / n_rep.  o is (B, Sq, Hq, D)
// contiguous.
//
// Design (simple first; fp32 FMAs on the CUDA cores).  One CTA of 256
// threads per (batch row, KV head, tile of BQ query rows), where the rows
// of a tile are (position, head of the KV head's group) pairs, position
// major: the n_rep query heads that share a KV head share its K/V tiles.
// The Pallas grid's sequential kv axis becomes a loop over tiles of 64
// keys inside the CTA, restricted to the band of keys that the tile's
// rows can see (causal / window / kv_len).  Skipping the tiles outside
// the band is exact for rows that have a valid key (early all-masked
// tiles are wiped by alpha = exp(-1e30 - m) = 0); when a row of the tile
// has none (causal with q_pos < 0, len_b = 0, or a window wholly past a
// full cache) the CTA visits every key, so that row gets the mean of v
// like the reference.  Per key tile:
// K (transposed) and V are staged in shared memory as fp32 (16-byte
// global loads when the strides allow), each thread computes an RM x 4
// block of logits, the row max and sum are reduced across the 16 threads
// of a row with shuffles, p goes to shared memory, and each thread adds
// p @ V into its RM x D/16 accumulator block in registers.  BQ = 64 (RM =
// 4) for prefill; BQ = 16 (RM = 1) when a (batch, KV head) has at most 32
// query rows, as in decode.  D is padded to 64, 128 or 256 in shared
// memory; at D = 256, BQ = 64 the CTA takes 210 KB of shared memory and
// holds 64 fp32 accumulators per thread in registers (the 64 x 256 tile
// split across the 256 threads) rather than in shared memory.
//
// Bound.  Prefill at gemma3-1b's heads (D = 256, 4 query heads per KV
// head, S = 32k) is bound by operations: 4 * D flops per unmasked (query,
// key) pair, about 1,000 flops per byte moved, far above the card's ~300
// for bf16 tensor cores.  Decode (one query row per sequence) is bound by
// bytes: every valid K and V row is read once.  This kernel runs the
// products on the CUDA cores in fp32 (67 TFLOP/s at most, against 989 for
// bf16 tensor cores), so prefill sits well above its bound.  Left for
// later: wgmma tiles with TMA-fed K/V rings for bf16, and splitting long
// decode rows across CTAs.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;      // 16 row groups x 16 column groups
constexpr int kBK = 64;            // keys per tile
constexpr float kMasked = -1e30f;  // the reference's mask value

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
// v rounded to T and back: the reference casts p to v's type before p @ v
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// Row r of a tile -> element offset of its first column, or -1 when the
// row does not exist.  Rows are (first + r); row R sits at sequence
// position R / n_rep and head R % n_rep of the tile's head group.
struct Rows {
  int64_t base;
  int first, limit, n_rep;
  int64_t s_seq, s_head;
  __device__ __forceinline__ int64_t off(int r) const {
    const int rr = first + r;
    if (rr >= limit) return -1;
    return base + static_cast<int64_t>(rr / n_rep) * s_seq +
           static_cast<int64_t>(rr % n_rep) * s_head;
  }
};

// Stage `nrows` rows of `d` columns (zero-padded to DP, and zero for
// absent rows) into shared memory as fp32: dst[c * ld + r] when TRANS,
// else dst[r * ld + c].  VEC elements per load (16 bytes when VEC > 1;
// then d % VEC == 0 and every row start is 16-byte aligned).
template <typename T, int VEC, int DP, bool TRANS>
__device__ __forceinline__ void stage(float* __restrict__ dst, int ld,
                                      int nrows, const T* __restrict__ src,
                                      const Rows& rows, int d) {
  constexpr int G = DP / VEC;
  for (int g = threadIdx.x; g < nrows * G; g += kThreads) {
    const int r = g / G;
    const int c0 = (g % G) * VEC;
    float vals[VEC];
    const int64_t off = c0 < d ? rows.off(r) : -1;
    if (off >= 0) {
      if constexpr (VEC == 1) {
        vals[0] = to_f32(src[off + c0]);
      } else {
        const uint4 raw =
            __ldg(reinterpret_cast<const uint4*>(src + off + c0));
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < VEC; ++j) vals[j] = to_f32(e[j]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) vals[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      if (TRANS)
        dst[(c0 + j) * ld + r] = vals[j];
      else
        dst[r * ld + c0 + j] = vals[j];
    }
  }
}

template <typename T, int DP, int RM, int VEC>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o,
             const int32_t* __restrict__ kv_len, int sq, int sk, int hq,
             int hkv, int d, int64_t qsb, int64_t qss, int64_t qsh,
             int64_t ksb, int64_t kss, int64_t ksh, int64_t vsb, int64_t vss,
             int64_t vsh, int causal, int window, float scale) {
  constexpr int BQ = 16 * RM;        // query rows per tile
  constexpr int NC = DP / 16;        // accumulator columns per thread
  constexpr int LQ = BQ + 1;         // padded leading dims
  constexpr int LK = kBK + 1;
  extern __shared__ float smem[];
  float* qs = smem;                  // [DP][LQ]   q tile, transposed
  float* ks = qs + DP * LQ;          // [DP][LK]   k tile, transposed
  float* vs = ks + DP * LK;          // [kBK][DP]  v tile
  float* ps = vs + kBK * DP;         // [kBK][LQ]  p tile, transposed

  const int ty = threadIdx.x >> 4;   // row group: rows ty * RM + i
  const int tx = threadIdx.x & 15;   // column group
  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int n_rep = hq / hkv;
  const int rows_total = sq * n_rep;
  const int r0 = blockIdx.x * BQ;
  const int kvl = kv_len ? max(__ldg(kv_len + b), 0) : sk;
  const int len = min(kvl, sk);      // keys at or past len are masked
  const int shift = kvl - sq;        // q_pos = row's position + shift

  // The band of keys this tile's rows can see: a row at position p sees
  // [lo(p), hi(p)), both ends nondecreasing in p, so the rows with no
  // valid key are at the tile's ends (p < 0 under causal; p - window + 1
  // >= len past a full cache).
  const int r_last = min(rows_total, r0 + BQ) - 1;
  const int pos_lo = r0 / n_rep + shift;
  const int pos_hi = r_last / n_rep + shift;
  const int lo_first = window > 0 ? max(0, pos_lo - window + 1) : 0;
  const int hi_first = causal ? min(len, pos_lo + 1) : len;
  const int lo_last = window > 0 ? max(0, pos_hi - window + 1) : 0;
  const int hi_last = causal ? min(len, pos_hi + 1) : len;
  int k_begin = lo_first;
  int k_end = hi_last;
  if (hi_first <= lo_first || hi_last <= lo_last) {  // a row sees no key
    k_begin = 0;
    k_end = sk;
  }
  k_begin = (k_begin / kBK) * kBK;

  const Rows qrows{static_cast<int64_t>(b) * qsb +
                       static_cast<int64_t>(kvh) * n_rep * qsh,
                   r0, rows_total, n_rep, qss, qsh};
  stage<T, VEC, DP, true>(qs, LQ, BQ, q, qrows, d);

  int qpos[RM];
  float m[RM], l[RM], acc[RM][NC];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    qpos[i] = (r0 + ty * RM + i) / n_rep + shift;
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int64_t kbase = static_cast<int64_t>(b) * ksb +
                        static_cast<int64_t>(kvh) * ksh;
  const int64_t vbase = static_cast<int64_t>(b) * vsb +
                        static_cast<int64_t>(kvh) * vsh;
  for (int kt = k_begin; kt < k_end; kt += kBK) {
    __syncthreads();                 // the previous tile is consumed
    stage<T, VEC, DP, true>(ks, LK, kBK, k,
                            Rows{kbase, kt, sk, 1, kss, 0}, d);
    stage<T, VEC, DP, false>(vs, DP, kBK, v,
                             Rows{vbase, kt, sk, 1, vss, 0}, d);
    __syncthreads();

    float s[RM][4];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int dd = 0; dd < DP; ++dd) {
      float a[RM], bk[4];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = qs[dd * LQ + ty * RM + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = ks[dd * LK + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      bool exists[4];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = kt + tx + 16 * j;
        exists[j] = key < sk;
        const bool valid = key < len && (!causal || key <= qpos[i]) &&
                           (window <= 0 || qpos[i] - key < window);
        s[i][j] = valid ? s[i][j] * scale : kMasked;
        if (exists[j]) mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exists[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        ps[(tx + 16 * j) * LQ + ty * RM + i] = round_to<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();                 // p tile complete

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float p[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) p[i] = ps[kk * LQ + ty * RM + i];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = vs[kk * DP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < RM; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int rr = r0 + ty * RM + i;
    if (rr >= rows_total) continue;
    const int qi = rr / n_rep;
    const int head = kvh * n_rep + rr % n_rep;
    T* orow = o + ((static_cast<int64_t>(b) * sq + qi) * hq + head) * d;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < d) orow[col] = from_f32<T>(acc[i][c] / denom);
    }
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  const int32_t* kv_len;
  int b, sq, sk, hq, hkv, d;
  int64_t qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
  int causal, window;
  float scale;
};

template <typename T, int DP, int RM, int VEC>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int BQ = 16 * RM;
  const size_t smem = sizeof(float) * (DP * (BQ + 1) + DP * (kBK + 1) +
                                       kBK * DP + kBK * (BQ + 1));
  auto fn = flash_kernel<T, DP, RM, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows_total = a.sq * (a.hq / a.hkv);
  const dim3 grid((rows_total + BQ - 1) / BQ, a.hkv, a.b);
  fn<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.kv_len, a.sq, a.sk,
      a.hq, a.hkv, a.d, a.qsb, a.qss, a.qsh, a.ksb, a.kss, a.ksh, a.vsb,
      a.vss, a.vsh, a.causal, a.window, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DP, int RM>
int pick_vec(const Args& a, int vec, cudaStream_t s) {
  if (vec) return launch<T, DP, RM, 16 / sizeof(T)>(a, s);
  return launch<T, DP, RM, 1>(a, s);
}

template <typename T, int DP>
int pick_rm(const Args& a, int vec, cudaStream_t s) {
  if (a.sq * (a.hq / a.hkv) <= 32) return pick_vec<T, DP, 1>(a, vec, s);
  return pick_vec<T, DP, 4>(a, vec, s);
}

template <typename T>
int pick_dp(const Args& a, int vec, cudaStream_t s) {
  if (a.d <= 64) return pick_rm<T, 64>(a, vec, s);
  if (a.d <= 128) return pick_rm<T, 128>(a, vec, s);
  return pick_rm<T, 256>(a, vec, s);
}

}  // namespace

// Plain C interface (loaded with ctypes).  Launches on the given stream,
// does not synchronise, and returns cudaGetLastError() (0 if none), so a
// refused launch is reported.  Strides are in elements; the last dim of
// q, k and v is contiguous and o is contiguous (B, Sq, Hq, D).  kv_len is
// (B,) int32 or null.  window <= 0: no window.  dtype: 0 = fp32, 1 =
// bf16.  vec != 0: d is a multiple of 16 / sizeof(element) and every row
// start is 16-byte aligned.  Needs B, Sq, Sk >= 1, 1 <= D <= 256 and Hq a
// multiple of Hkv.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, const int32_t* kv_len, int32_t b,
                               int32_t sq, int32_t sk, int32_t hq,
                               int32_t hkv, int32_t d, int64_t qsb,
                               int64_t qss, int64_t qsh, int64_t ksb,
                               int64_t kss, int64_t ksh, int64_t vsb,
                               int64_t vss, int64_t vsh, int32_t causal,
                               int32_t window, float scale, int32_t dtype,
                               int32_t vec, void* stream) {
  const Args a{q,   k,   v,   o,   kv_len, b,   sq,     sk,     hq,
               hkv, d,   qsb, qss, qsh,    ksb, kss,    ksh,    vsb,
               vss, vsh, causal, window, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return pick_dp<float>(a, vec, s);
  return pick_dp<__nv_bfloat16>(a, vec, s);
}
