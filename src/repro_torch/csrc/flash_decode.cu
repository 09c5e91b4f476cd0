// Attention forward for decode, split over the key axis (flash-decoding),
// for Hopper (sm_90a): the decode variant of the port's flash_attention.
//
// Replaces the Pallas TPU kernel `flash_attention_pallas` (body
// `_flash_kernel`) in src/repro/kernels/flash_attention/kernel.py for
// calls with at most 16 query rows per (batch row, KV head) (decode: one
// position times n_rep heads) whose rows are 16-byte aligned, in fp32 or
// bf16; kernels/flash_attention/kernel.select_variant states the rule.
// The semantics are flash_attention.cu's, kept exactly (fp32 m, l and
// acc; masked logits -1e30, so a row with no valid key averages v over
// every key; keys at or past Sk take no part; q_pos = i + kv_len[b] - Sq;
// p rounded to v's type before p @ v; the division by max(l, 1e-30) at
// the end; K/V read in place through their strides, KV head h / n_rep).
//
// Bound.  At 4-16 rows the work is 4 flops per row per K/V element,
// about 4-16 flops per byte of K/V: bound by the bytes of the valid K/V
// rows (3.35 TB/s on an H100 SXM), which CUDA-core fp32 FMAs can keep up
// with.  What limited the one-CTA-per-(batch, KV head) design was the
// number of CTAs (128 for 132 SMs at decode_32k, 8 in an 8-sequence
// decode step) and one synchronous batch of loads in flight.
//
// Design.  Grid (splits, KV head, batch row): split s covers keys [s *
// chunk, (s + 1) * chunk), intersected with the band of keys its rows
// can see (every key when the first or last row sees none, the rule of
// flash_attention.cu); the wrapper picks `splits` from B, Hkv and Sk
// alone, so it never reads kv_len on the host.  A producer warp streams
// the chunk's K and V tiles (32 keys x D each) by TMA into a 3-stage ring
// guarded by full / empty mbarriers.  Each of 4 consumer warps takes 8
// keys of every tile: a lane holds 16 bytes of each row's columns (two
// such slices for fp32 at D > 128), forms the partial dot products of all
// (row, key) pairs of a batch of 32 / RP keys with q (fp32, shared
// memory), and a butterfly reduce-scatter leaves lane i the logit of pair
// i; the online softmax then runs per warp over its keys, and p is
// broadcast back by shuffles for p @ V.  Each warp writes its partial (m,
// l in log2 units, acc) in fp32 to scratch; an empty chunk writes (m =
// -1e30 log2(e), l = 0, acc = 0).  A second kernel combines the partials
// of a row in a fixed order (deterministic): M = max m, weights 2^(m -
// M), o = sum(w acc) / max(sum(w l), 1e-30) in q's type.  An empty or
// all-masked partial weighs 2^(-1e30 - M) = 0 when the row has a valid
// key; a row with none visits every key in every split and gets the mean
// of v, as the reference.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_wait;

constexpr int kBK = 32;             // keys per tile
constexpr int kWarps = 4;           // consumer warps; 8 keys each per tile
constexpr int kThreads = 32 * (kWarps + 1);   // and one producer warp
constexpr int kStages = 3;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMasked2 = -1e30f * kLog2e;   // the reference's -1e30, log2
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
// v rounded to T and back: the reference casts p to v's type before p @ v
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// 16 bytes of T at p (16-byte aligned) as VEC floats
template <typename T, int VEC>
__device__ __forceinline__ void load16(const T* p, float (&out)[VEC]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = to_f32(e[i]);
}

// One step of a butterfly reduce-scatter of 2 * O values over the warp:
// the lanes with bit O set keep the upper half, the others the lower, each
// adding its partner's copy; after the steps 16, 8, .., 1 lane i holds
// the warp's sum of value i in part[0].
template <int O>
__device__ __forceinline__ void scatter_step(float (&part)[32], int lane) {
  const bool up = lane & O;
#pragma unroll
  for (int x = 0; x < O; ++x) {
    const float send = up ? part[x] : part[x + O];
    const float keep = up ? part[x + O] : part[x];
    part[x] = keep + __shfl_xor_sync(kFull, send, O);
  }
}

struct Params {
  const void* q;
  float* part_ml;      // (B * Hkv, ns, RP, 2): m (log2 units), l
  float* part_acc;     // (B * Hkv, ns, RP, D)
  const int32_t* kv_len;
  int sq, sk, hkv, d, n_rep, rows, chunk, ns;
  int64_t qsb, qss, qsh;
  int causal, window;
  float scale_log2;    // 1 / sqrt(D) * log2(e)
};

template <typename T, int RP, int NV>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const Params p) {
  constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte slice
  constexpr int DC = NV * 32 * VEC;     // columns the lanes cover
  constexpr int K = 32 / RP;            // keys per batch: RP * K = 32 pairs
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  float* qs = reinterpret_cast<float*>(base);           // [RP][DC] fp32
  uint8_t* tiles = base + RP * DC * sizeof(float);
  const int tile_bytes = kBK * p.d * static_cast<int>(sizeof(T));
  uint64_t* full = reinterpret_cast<uint64_t*>(tiles + 2 * kStages * tile_bytes);
  uint64_t* empty = full + kStages;

  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int n_rep = p.n_rep;
  const int kvl = p.kv_len ? max(__ldg(p.kv_len + b), 0) : p.sk;
  const int len = min(kvl, p.sk);
  const int shift = kvl - p.sq;

  // the band of keys the rows can see (all keys when a row sees none)
  const int pos_lo = shift;
  const int pos_hi = (p.rows - 1) / n_rep + shift;
  const int lo_first = p.window > 0 ? max(0, pos_lo - p.window + 1) : 0;
  const int hi_first = p.causal ? min(len, pos_lo + 1) : len;
  const int lo_last = p.window > 0 ? max(0, pos_hi - p.window + 1) : 0;
  const int hi_last = p.causal ? min(len, pos_hi + 1) : len;
  int k_begin = lo_first;
  int k_end = hi_last;
  if (hi_first <= lo_first || hi_last <= lo_last) {  // a row sees no key
    k_begin = 0;
    k_end = p.sk;
  }
  k_begin = (k_begin / kBK) * kBK;
  const int c0 = split * p.chunk;
  const int start = max(c0, k_begin);
  const int end = min(min(p.sk, c0 + p.chunk), k_end);
  const int n_tiles = start < end ? (end - start + kBK - 1) / kBK : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 32 * kWarps);
    }
    hopper::mbar_init_fence();
  }
  // q rows (position r / n_rep, head kvh * n_rep + r % n_rep) as fp32,
  // zero past the rows and past D
  const T* q = static_cast<const T*>(p.q);
  for (int i = threadIdx.x; i < RP * DC; i += kThreads) {
    const int r = i / DC;
    const int c = i % DC;
    float val = 0.f;
    if (r < p.rows && c < p.d)
      val = to_f32(q[b * p.qsb + static_cast<int64_t>(r / n_rep) * p.qss +
                     static_cast<int64_t>(kvh * n_rep + r % n_rep) * p.qsh +
                     c]);
    qs[i] = val;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp == kWarps) {
    // ---------------------------------------------------------- producer
    if (lane == 0) {
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        mbar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * tile_bytes);
        const int kt = start + i * kBK;
        hopper::tma_load_4d(tiles + 2 * st * tile_bytes, &kmap, &full[st], 0,
                            kvh, kt, b);
        hopper::tma_load_4d(tiles + (2 * st + 1) * tile_bytes, &vmap,
                            &full[st], 0, kvh, kt, b);
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int my_r = lane / K;                // the pair lane i ends with
  const int my_j = lane % K;
  const int my_qp = my_r / n_rep + shift;
  float m_own = kMasked2, l_own = 0.f;      // this lane's row's state
  float acc[RP][NV][VEC];
#pragma unroll
  for (int r = 0; r < RP; ++r)
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[r][v][e] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    const int kt = start + i * kBK;
    mbar_wait(&full[st], (i / kStages) & 1);
    const T* ks = reinterpret_cast<const T*>(tiles + 2 * st * tile_bytes);
    const T* vs = reinterpret_cast<const T*>(tiles + (2 * st + 1) * tile_bytes);
#pragma unroll
    for (int bt = 0; bt < 8 / K; ++bt) {
      const int kb = warp * 8 + bt * K;     // the batch's first key in the tile
      float part[32];
#pragma unroll
      for (int x = 0; x < 32; ++x) part[x] = 0.f;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int col = (v * 32 + lane) * VEC;
        if (col < p.d) {
          float kx[K][VEC];
#pragma unroll
          for (int j = 0; j < K; ++j)
            load16<T, VEC>(ks + (kb + j) * p.d + col, kx[j]);
#pragma unroll
          for (int r = 0; r < RP; ++r) {
            float qv[VEC];
#pragma unroll
            for (int e = 0; e < VEC; e += 4) {
              const float4 f = *reinterpret_cast<const float4*>(
                  qs + r * DC + col + e);
              qv[e] = f.x;
              qv[e + 1] = f.y;
              qv[e + 2] = f.z;
              qv[e + 3] = f.w;
            }
#pragma unroll
            for (int j = 0; j < K; ++j)
#pragma unroll
              for (int e = 0; e < VEC; ++e)
                part[r * K + j] = fmaf(qv[e], kx[j][e], part[r * K + j]);
          }
        }
      }
      // reduce-scatter over the 32 lanes: lane i ends with pair i's sum
      scatter_step<16>(part, lane);
      scatter_step<8>(part, lane);
      scatter_step<4>(part, lane);
      scatter_step<2>(part, lane);
      scatter_step<1>(part, lane);
      const int key = kt + kb + my_j;
      const bool valid = key < len && (!p.causal || key <= my_qp) &&
                         (p.window <= 0 || my_qp - key < p.window);
      const float s = key < p.sk ? (valid ? part[0] * p.scale_log2 : kMasked2)
                                 : -INFINITY;
      // online softmax over the K lanes of the row
      float mx = s;
#pragma unroll
      for (int o = K / 2; o >= 1; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float m_new = fmaxf(m_own, mx);
      const float pe = exp2f(s - m_new);
      const float alpha = exp2f(m_own - m_new);
      float sum = pe;
#pragma unroll
      for (int o = K / 2; o >= 1; o >>= 1)
        sum += __shfl_xor_sync(kFull, sum, o);
      l_own = l_own * alpha + sum;
      m_own = m_new;
      const float pr = round_to<T>(pe);
#pragma unroll
      for (int r = 0; r < RP; ++r) {
        const float ar = __shfl_sync(kFull, alpha, r * K);
#pragma unroll
        for (int v = 0; v < NV; ++v)
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[r][v][e] *= ar;
      }
      // acc += p V over the batch's keys
#pragma unroll
      for (int j = 0; j < K; ++j) {
        float pj[RP];
#pragma unroll
        for (int r = 0; r < RP; ++r) pj[r] = __shfl_sync(kFull, pr, r * K + j);
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const int col = (v * 32 + lane) * VEC;
          if (col < p.d) {
            float vx[VEC];
            load16<T, VEC>(vs + (kb + j) * p.d + col, vx);
#pragma unroll
            for (int r = 0; r < RP; ++r)
#pragma unroll
              for (int e = 0; e < VEC; ++e)
                acc[r][v][e] = fmaf(pj[r], vx[e], acc[r][v][e]);
          }
        }
      }
    }
    mbar_arrive(&empty[st]);                // the stage may be refilled
  }

  // this warp's partial
  const int64_t idx = (static_cast<int64_t>(b) * p.hkv + kvh) * p.ns +
                      split * kWarps + warp;
  if (my_j == 0) {
    p.part_ml[(idx * RP + my_r) * 2] = m_own;
    p.part_ml[(idx * RP + my_r) * 2 + 1] = l_own;
  }
#pragma unroll
  for (int r = 0; r < RP; ++r)
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int col = (v * 32 + lane) * VEC;
      if (col < p.d) {
        float* dst = p.part_acc + (idx * RP + r) * p.d + col;
#pragma unroll
        for (int e = 0; e < VEC; e += 4)
          *reinterpret_cast<float4*>(dst + e) =
              make_float4(acc[r][v][e], acc[r][v][e + 1], acc[r][v][e + 2],
                          acc[r][v][e + 3]);
      }
    }
}

// One CTA per (row, batch row x KV head): o = sum_s w_s acc_s /
// max(sum_s w_s l_s, 1e-30), w_s = 2^(m_s - max m), s in order.
template <typename T>
__global__ void __launch_bounds__(128)
combine_kernel(const float* __restrict__ ml, const float* __restrict__ acc,
               T* __restrict__ o, int sq, int hq, int hkv, int d, int n_rep,
               int rp, int ns) {
  extern __shared__ float wts[];            // [ns]
  const int r = blockIdx.x;
  const int bh = blockIdx.y;
  const int64_t base = static_cast<int64_t>(bh) * ns * rp + r;  // (bh, 0, r)
  float big = kMasked2;
  for (int s = 0; s < ns; ++s) big = fmaxf(big, ml[2 * (base + s * rp)]);
  for (int s = threadIdx.x; s < ns; s += blockDim.x) {
    const float wt = exp2f(ml[2 * (base + s * rp)] - big);  // this partial's weight
    wts[s] = wt;
  }
  __syncthreads();
  float l = 0.f;
  for (int s = 0; s < ns; ++s) l += wts[s] * ml[2 * (base + s * rp) + 1];
  const float den = fmaxf(l, 1e-30f);
  const int b = bh / hkv;
  const int kvh = bh % hkv;
  T* orow = o + ((static_cast<int64_t>(b) * sq + r / n_rep) * hq +
                 kvh * n_rep + r % n_rep) * d;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float sum = 0.f;
    for (int s = 0; s < ns; ++s) sum += wts[s] * acc[(base + s * rp) * d + c];
    orow[c] = from_f32<T>(sum / den);
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
  int splits;
  float *part_ml, *part_acc;
};

template <typename T, int RP, int NV>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int DC = NV * 32 * VEC;
  const uint64_t es = sizeof(T);
  const auto type = sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  // k, v as (D, KV head, key, batch): a box is one tile, 32 keys x D
  CUtensorMap km, vm;
  const uint64_t dim[4] = {uint64_t(a.d), uint64_t(a.hkv), uint64_t(a.sk),
                           uint64_t(a.b)};
  const uint32_t box[4] = {uint32_t(a.d), 1, kBK, 1};
  const uint64_t kstr[3] = {a.ksh * es, a.kss * es, a.ksb * es};
  const uint64_t vstr[3] = {a.vsh * es, a.vss * es, a.vsb * es};
  int rc = hopper::make_map(&km, type, 4, a.k, dim, kstr, box,
                            CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc) return rc;
  rc = hopper::make_map(&vm, type, 4, a.v, dim, vstr, box,
                        CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc) return rc;

  const int rows = a.sq * (a.hq / a.hkv);
  const int ns = a.splits * kWarps;
  int chunk = (a.sk + a.splits - 1) / a.splits;
  chunk = (chunk + kBK - 1) / kBK * kBK;
  const Params p{a.q,      a.part_ml, a.part_acc, a.kv_len, a.sq,
                 a.sk,     a.hkv,     a.d,        a.hq / a.hkv, rows,
                 chunk,    ns,        a.qsb,      a.qss,  a.qsh,
                 a.causal, a.window,  a.scale * kLog2e};
  const int smem = 128 + RP * DC * 4 + 2 * kStages * kBK * a.d * int(es) +
                   2 * kStages * 8;
  auto fn = flash_decode_kernel<T, RP, NV>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fn<<<dim3(a.splits, a.hkv, a.b), kThreads, smem, stream>>>(km, vm, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  combine_kernel<T><<<dim3(rows, a.b * a.hkv), 128, ns * sizeof(float),
                      stream>>>(a.part_ml, a.part_acc, static_cast<T*>(a.o),
                                a.sq, a.hq, a.hkv, a.d, a.hq / a.hkv, RP, ns);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int RP>
int pick_nv(const Args& a, cudaStream_t s) {
  // 16-byte slices of 32 lanes: one covers D <= 256 in bf16, 128 in fp32
  if constexpr (sizeof(T) == 2) {
    return launch<T, RP, 1>(a, s);
  } else {
    if (a.d <= 128) return launch<T, RP, 1>(a, s);
    return launch<T, RP, 2>(a, s);
  }
}

template <typename T>
int pick_rp(const Args& a, cudaStream_t s) {
  if (a.sq * (a.hq / a.hkv) <= 4) return pick_nv<T, 4>(a, s);
  return pick_nv<T, 16>(a, s);
}

}  // namespace

// Plain C interface (loaded with ctypes), flash_attention.cu's arguments
// plus the split count and the fp32 scratch for the partials: part_ml
// (B * Hkv * splits * 4 * RP * 2) and part_acc (B * Hkv * splits * 4 *
// RP * D), RP = 4 when Sq * Hq / Hkv <= 4, else 16.  Needs Sq * Hq / Hkv
// <= 16, every row start 16-byte aligned and D * sizeof(element) a
// multiple of 16, D <= 256.  dtype: 0 = fp32, 1 = bf16.  Launches the
// split kernel and the combine on the given stream, does not
// synchronise, and returns 0 or a CUDA error code.
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            void* o, const int32_t* kv_len, int32_t b,
                            int32_t sq, int32_t sk, int32_t hq, int32_t hkv,
                            int32_t d, int64_t qsb, int64_t qss, int64_t qsh,
                            int64_t ksb, int64_t kss, int64_t ksh,
                            int64_t vsb, int64_t vss, int64_t vsh,
                            int32_t causal, int32_t window, float scale,
                            int32_t dtype, int32_t splits, float* part_ml,
                            float* part_acc, void* stream) {
  const Args a{q,   k,   v,      o,      kv_len, b,     sq,     sk,
               hq,  hkv, d,      qsb,    qss,    qsh,   ksb,    kss,
               ksh, vsb, vss,    vsh,    causal, window, scale, splits,
               part_ml, part_acc};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return pick_rp<float>(a, s);
  return pick_rp<__nv_bfloat16>(a, s);
}
