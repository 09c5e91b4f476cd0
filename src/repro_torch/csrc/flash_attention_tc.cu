// Online-softmax attention forward on Hopper's bf16 tensor cores
// (sm_90a): the prefill variant of the port's flash_attention.
//
//   o[b, i, h] = softmax_k(mask(q[b, i, h] . k[b, k, h / n_rep] * scale))
//                @ v[b, :, h / n_rep]
//
// Replaces the Pallas TPU kernel `flash_attention_pallas` (body
// `_flash_kernel`) in src/repro/kernels/flash_attention/kernel.py for bf16
// inputs whose rows are 16-byte aligned and whose D is a multiple of 16
// (up to 256), with more than 16 query rows per (batch row, KV head);
// kernels/flash_attention/kernel.select_variant states the rule.  The
// semantics are flash_attention.cu's (the fp32 CUDA-core variant), kept
// exactly: fp32 m, l and O; masked logits -1e30, so a row with no valid
// key averages v over every key; keys at or past Sk take no part; rows
// end-aligned at q_pos = i + kv_len[b] - Sq; p rounded to bf16 before
// p @ v (the reference's `p.astype(v.dtype)`), l summed from the fp32 p;
// the division by max(l, 1e-30) at the end; window and causal masks; K/V
// read in place through their strides, KV head h / n_rep.
//
// Bound.  At gemma3-1b's heads (D 256, n_rep 4) prefill does 4 * D flops
// per unmasked (query, key) pair, about 1,000 per byte moved: it is
// bound by the tensor cores (989 TFLOP/s bf16 dense on an H100 SXM).
//
// Design.  One CTA per (tile of query rows, KV head, batch row), the
// longest causal tiles launched first.  A tile's 128 rows are (position,
// head of the KV head's group) pairs, position major: 128 / n_rep
// positions times n_rep heads, so the n_rep query heads share every K/V
// tile and no KV head is repeated.  Three warpgroups:
//  - a producer (one thread issues, setmaxnreg gives its registers away)
//    loads Q once, then K and V tiles of 64 keys by TMA into a ring of
//    2-4 stages guarded by full / empty mbarriers;
//  - two consumer warpgroups of 64 rows each run, per tile:
//    S = Q K^T with wgmma (Q and K from shared memory, fp32 in
//    registers), the mask (only on tiles that need it) and the online
//    softmax on the accumulator fragment, P converted to bf16 in
//    registers as wgmma's A operand (O rescaled only when a row's max
//    moved), and O += P V with wgmma (V from shared memory as the
//    transposed B operand); then release the stage.
// Tiles are stored as 64-column blocks of 128-byte rows with the 128-byte
// swizzle that TMA writes and wgmma reads (descriptors below).  D is
// padded to a multiple of 64 by TMA's zero fill.  At D = 256 the CTA
// takes Q 64 KB + 2 x (K 32 KB + V 32 KB) of shared memory, and each
// consumer thread holds its rows' 64 x 256 O (128 registers) and 64 x 64
// S (32 registers).  The band of key tiles a CTA visits, and the
// blind-row rule (visit every key when the tile's first or last row sees
// none), are flash_attention.cu's.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_wait;
using hopper::smem_u32;

constexpr int kBQ = 128;            // query rows per CTA
constexpr int kBK = 64;             // keys per tile
constexpr int kConsumers = 256;     // two consumer warpgroups
constexpr int kThreads = 384;       // and one producer warpgroup
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMasked2 = -1e30f * kLog2e;  // the reference's -1e30, log2

template <int DP>
struct Cfg {
  static constexpr int kBlocks = DP / 64;             // 64-column blocks
  static constexpr int kQBytes = kBlocks * kBQ * 128;
  static constexpr int kTileBytes = kBlocks * kBK * 128;  // K or V tile
  static constexpr int kStages = DP == 256 ? 2 : (DP == 192 ? 3 : 4);
  static constexpr int kSmem = kQBytes + 2 * kStages * kTileBytes;
  static constexpr int kAlloc = kSmem + 1024 + 64 * 8;  // align, barriers
};

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (bits
// 62-63).  K-major tiles (Q, K): SBO = 1024 bytes between 8-row groups,
// LBO unused.  V as the transposed (MN-major) B operand: SBO = 1024 bytes
// between groups of 8 keys, LBO = the stride between 64-column blocks.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving reads or writes of wgmma's registers
// across the asynchronous product.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// D (64 x 64, fp32) (+)= A (64 x 16, shared) . B (16 x 64, shared, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, fp32) += A (64 x 16, registers) . B (16 x 64, shared,
// MN-major: the transposed operand)
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

struct Params {
  __nv_bfloat16* o;
  const int32_t* kv_len;
  int sq, sk, hq, d, n_rep, bqp;   // bqp: positions per CTA
  int causal, window;
  float scale_log2;                // 1 / sqrt(D) * log2(e)
};

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap, const Params p) {
  using C = Cfg<DP>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ks = qs + C::kQBytes;                    // [stage] K tiles
  uint8_t* vs = ks + C::kStages * C::kTileBytes;    // [stage] V tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(vs + C::kStages * C::kTileBytes);
  uint64_t* empty = full + C::kStages;
  uint64_t* qfull = empty + C::kStages;

  const int tile = gridDim.x - 1 - blockIdx.x;     // longest tiles first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int n_rep = p.n_rep;
  const int p0 = tile * p.bqp;                      // first position
  const int rows = p.bqp * n_rep;                   // rows with a q row
  const int kvl = p.kv_len ? max(__ldg(p.kv_len + b), 0) : p.sk;
  const int len = min(kvl, p.sk);                   // keys >= len masked
  const int shift = kvl - p.sq;                     // q_pos = position + shift

  // The band of keys the tile's rows can see: both ends rise with the
  // position, so only the first or last row can see no key; then every
  // key is visited (those rows average v, as the reference).
  const int pos_lo = p0 + shift;
  const int pos_hi = min(p.sq, p0 + p.bqp) - 1 + shift;
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
  const int n_tiles = (k_end - k_begin + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumers);
    }
    hopper::mbar_init(qfull, 1);
    hopper::mbar_init_fence();
  }
  // Rows past rows (128 % n_rep of them) get no TMA box: zero them, so
  // that their S and O rows, which are never stored, stay finite.
  if (threadIdx.x < kConsumers && rows < kBQ) {
    const int per_blk = (kBQ - rows) * 8;           // 16-byte words
    for (int i = threadIdx.x; i < C::kBlocks * per_blk; i += kConsumers) {
      const int blk = i / per_blk;
      const int w = i % per_blk;
      reinterpret_cast<uint4*>(qs + blk * kBQ * 128 + rows * 128)[w] =
          make_uint4(0, 0, 0, 0);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(qfull, C::kBlocks * rows * 128);
#pragma unroll
      for (int blk = 0; blk < C::kBlocks; ++blk)
        hopper::tma_load_5d(qs + blk * kBQ * 128, &qmap, qfull, blk * 64, 0,
                            kvh, p0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % C::kStages;
        const int kt = k_begin + i * kBK;
        mbar_wait(&empty[st], ((i / C::kStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * C::kTileBytes);
        uint8_t* kd = ks + st * C::kTileBytes;
        uint8_t* vd = vs + st * C::kTileBytes;
#pragma unroll
        for (int blk = 0; blk < C::kBlocks; ++blk) {
          hopper::tma_load_4d(kd + blk * kBK * 128, &kmap, &full[st],
                              blk * 64, kvh, kt, b);
          hopper::tma_load_4d(vd + blk * kBK * 128, &vmap, &full[st],
                              blk * 64, kvh, kt, b);
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = threadIdx.x / 128;
    const int lane = threadIdx.x % 32;
    const int r0 = wg * 64 + ((threadIdx.x % 128) / 32) * 16 + lane / 4;
    const int r1 = r0 + 8;                         // this thread's two rows
    const int qp0 = p0 + r0 / n_rep + shift;
    const int qp1 = p0 + r1 / n_rep + shift;
    const int col = 2 * (lane % 4);                // first column of a pair
    float o[C::kBlocks][32];
#pragma unroll
    for (int c = 0; c < C::kBlocks; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
    float m0 = kMasked2, m1 = kMasked2, l0 = 0.f, l1 = 0.f;
    const uint32_t qaddr = smem_u32(qs) + wg * 64 * 128;

    mbar_wait(qfull, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % C::kStages;
      const int kt = k_begin + i * kBK;
      mbar_wait(&full[st], (i / C::kStages) & 1);

      // S = Q K^T
      float s[32];
      const uint32_t kaddr = smem_u32(ks + st * C::kTileBytes);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;   // 16 columns in the block
        wgmma_ss(s, desc(qaddr + (kk / 4) * kBQ * 128 + off, 16, 1024),
                 desc(kaddr + (kk / 4) * kBK * 128 + off, 16, 1024), kk > 0);
      }
      wg_commit();
      wg_wait0();
      reg_fence(s);

      // mask (tiles at the band's edges only) and scale to log2 units;
      // keys at or past Sk take no part (-inf: p = 0, not in the max)
      const bool edge = kt + kBK > len ||
                        (p.causal && kt + kBK - 1 > pos_lo) ||
                        (p.window > 0 && pos_hi - kt >= p.window);
      if (edge) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kt + 8 * j + col + (e & 1);
            const int qp = e < 2 ? qp0 : qp1;
            const bool valid = key < len && (!p.causal || key <= qp) &&
                               (p.window <= 0 || qp - key < p.window);
            const float x = valid ? s[4 * j + e] * p.scale_log2 : kMasked2;
            s[4 * j + e] = key < p.sk ? x : -INFINITY;
          }
      } else {
#pragma unroll
        for (int i2 = 0; i2 < 32; ++i2) s[i2] *= p.scale_log2;
      }

      // online softmax: rows r0 (s[4j], s[4j+1]) and r1 (s[4j+2], s[4j+3]),
      // each spread over the 4 threads of a quad
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float a0 = exp2f(m0 - mx0);
      const float a1 = exp2f(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      float sum0 = 0.f, sum1 = 0.f;
      uint32_t pa[4][4];                 // P in bf16: wgmma's A fragments
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float e8[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          e8[u] = exp2f(s[8 * t + u] - ((u & 2) ? m1 : m0));
          if (u & 2)
            sum1 += e8[u];
          else
            sum0 += e8[u];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          pa[t][u] = pack_bf16(e8[2 * u], e8[2 * u + 1]);
      }
      l0 = l0 * a0 + sum0;               // thread-partial sums over keys
      l1 = l1 * a1 + sum1;
      if (a0 != 1.f || a1 != 1.f)        // a row's max moved: rescale O
#pragma unroll
        for (int c = 0; c < C::kBlocks; ++c)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            o[c][4 * j] *= a0;
            o[c][4 * j + 1] *= a0;
            o[c][4 * j + 2] *= a1;
            o[c][4 * j + 3] *= a1;
          }

      // O += P V
      const uint32_t vaddr = smem_u32(vs + st * C::kTileBytes);
#pragma unroll
      for (int c = 0; c < C::kBlocks; ++c) reg_fence(o[c]);
      wg_fence();
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int c = 0; c < C::kBlocks; ++c)
          wgmma_rs_tb(o[c], pa[t],
                      desc(vaddr + c * kBK * 128 + t * 2048, kBK * 128, 1024));
      wg_commit();
      wg_wait0();
#pragma unroll
      for (int c = 0; c < C::kBlocks; ++c) reg_fence(o[c]);
      mbar_arrive(&empty[st]);           // the stage may be refilled
    }

    // epilogue: O / max(l, 1e-30) in bf16
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? r1 : r0;
      const int pos = p0 + r / n_rep;
      if (r >= rows || pos >= p.sq) continue;
      const int head = kvh * n_rep + r % n_rep;
      __nv_bfloat16* orow =
          p.o + ((static_cast<int64_t>(b) * p.sq + pos) * p.hq + head) * p.d;
      const float den = fmaxf(half ? l1 : l0, 1e-30f);
#pragma unroll
      for (int c = 0; c < C::kBlocks; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int cc = c * 64 + 8 * j + col;
          if (cc < p.d)
            *reinterpret_cast<__nv_bfloat162*>(orow + cc) =
                __floats2bfloat162_rn(o[c][4 * j + 2 * half] / den,
                                      o[c][4 * j + 2 * half + 1] / den);
        }
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

template <int DP>
int launch(const Args& a, cudaStream_t stream) {
  using C = Cfg<DP>;
  const int n_rep = a.hq / a.hkv;
  const int bqp = kBQ / n_rep;
  constexpr auto BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr auto SW128 = CU_TENSOR_MAP_SWIZZLE_128B;
  const uint64_t es = 2;
  // q as (D, head in group, KV head, position, batch): a box of 64
  // columns x n_rep heads x bqp positions is one tile's rows, position
  // major, in one 64-column block
  CUtensorMap qm, km, vm;
  const uint64_t qdim[5] = {uint64_t(a.d), uint64_t(n_rep), uint64_t(a.hkv),
                            uint64_t(a.sq), uint64_t(a.b)};
  const uint64_t qstr[4] = {a.qsh * es, a.qsh * n_rep * es, a.qss * es,
                            a.qsb * es};
  const uint32_t qbox[5] = {64, uint32_t(n_rep), 1, uint32_t(bqp), 1};
  int rc = hopper::make_map(&qm, BF16, 5, a.q, qdim, qstr, qbox, SW128);
  if (rc) return rc;
  // k, v as (D, KV head, key, batch): a box is 64 columns x 64 keys
  const uint64_t kdim[4] = {uint64_t(a.d), uint64_t(a.hkv), uint64_t(a.sk),
                            uint64_t(a.b)};
  const uint32_t kbox[4] = {64, 1, kBK, 1};
  const uint64_t kstr[3] = {a.ksh * es, a.kss * es, a.ksb * es};
  const uint64_t vstr[3] = {a.vsh * es, a.vss * es, a.vsb * es};
  rc = hopper::make_map(&km, BF16, 4, a.k, kdim, kstr, kbox, SW128);
  if (rc) return rc;
  rc = hopper::make_map(&vm, BF16, 4, a.v, kdim, vstr, kbox, SW128);
  if (rc) return rc;

  auto fn = flash_tc_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kAlloc);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Params p{static_cast<__nv_bfloat16*>(a.o), a.kv_len, a.sq, a.sk,
                 a.hq, a.d, n_rep, bqp, a.causal, a.window,
                 a.scale * kLog2e};
  const dim3 grid((a.sq + bqp - 1) / bqp, a.hkv, a.b);
  fn<<<grid, kThreads, C::kAlloc, stream>>>(qm, km, vm, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes), flash_attention.cu's arguments
// without dtype and vec: q, k, v bf16, every row start 16-byte aligned
// (strides in elements, multiples of 8), D a multiple of 16 in 16..256,
// Hq a multiple of Hkv with Hq / Hkv <= 128.  Launches on the given
// stream, does not synchronise, and returns 0 or a CUDA error code.
extern "C" int flash_attention_tc(const void* q, const void* k, const void* v,
                                  void* o, const int32_t* kv_len, int32_t b,
                                  int32_t sq, int32_t sk, int32_t hq,
                                  int32_t hkv, int32_t d, int64_t qsb,
                                  int64_t qss, int64_t qsh, int64_t ksb,
                                  int64_t kss, int64_t ksh, int64_t vsb,
                                  int64_t vss, int64_t vsh, int32_t causal,
                                  int32_t window, float scale, void* stream) {
  const Args a{q,   k,   v,   o,   kv_len, b,   sq,     sk,     hq,
               hkv, d,   qsb, qss, qsh,    ksb, kss,    ksh,    vsb,
               vss, vsh, causal, window, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64) return launch<64>(a, s);
  if (d <= 128) return launch<128>(a, s);
  if (d <= 192) return launch<192>(a, s);
  return launch<256>(a, s);
}
