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
// component-major (C, N) padded to 1024).  The kernel masks its own tail.
//
// Bound: HBM bytes.  A pass reads N*C*4 bytes per stamp table (plus N*C*4
// for qs) and writes N bytes (or N/8 in the bit form), and does C integer
// compares per row; at C=3 that is ~0.25 ops per byte, far below the
// card's compute-to-bandwidth ratio.  The data alone needs less: a row
// whose epoch differs from the query's is decided by its epoch word.  But
// in the row-major layout a row's clock words share its 32-byte sectors,
// and the rows that tie the epoch are spread over the table, so nearly
// every sector crosses HBM anyway: the whole table's bytes are the bound
// this layout can reach.
//
// One kernel body (compare_tiles) in four modes:
//   before:       rows[i] ≺ q          (q one (C,) stamp)
//   pairs:        rows[i] ≺ qs[i]      (qs (N, C) like rows)
//   visibility:   create[i] ≺ q and not delete[i] ≺ q
//   residue:      visibility's bits, and the list of the rows whose create
//                 or delete stamp is concurrent with q (neither ≺ q nor
//                 q ≺ it: same epoch, vector-incomparable or equal), the
//                 rows that a query refines through the timeline oracle
// The first three launch as compare_kernel, the fourth as
// visibility_residue_kernel, so that a device trace tells them apart.
// A block of 8 warps owns a block tile of 1,024 consecutive rows at a
// time, whose rows are contiguous, 1024*C*4 bytes (a multiple of 16).  One
// thread moves the whole block tile of each table the mode reads (rows;
// rows and qs; create and delete rows) into shared memory with one bulk
// copy per table (cp.async.bulk: the TMA engine moves it in 16-byte
// granules, with no registers, and counts its bytes on the slot's
// mbarrier).  The block keeps a ring of 2 such slots, so that the next
// block tile is on its way while its warps evaluate one, each warp its own
// 128 rows.  Large copies matter on this card: with a warp-sized 1.5 KB
// tile per copy, or with per-lane 16-byte cp.async copies into a ring per
// warp, the same kernel read HBM more slowly than with 12 KB block tiles.
// Each lane evaluates rows lane + 32*j of its warp's 128 from shared
// memory: with odd C (3, 9) the 32 lanes of one read hit 32 distinct
// banks; an even C costs a gcd(C, 32)-way conflict on each word read (2-way
// at C = 2, 8-way at C = 8).  The evaluation's instructions are of the
// order of the copy's time at C = 3, so the row width is a template for
// C = 2..9 (1 to 8 gatekeepers): the loop over C unrolls and the shared
// query q stays in registers; other widths read C at run time, with q in
// shared memory, loaded once per block.  Each warp-wide predicate becomes
// one 32-bit word by __ballot_sync, and the output is a template:
//   bytes: one 0/1 byte per row (torch.bool storage); lane L stores rows
//          4L..4L+3 of its warp's 128 as one 4-byte word;
//   bits:  one uint32 per 32 rows, bit k = row k (least significant
//          first: np.unpackbits(..., bitorder="little")), N/8 bytes.
// The grid is persistent (as many blocks as fit on the card at once), the
// blocks striding over block tiles with 64-bit indices.  The ragged last
// block tile, and every tile whose tables do not all start 16-byte aligned
// (a row view at an odd offset), are staged by the block with 4-byte loads
// instead; the evaluation and the stores are the same.  A slot whose bytes
// never all arrive traps after kWaitNs instead of holding the card.
//
// Residue list: a uint64 count at res[0], then up to `cap` entries at
// res[1..], each `row << 4 | flags` (bit 0 the create stamp concurrent
// with q, bit 1 the delete stamp concurrent, bit 2 create ≺ q, bit 3
// delete ≺ q), in no set order.  A warp with a concurrent row among its
// 128 takes its entries' places with one atomicAdd on the count; the
// count keeps counting past `cap`, so the caller sees an overflow.  In a
// live deployment the list is short (the rows written since the last
// clock announce), so its cost is the rare warp's atomic.
//
// `mv_compare_host` is the host entries' round trip: one host-to-device
// copy of the packed inputs, the bit-form compare in any mode, one
// device-to-host copy of the bit words, all on one stream without
// synchronising.

#include <cstdint>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

// What a launch compares; the values are the C interface's `mode`.
enum class Mode : int { kBefore = 0, kPairs = 1, kVisibility = 2,
                        kResidue = 3 };

// residue entries' flag bits (the module note)
constexpr uint32_t kCreateConc = 1;
constexpr uint32_t kDeleteConc = 2;
constexpr uint32_t kCreateBefore = 4;
constexpr uint32_t kDeleteBefore = 8;
constexpr int kFlagBits = 4;

constexpr int32_t kNoStamp = 0x7fffffff;
constexpr int kThreads = 256;
constexpr int kTile = 128;                 // rows a warp evaluates at a time
constexpr int kPerLane = kTile / 32;       // rows a lane evaluates per tile
constexpr int kMaxWarps = 8;               // warps of a block
constexpr int kStages = 2;                 // block tiles in a block's ring
constexpr size_t kBarBytes = kStages * 8;  // the ring's static mbarriers
constexpr size_t kSmemSoft = 48 * 1024 - kBarBytes;  // without opting in
constexpr size_t kSmemMax = 232448 - kBarBytes;      // a block's maximum
constexpr int kMaxDevices = 16;            // devices whose launch shapes
                                           // are remembered
constexpr int kMaxC = 226;                 // widest row: one warp's tiles of
                                           // two tables (and q) in kSmemMax
constexpr uint64_t kWaitNs = 10ull * 1000 * 1000 * 1000;  // 10 s

__host__ __device__ __forceinline__ int round4(int64_t x) {
  return static_cast<int>((x + 3) & ~int64_t{3});
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// dst[0..words) = src[0..words) by the block with 4-byte loads: the ragged
// last block tile, and every tile of rows whose address is not 16-byte
// aligned.
__device__ __forceinline__ void load_words(int32_t* dst,
                                           const int32_t* __restrict__ src,
                                           int words) {
  for (int k = threadIdx.x; k < words; k += blockDim.x) dst[k] = __ldg(src + k);
}

// Wait for the phase of parity `parity` of `bar`, or trap after kWaitNs:
// bytes that never all arrive end the launch with an error.
__device__ __forceinline__ void wait_slot(uint64_t* bar, uint32_t parity) {
  if (hopper::mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = hopper::global_ns();
  while (!hopper::mbar_try_wait(bar, parity))
    if (hopper::global_ns() - t0 > kWaitNs) __trap();
}

// row ≺ q for a row in shared memory and a query in shared memory or in
// registers; kC > 0 is the row width known when compiled, 0 reads c.
template <int kC>
__device__ __forceinline__ bool staged_before(const int32_t* row,
                                              const int32_t* q, int c) {
  const int w = kC > 0 ? kC : c;
  const int32_t e = row[0];
  const int32_t qe = q[0];
  bool le = true;
  bool eq = true;
#pragma unroll
  for (int j = 1; j < w; ++j) {
    le &= row[j] <= q[j];
    eq &= row[j] == q[j];
  }
  return e != kNoStamp && (e < qe || (e == qe && le && !eq));
}

// row's relation to q: bit 0 row ≺ q, bit 1 row concurrent with q (not
// NO_STAMP, same epoch, and every entry <= q's exactly when every entry
// is >= q's: incomparable or equal vectors).
template <int kC>
__device__ __forceinline__ uint32_t staged_relation(const int32_t* row,
                                                    const int32_t* q,
                                                    int c) {
  const int w = kC > 0 ? kC : c;
  const int32_t e = row[0];
  const int32_t qe = q[0];
  bool le = true;
  bool ge = true;
#pragma unroll
  for (int j = 1; j < w; ++j) {
    le &= row[j] <= q[j];
    ge &= row[j] >= q[j];
  }
  const bool same = e != kNoStamp && e == qe;
  const bool before = e != kNoStamp && (e < qe || (same && le && !ge));
  return (before ? 1u : 0u) | (same && le == ge ? 2u : 0u);
}

// A residue-mode row's flags (create row, delete row, q).
template <int kC>
__device__ __forceinline__ uint32_t residue_flags(const int32_t* create,
                                                  const int32_t* del,
                                                  const int32_t* q, int c) {
  const uint32_t cr = staged_relation<kC>(create, q, c);
  const uint32_t dr = staged_relation<kC>(del, q, c);
  return ((cr >> 1) * kCreateConc) | ((dr >> 1) * kDeleteConc) |
         ((cr & 1u) * kCreateBefore) | ((dr & 1u) * kDeleteBefore);
}

// The mode's predicate for one row: `row` is the first table's row,
// `row2` the second table's (pairs: its query; visibility: its delete
// row), q the shared query.
template <Mode kMode, int kC>
__device__ __forceinline__ bool hit(const int32_t* row, const int32_t* row2,
                                    const int32_t* q, int c) {
  if (kMode == Mode::kBefore) return staged_before<kC>(row, q, c);
  if (kMode == Mode::kPairs) return staged_before<kC>(row, row2, c);
  return staged_before<kC>(row, q, c) && !staged_before<kC>(row2, q, c);
}

// word[i] without indexing registers by a runtime value.
__device__ __forceinline__ uint32_t pick(const uint32_t (&word)[kPerLane],
                                         int i) {
  uint32_t w = word[0];
#pragma unroll
  for (int j = 1; j < kPerLane; ++j)
    if (i == j) w = word[j];
  return w;
}

// Tile t's ballot words (bit k of word j = row 32j + k of the tile) to the
// output; `rem` rows of the tile exist.
template <bool kBits>
__device__ __forceinline__ void store_tile(void* __restrict__ out, int64_t t,
                                           int rem,
                                           const uint32_t (&word)[kPerLane],
                                           int lane) {
  if (kBits) {
    uint32_t* o = static_cast<uint32_t*>(out) + t * kPerLane;
    const uint32_t w = pick(word, lane);
    if (lane < (rem + 31) / 32) o[lane] = w;
  } else {                      // lane L: rows 128h + 4L .. 128h + 4L + 3
#pragma unroll
    for (int h = 0; h < kTile / 128; ++h) {
      uint8_t* o = static_cast<uint8_t*>(out) + t * kTile + 128 * h;
      const int left = rem - 128 * h;
      const uint32_t x = pick(word, 4 * h + (lane >> 3)) >> ((lane & 7) * 4);
      const uint32_t b4 = (x & 1u) | ((x & 2u) << 7) | ((x & 4u) << 14) |
                          ((x & 8u) << 21);
      if (left >= 128) {
        reinterpret_cast<uint32_t*>(o)[lane] = b4;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (4 * lane + k < left) o[4 * lane + k] = (b4 >> (8 * k)) & 1u;
      }
    }
  }
}

// A warp's residue entries (rows first_row + lane + 32 j whose flag[j]
// is set) to the list: one atomicAdd on the count for the warp, none
// where no row of the warp's tile is concurrent.
__device__ __forceinline__ void emit_residue(
    unsigned long long* __restrict__ res, int64_t cap, int64_t first_row,
    const uint32_t (&flag)[kPerLane], int lane) {
  uint32_t mask[kPerLane];
  int total = 0;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    mask[j] = __ballot_sync(0xffffffffu, flag[j] != 0);
    total += __popc(mask[j]);
  }
  if (total == 0) return;               // warp-uniform
  unsigned long long base = 0;
  if (lane == 0) base = atomicAdd(res, static_cast<unsigned long long>(total));
  base = __shfl_sync(0xffffffffu, base, 0);
  const uint32_t below = (1u << lane) - 1u;
  unsigned long long off = base;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    if (flag[j]) {
      const unsigned long long pos = off + __popc(mask[j] & below);
      if (pos < static_cast<unsigned long long>(cap))
        res[1 + pos] = (static_cast<unsigned long long>(first_row + lane +
                                                        32 * j)
                        << kFlagBits) |
                       flag[j];
    }
    off += __popc(mask[j]);
  }
}

// The mode's predicate over n rows of `rows` (and of `other`: pairs' qs,
// visibility's and residue's delete rows; q is the shared (C,) query,
// unused by pairs), to bytes or bits (kBits); kC > 0 is the width C known
// when compiled, 0 reads c; residue mode also lists its concurrent rows
// in `res` (at most `cap` entries).  A block owns a block tile of
// warps * kTile rows at a time and keeps a ring of `stages` block tiles
// in shared memory, each slot with its own mbarrier: one thread starts
// the bulk copies of a later block tile while the block's warps evaluate
// the oldest, each warp its own kTile rows.
template <Mode kMode, bool kBits, int kC>
__device__ __forceinline__ void compare_tiles(
    const int32_t* __restrict__ rows, const int32_t* __restrict__ other,
    const int32_t* __restrict__ q, void* __restrict__ out, int64_t n,
    int c_arg, int stages, unsigned long long* __restrict__ res,
    int64_t cap) {
  constexpr int kTables = kMode == Mode::kBefore ? 1 : 2;
  constexpr bool kShared = kMode != Mode::kPairs;   // one query for all
  extern __shared__ __align__(16) int32_t smem[];
  __shared__ uint64_t bar[kStages];
  const int c = kC > 0 ? kC : c_arg;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int block_rows = warps * kTile;
  const int block_words = block_rows * c;
  const int slot_words = block_words * kTables;
  int32_t* ring = smem + (kShared ? round4(c) : 0);
  if (kShared)
    for (int k = threadIdx.x; k < c; k += blockDim.x) smem[k] = __ldg(q + k);
  if (threadIdx.x == 0)
    for (int s = 0; s < stages; ++s) hopper::mbar_init(bar + s, 1);
  hopper::mbar_init_fence();
  __syncthreads();
  int32_t q_reg[kC > 0 ? kC : 1];       // the shared query, kC > 0 only
  if (kC > 0 && kShared) {
#pragma unroll
    for (int j = 0; j < (kC > 0 ? kC : 1); ++j) q_reg[j] = smem[j];
  }
  const int32_t* qr = kC > 0 ? q_reg : smem;
  const bool vec = aligned16(rows) && (kTables == 1 || aligned16(other));
  const int64_t tiles = (n + block_rows - 1) / block_rows;
  const int64_t step = gridDim.x;
  auto rows_in = [&](int64_t t) {
    const int64_t left = n - t * block_rows;
    return left < block_rows ? static_cast<int>(left) : block_rows;
  };
  // Slot `slot` takes block tile t: its bulk copies when the tile is
  // whole and aligned, else a bare arrival (the block stages it itself
  // when it comes to it, as it does for tiles past the end, which it
  // never reaches).  Thread 0 only.
  auto issue = [&](int64_t t, int slot) {
    if (threadIdx.x != 0) return;
    if (t < tiles && vec && rows_in(t) == block_rows) {
      const uint32_t bytes = block_words * 4;
      int32_t* dst = ring + slot * slot_words;
      hopper::mbar_expect_tx(bar + slot, kTables * bytes);
      hopper::bulk_load(dst, rows + t * block_words, bytes, bar + slot);
      if (kTables == 2)
        hopper::bulk_load(dst + block_words, other + t * block_words, bytes,
                          bar + slot);
    } else {
      hopper::mbar_arrive(bar + slot);
    }
  };
  int64_t t = blockIdx.x;
  for (int s = 0; s < stages - 1; ++s) issue(t + s * step, s);
  uint32_t parity = 0;                  // bit s: the phase slot s waits for
  for (int slot = 0; t < tiles;
       t += step, slot = slot + 1 == stages ? 0 : slot + 1) {
    issue(t + (stages - 1) * step, slot == 0 ? stages - 1 : slot - 1);
    wait_slot(bar + slot, (parity >> slot) & 1u);
    parity ^= 1u << slot;
    const int rem_block = rows_in(t);
    int32_t* s_rows = ring + slot * slot_words;
    if (!(vec && rem_block == block_rows)) {
      load_words(s_rows, rows + t * block_words, rem_block * c);
      if (kTables == 2)
        load_words(s_rows + block_words, other + t * block_words,
                   rem_block * c);
      hopper::fence_proxy_async();      // before a bulk copy reuses the slot
      __syncthreads();
    }
    const int left = rem_block - warp * kTile;
    if (left > 0) {                     // this warp's kTile rows
      const int rem = left < kTile ? left : kTile;
      const int32_t* w_rows = s_rows + warp * kTile * c;
      uint32_t word[kPerLane];
      uint32_t flag[kPerLane];          // residue mode only
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const int r = lane + 32 * j;
        const int32_t* row = w_rows + r * c;
        bool p;
        if constexpr (kMode == Mode::kResidue) {
          const uint32_t f =
              r < rem ? residue_flags<kC>(row, row + block_words, qr, c) : 0u;
          p = (f & kCreateBefore) && !(f & kDeleteBefore);
          flag[j] = f & (kCreateConc | kDeleteConc) ? f : 0u;
        } else {
          p = r < rem && hit<kMode, kC>(row, row + block_words, qr, c);
        }
        word[j] = __ballot_sync(0xffffffffu, p);
      }
      store_tile<kBits>(out, t * warps + warp, rem, word, lane);
      if constexpr (kMode == Mode::kResidue)
        emit_residue(res, cap, (t * warps + warp) * int64_t{kTile}, flag,
                     lane);
    }
    __syncthreads();              // the slot is read before it is reused
  }
}

template <Mode kMode, bool kBits, int kC>
__global__ void __launch_bounds__(kThreads)
compare_kernel(const int32_t* __restrict__ rows,
               const int32_t* __restrict__ other,
               const int32_t* __restrict__ q, void* __restrict__ out,
               int64_t n, int c_arg, int stages) {
  compare_tiles<kMode, kBits, kC>(rows, other, q, out, n, c_arg, stages,
                                  nullptr, 0);
}

template <int kC>
__global__ void __launch_bounds__(kThreads)
visibility_residue_kernel(const int32_t* __restrict__ create,
                          const int32_t* __restrict__ del,
                          const int32_t* __restrict__ q,
                          uint32_t* __restrict__ out, int64_t n, int c_arg,
                          int stages, unsigned long long* __restrict__ res,
                          int64_t cap) {
  compare_tiles<Mode::kResidue, true, kC>(create, del, q, out, n, c_arg,
                                          stages, res, cap);
}

int sm_count(int dev) {
  static int cache[kMaxDevices] = {};
  int sms = dev >= 0 && dev < kMaxDevices ? cache[dev] : 0;
  if (sms == 0) {
    if (dev < 0 || cudaDeviceGetAttribute(
                       &sms, cudaDevAttrMultiProcessorCount, dev) !=
                       cudaSuccess || sms <= 0)
      sms = 132;
    if (dev >= 0 && dev < kMaxDevices) cache[dev] = sms;
  }
  return sms;
}

// Launch compare_kernel<kMode, kBits, kC> (residue mode:
// visibility_residue_kernel<kC>, the bit form): blocks of 8 warps with a
// ring of kStages block tiles (fewer warps, then one stage, for rows too
// wide to fit 227 KB of shared memory); as many blocks as are resident on
// the card at once, or fewer for small n.
template <Mode kMode, bool kBits, int kC>
int launch_compare(const int32_t* rows, const int32_t* other,
                   const int32_t* q, void* out, int64_t n, int c,
                   cudaStream_t stream, unsigned long long* res = nullptr,
                   int64_t res_cap = 0) {
  if (c < 1 || c > kMaxC) return static_cast<int>(cudaErrorInvalidValue);
  constexpr bool kResidue = kMode == Mode::kResidue;
  static_assert(!kResidue || kBits, "the residue mode writes bits");
  auto kernel = [] {
    if constexpr (kResidue) return visibility_residue_kernel<kC>;
    else return compare_kernel<kMode, kBits, kC>;
  }();
  const size_t warp_tile =
      size_t{kTile} * c * 4 * (kMode == Mode::kBefore ? 1 : 2);
  const size_t q_bytes =
      kMode == Mode::kPairs ? 0 : size_t{4} * round4(c);
  int warps = kMaxWarps;
  int stages = kStages;
  while (q_bytes + size_t{1} * stages * warps * warp_tile > kSmemMax) {
    if (warps > 1) warps /= 2;
    else if (stages > 1) --stages;
    else return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = q_bytes + size_t{1} * stages * warps * warp_tile;
  // blocks per SM, by device and C, found at the first launch on each
  static int cached[kMaxDevices][kMaxC + 1] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) dev = -1;
  int local = 0;
  int& resident = dev >= 0 && dev < kMaxDevices ? cached[dev][c] : local;
  if (resident == 0) {
    if (smem > kSmemSoft) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    int per_sm = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, warps * 32, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    resident = per_sm > 0 ? per_sm : 1;
  }
  const int64_t block_rows = int64_t{warps} * kTile;
  const int64_t want = (n + block_rows - 1) / block_rows;
  const int64_t cap = static_cast<int64_t>(sm_count(dev)) * resident;
  const unsigned int grid =
      static_cast<unsigned int>(want < cap ? want : cap);
  if constexpr (kResidue)
    kernel<<<grid, warps * 32, smem, stream>>>(
        rows, other, q, static_cast<uint32_t*>(out), n, c, stages, res,
        res_cap);
  else
    kernel<<<grid, warps * 32, smem, stream>>>(rows, other, q, out, n, c,
                                               stages);
  return static_cast<int>(cudaGetLastError());
}

// The kernel compiled for the row width c when it is a common one (1 to 8
// gatekeepers), else the one that reads c.
template <Mode kMode, bool kBits>
int launch_width(const int32_t* rows, const int32_t* other, const int32_t* q,
                 void* out, int64_t n, int c, cudaStream_t s,
                 unsigned long long* res = nullptr, int64_t res_cap = 0) {
  switch (c) {
#define MV_WIDTH(W)                                                        \
  case W:                                                                  \
    return launch_compare<kMode, kBits, W>(rows, other, q, out, n, c, s,  \
                                           res, res_cap);
    MV_WIDTH(2) MV_WIDTH(3) MV_WIDTH(4) MV_WIDTH(5)
    MV_WIDTH(6) MV_WIDTH(7) MV_WIDTH(8) MV_WIDTH(9)
#undef MV_WIDTH
    default: return launch_compare<kMode, kBits, 0>(rows, other, q, out, n,
                                                    c, s, res, res_cap);
  }
}

template <Mode kMode>
int launch_form(const int32_t* rows, const int32_t* other, const int32_t* q,
                void* out, int64_t n, int c, int bits, cudaStream_t s) {
  return bits ? launch_width<kMode, true>(rows, other, q, out, n, c, s)
              : launch_width<kMode, false>(rows, other, q, out, n, c, s);
}

int launch_mode(int mode, const int32_t* rows, const int32_t* other,
                const int32_t* q, void* out, int64_t n, int c, int bits,
                cudaStream_t s) {
  switch (static_cast<Mode>(mode)) {
    case Mode::kBefore:
      return launch_form<Mode::kBefore>(rows, other, q, out, n, c, bits, s);
    case Mode::kPairs:
      return launch_form<Mode::kPairs>(rows, other, q, out, n, c, bits, s);
    case Mode::kVisibility:
      return launch_form<Mode::kVisibility>(rows, other, q, out, n, c, bits,
                                            s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C interface (loaded with ctypes).  Each function launches on the
// given stream, does not synchronise, and returns the first CUDA error
// (cudaGetLastError() after the launch), so that a refused launch is
// reported to the caller.  n must be > 0; out is 4-byte aligned; bits
// selects the output form (0: one byte per row, 1: one uint32 per 32 rows).

extern "C" int mv_before(const int32_t* rows, const int32_t* q, void* out,
                         int64_t n, int32_t c, int32_t bits, void* stream) {
  return launch_mode(0, rows, nullptr, q, out, n, c, bits,
                     static_cast<cudaStream_t>(stream));
}

extern "C" int mv_before_pairs(const int32_t* rows, const int32_t* qs,
                               void* out, int64_t n, int32_t c, int32_t bits,
                               void* stream) {
  return launch_mode(1, rows, qs, nullptr, out, n, c, bits,
                     static_cast<cudaStream_t>(stream));
}

extern "C" int mv_visibility(const int32_t* create, const int32_t* del,
                             const int32_t* q, void* out, int64_t n,
                             int32_t c, int32_t bits, void* stream) {
  return launch_mode(2, create, del, q, out, n, c, bits,
                     static_cast<cudaStream_t>(stream));
}

// The residue mode on `stream`: zero the count at res[0], then one launch
// that writes the visibility bits (ceil(n / 32) uint32 words at out) and
// lists the concurrent rows in res (the module note; cap entries at
// most).
extern "C" int mv_visibility_residue(const int32_t* create, const int32_t* del,
                                     const int32_t* q, void* out,
                                     unsigned long long* res, int64_t cap,
                                     int64_t n, int32_t c, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cap < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaMemsetAsync(res, 0, sizeof(*res), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_width<Mode::kResidue, true>(create, del, q, out, n, c, s, res,
                                            cap);
}

// One host call's round trip on `stream`: copy in_bytes from pinned
// host_in to dev_in (none when in_bytes is 0: the caller copied the
// inputs itself), where the inputs lie at the given device pointers:
// rows, the second table `other` (pairs: qs; visibility: the delete
// rows; before: unused) and the shared query q (pairs: unused); run the
// bit-form compare of `mode` (0 before, 1 pairs, 2 visibility) into
// dev_bits, and copy its ceil(n / 32) words to pinned host_bits.  The
// caller waits on the stream before it reads host_bits.
extern "C" int mv_compare_host(const void* host_in, void* dev_in,
                               int64_t in_bytes, const int32_t* rows,
                               const int32_t* other, const int32_t* q,
                               uint32_t* dev_bits, uint32_t* host_bits,
                               int64_t n, int32_t c, int32_t mode,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (in_bytes > 0)
    err = cudaMemcpyAsync(dev_in, host_in, in_bytes, cudaMemcpyHostToDevice,
                          s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rc = launch_mode(mode, rows, other, q, dev_bits, n, c, 1, s);
  if (rc != 0) return rc;
  err = cudaMemcpyAsync(host_bits, dev_bits, ((n + 31) / 32) * 4,
                        cudaMemcpyDeviceToHost, s);
  return static_cast<int>(err);
}
