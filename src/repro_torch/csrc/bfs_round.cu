// One round of BFS relaxation for Hopper (sm_90a):
//
//   nxt[v] = min(cur[v], min over edges (u, v) of min(cur[u], INF - 1) + 1)
//   flags[parity] |= 1 where that lowers some cur[v]; flags[parity ^ 1] = 0
//
// INF = 2^31 - 1, so an unreached source gives INF and never overflows.
// The round of `core/analytics.bfs_levels`: one launch replaces the
// gather, clamp, add, fill, `scatter_reduce_` amin, `minimum` and
// changed-flag kernels of PyTorch's version (kernels/bfs_round/ref.py).
//
// Replaces no Pallas kernel: the JAX package runs this round as `jnp`
// gather and `jax.ops.segment_min` inside a `lax.while_loop`
// (src/repro/core/analytics.py, `bfs_levels`).  It was added because the
// round was the port's slowest path on whole-graph traversals: a
// `scatter_reduce_` amin with one atomic per edge, contended at hubs, and
// five more passes over E or N elements.
//
// Layout: edge arrays `src`, `dst` (E, int32), any order; the CSC order
// (sorted by dst) only makes runs long.  Levels lie in [0, INF].  `cur`
// and `nxt` (N, int32) are two distinct buffers that ping-pong between
// rounds, each with a one-byte mirror (`cur8`, `nxt8`: the level where
// it is below 254, 255 for INF, 254 for "read the int32").  The caller
// keeps nxt >= cur everywhere, nxt == cur at every vertex with no
// in-edge, and each mirror equal to its buffer (true of buffers that
// `bfs_start` fills alike and that are each written by every other
// round), so a round never copies cur into nxt.  Integer min does not
// depend on order: the result is the plain round's, bit for bit.
//
// Bound: bytes.  The round must stream 8 bytes an edge (src, dst) and
// gather the level of each edge's source (E random reads); it does a
// handful of integer operations an edge.  At `urand_s22` (134M edges,
// N 4.2M) the streams are 1.07 GB (0.32 ms at 3.35 TB/s) and the int32
// levels 16.8 MB, inside the 50 MB L2; at `g500_s24` (537M, 16.8M) the
// streams are 4.29 GB (1.28 ms) and the int32 levels 67 MB, beyond L2.
// Measured on an H100, the streams alone run at ~83 % of the bytes bound;
// each random gather moves a 32-byte sector from L2, and those sectors,
// not the bytes, set the round's time.  The design:
//
// - Gathers read the byte mirror: 4.2 MB and 16.8 MB, inside L2 at both
//   sizes, so at g500_s24 the gathers stop going to device memory (the
//   int32 gather took the round 6.2 ms there, the byte gather 4.4).
// - Tiles: a block takes 2,048 consecutive edges, a thread 8 of them,
//   contiguous, as two 16-byte loads of each array (scalar loads on the
//   ragged end, or where the wrapper finds the arrays unaligned), loaded
//   evict-first (`ld.global.cs`) so that they do not push the mirror out
//   of L2; a thread starts its 8 gathers before it uses any.
// - Segmented min, no per-edge atomics: a thread folds its 8 candidates
//   into runs of equal dst; a run wholly inside the thread is finished
//   there.  Each thread's last run is scanned across the warp (5 shuffle
//   steps that merge only equal keys) and joined to the next thread's
//   first run, so a run that spans threads is finished once per warp.
//   Merging equal keys that are not adjacent (unsorted input) only adds
//   candidates of the same vertex: still its min.
// - Finishing a run (vertex d, min m) reads cur[d] and nxt[d] (L2) and
//   makes one `atomicMin(&nxt[d], min(m, cur[d]))` only where that
//   lowers nxt[d]: one atomic per run and warp tile at most, so a hub of
//   millions of in-edges costs thousands a round (none once settled).
//   Where the atomic lowers nxt[d], a compare-and-swap on the word that
//   holds nxt8[d] lowers that byte too (the byte code is monotone in the
//   level, so the byte min is the code of the level min).
// - Flag: a block ORs its threads' "lowered" and "bad index" predicates
//   (`__syncthreads_or`) and sets bit 1 / bit 2 of flags[parity] once,
//   only if not set yet; block 0 zeroes flags[parity ^ 1] for the next
//   round.  An index outside [0, N) is skipped and reported by bit 2.
// - 64-bit edge offsets: each of g500_s24's arrays is 2.15 GB.
//
// Masked round (`masked_relax_kernel`, the rounds of a BFS at a refinable
// timestamp over a table of edge versions, `core/analytics.bfs_levels_at`):
// the same round over the edges whose bit is set in a visibility bit
// stream (one uint32 word per 32 edges, bit k = edge k, least significant
// first: the `mv_visibility` kernel's bit form).  A thread's 8 edges are
// one byte of the stream (its tile offset is a multiple of 8), loaded
// beside its edges; an invisible edge is dropped as an edge past the end
// is (no gather, no candidate) and is not checked for range: a purged
// version's ends are never read as a vertex.  The unmasked round is a
// separate instantiation of the same body, so its code is unchanged.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 8;                         // edges a thread
constexpr int kTile = kThreads * kPer;          // edges a block
constexpr int kInf = INT_MAX;
constexpr int kNoKey = -1;                      // an edge that is not there
constexpr unsigned kWide = 254;                 // byte: read the int32
constexpr unsigned kUnreached = 255;            // byte: INF
constexpr int kLowered = 1;                     // flag bits
constexpr int kBadIndex = 2;

__device__ __forceinline__ unsigned code(int level) {
  return level == kInf ? kUnreached
                       : (level < static_cast<int>(kWide)
                              ? static_cast<unsigned>(level) : kWide);
}

__device__ __forceinline__ int level_of(const int* __restrict__ lv,
                                        const unsigned char* __restrict__ lv8,
                                        int v) {
  const unsigned b = __ldg(lv8 + v);
  return b < kWide ? static_cast<int>(b) : (b == kUnreached ? kInf
                                                            : __ldg(lv + v));
}

// nxt8[d] = min(nxt8[d], b), on the 4-byte word that holds it
__device__ __forceinline__ void byte_min(unsigned char* nxt8, int d,
                                         unsigned b) {
  unsigned* word = reinterpret_cast<unsigned*>(nxt8 + (d & ~3));
  const int shift = (d & 3) * 8;
  unsigned old = __ldcg(word);
  while (((old >> shift) & 0xffu) > b) {
    const unsigned seen =
        atomicCAS(word, old, (old & ~(0xffu << shift)) | (b << shift));
    if (seen == old) break;
    old = seen;
  }
}

// Finish the run of vertex d whose candidates' min is m; true where it
// lowers cur[d].
__device__ __forceinline__ bool finish(int d, int m,
                                       const int* __restrict__ cur,
                                       int* __restrict__ nxt,
                                       unsigned char* __restrict__ nxt8) {
  if (d == kNoKey) return false;
  const int c = __ldg(cur + d);
  const int t = min(m, c);
  if (t < __ldcg(nxt + d) && atomicMin(nxt + d, t) > t)
    byte_min(nxt8, d, code(t));
  return m < c;
}

// One round over a block tile (the module note); kMasked reads the
// visibility bits `visible` (the bit stream's bytes) and skips the edges
// whose bit is clear.
template <bool kVec, bool kMasked>
__device__ __forceinline__ void relax_tile(
    const int* __restrict__ src, const int* __restrict__ dst,
    const unsigned char* __restrict__ visible, const int* __restrict__ cur,
    int* __restrict__ nxt, const unsigned char* __restrict__ cur8,
    unsigned char* __restrict__ nxt8, int* __restrict__ flags,
    int64_t n_edges, int n, int parity) {
  const int lane = threadIdx.x & 31;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile +
                       static_cast<int64_t>(threadIdx.x) * kPer;
  int s[kPer], key[kPer];
  const bool whole = base + kPer <= n_edges;
  unsigned live = 0xffu;                        // bit i: edge base + i
  if (kMasked) live = base < n_edges ? __ldcs(visible + (base >> 3)) : 0u;
  if (kVec && whole) {
    const int4* s4 = reinterpret_cast<const int4*>(src + base);
    const int4* d4 = reinterpret_cast<const int4*>(dst + base);
    const int4 s0 = __ldcs(s4), s1 = __ldcs(s4 + 1);
    const int4 d0 = __ldcs(d4), d1 = __ldcs(d4 + 1);
    s[0] = s0.x; s[1] = s0.y; s[2] = s0.z; s[3] = s0.w;
    s[4] = s1.x; s[5] = s1.y; s[6] = s1.z; s[7] = s1.w;
    key[0] = d0.x; key[1] = d0.y; key[2] = d0.z; key[3] = d0.w;
    key[4] = d1.x; key[5] = d1.y; key[6] = d1.z; key[7] = d1.w;
  } else {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const bool in = base + i < n_edges;
      s[i] = in ? __ldcs(src + base + i) : 0;
      key[i] = in ? __ldcs(dst + base + i) : kNoKey;
    }
  }
  bool bad = false;
  int got[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const bool seen = !kMasked || ((live >> i) & 1u);
    const bool ok = static_cast<unsigned>(s[i]) < static_cast<unsigned>(n) &&
                    static_cast<unsigned>(key[i]) < static_cast<unsigned>(n);
    bad |= seen && (whole || base + i < n_edges) && !ok;
    if (!ok || !seen) key[i] = kNoKey;
    got[i] = ok && seen ? level_of(cur, cur8, s[i]) : kInf;
  }
  // runs of equal dst in this thread's edges: the first (head), the
  // last (tail), and those between, finished here
  bool lowered = false, single = true;
  int hk = key[0], hv = min(got[0], kInf - 1) + 1;
  int tk = hk, tv = hv;
#pragma unroll
  for (int i = 1; i < kPer; ++i) {
    const int v = min(got[i], kInf - 1) + 1;
    if (key[i] == tk) {
      tv = min(tv, v);
    } else {
      if (single) {
        hk = tk;
        hv = tv;
        single = false;
      } else {
        lowered |= finish(tk, tv, cur, nxt, nxt8);
      }
      tk = key[i];
      tv = v;
    }
  }
  // the tails, scanned across the warp over equal keys; a lane's scanned
  // tail is finished by the next lane's head when they share the key
  int sv = tv;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int ok = __shfl_up_sync(0xffffffffu, tk, off);
    const int ov = __shfl_up_sync(0xffffffffu, sv, off);
    if (lane >= off && ok == tk) sv = min(sv, ov);
  }
  const int pk = __shfl_up_sync(0xffffffffu, tk, 1);
  const int pv = __shfl_up_sync(0xffffffffu, sv, 1);
  const int nk = __shfl_down_sync(0xffffffffu, hk, 1);
  if (!single)
    lowered |= finish(hk, lane > 0 && pk == hk ? min(hv, pv) : hv, cur, nxt,
                      nxt8);
  if (lane == 31 || nk != tk) lowered |= finish(tk, sv, cur, nxt, nxt8);

  const int bits = (__syncthreads_or(lowered) ? kLowered : 0) |
                   (__syncthreads_or(bad) ? kBadIndex : 0);
  if (threadIdx.x == 0) {
    if (bits && (__ldcg(flags + parity) & bits) != bits)
      atomicOr(flags + parity, bits);
    if (blockIdx.x == 0) flags[parity ^ 1] = 0;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
relax_kernel(const int* __restrict__ src, const int* __restrict__ dst,
             const int* __restrict__ cur, int* __restrict__ nxt,
             const unsigned char* __restrict__ cur8,
             unsigned char* __restrict__ nxt8, int* __restrict__ flags,
             int64_t n_edges, int n, int parity) {
  relax_tile<kVec, false>(src, dst, nullptr, cur, nxt, cur8, nxt8, flags,
                          n_edges, n, parity);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
masked_relax_kernel(const int* __restrict__ src, const int* __restrict__ dst,
                    const unsigned char* __restrict__ visible,
                    const int* __restrict__ cur, int* __restrict__ nxt,
                    const unsigned char* __restrict__ cur8,
                    unsigned char* __restrict__ nxt8, int* __restrict__ flags,
                    int64_t n_edges, int n, int parity) {
  relax_tile<kVec, true>(src, dst, visible, cur, nxt, cur8, nxt8, flags,
                         n_edges, n, parity);
}

// Both level buffers INF, both mirrors 255, both flags 0.
__global__ void __launch_bounds__(kThreads)
fill_kernel(int* __restrict__ lv0, int* __restrict__ lv1,
            unsigned char* __restrict__ m0, unsigned char* __restrict__ m1,
            int* __restrict__ flags, int n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       v < n; v += stride) {
    lv0[v] = kInf;
    lv1[v] = kInf;
    m0[v] = kUnreached;
    m1[v] = kUnreached;
  }
  if (blockIdx.x == 0 && threadIdx.x < 2) flags[threadIdx.x] = 0;
}

// Level 0 at each source, in both buffers and both mirrors; a source
// outside [-N, N) sets bit 2 of flags[0], which the first round reports.
__global__ void __launch_bounds__(kThreads)
seed_kernel(int* __restrict__ lv0, int* __restrict__ lv1,
            unsigned char* __restrict__ m0, unsigned char* __restrict__ m1,
            int* __restrict__ flags, const int64_t* __restrict__ sources,
            int64_t n_sources, int n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_sources) return;
  int64_t v = sources[i];
  if (v < 0) v += n;                            // as PyTorch indexes
  if (v < 0 || v >= n) {
    atomicOr(flags, kBadIndex);
    return;
  }
  lv0[v] = 0;
  lv1[v] = 0;
  m0[v] = 0;
  m1[v] = 0;
}

}  // namespace

// One round on `stream`: cur, nxt (n) and flags (2) int32 device
// pointers, cur8 and nxt8 (n bytes, 4-byte aligned, allocated to a
// multiple of 4: a byte is lowered on its whole word); src and dst
// (n_edges) int32; vec != 0 when src and dst are 16-byte aligned.
// Returns the launch's CUDA error code.
extern "C" int bfs_round(const void* src, const void* dst, const void* cur,
                         void* nxt, const void* cur8, void* nxt8,
                         void* flags, int64_t n_edges, int32_t n,
                         int32_t parity, int32_t vec, void* stream) {
  if (n_edges < 0 || n < 0 || (parity & ~1))
    return static_cast<int>(cudaErrorInvalidValue);
  int64_t tiles = (n_edges + kTile - 1) / kTile;
  if (tiles < 1) tiles = 1;                     // still zeroes the flag
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* s = static_cast<const int*>(src);
  const auto* d = static_cast<const int*>(dst);
  const auto* c = static_cast<const int*>(cur);
  auto* x = static_cast<int*>(nxt);
  const auto* c8 = static_cast<const unsigned char*>(cur8);
  auto* x8 = static_cast<unsigned char*>(nxt8);
  auto* f = static_cast<int*>(flags);
  const dim3 grid(static_cast<unsigned>(tiles));
  if (vec)
    relax_kernel<true><<<grid, kThreads, 0, st>>>(s, d, c, x, c8, x8, f,
                                                  n_edges, n, parity);
  else
    relax_kernel<false><<<grid, kThreads, 0, st>>>(s, d, c, x, c8, x8, f,
                                                   n_edges, n, parity);
  return static_cast<int>(cudaGetLastError());
}

// One masked round on `stream`: bfs_round's arguments and `visible`, the
// edges' visibility bits (ceil(n_edges / 32) uint32 words, 4-byte
// aligned); an edge whose bit is clear is skipped.
extern "C" int bfs_round_masked(const void* src, const void* dst,
                                const void* visible, const void* cur,
                                void* nxt, const void* cur8, void* nxt8,
                                void* flags, int64_t n_edges, int32_t n,
                                int32_t parity, int32_t vec, void* stream) {
  if (n_edges < 0 || n < 0 || (parity & ~1))
    return static_cast<int>(cudaErrorInvalidValue);
  int64_t tiles = (n_edges + kTile - 1) / kTile;
  if (tiles < 1) tiles = 1;                     // still zeroes the flag
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* s = static_cast<const int*>(src);
  const auto* d = static_cast<const int*>(dst);
  const auto* v = static_cast<const unsigned char*>(visible);
  const auto* c = static_cast<const int*>(cur);
  auto* x = static_cast<int*>(nxt);
  const auto* c8 = static_cast<const unsigned char*>(cur8);
  auto* x8 = static_cast<unsigned char*>(nxt8);
  auto* f = static_cast<int*>(flags);
  const dim3 grid(static_cast<unsigned>(tiles));
  if (vec)
    masked_relax_kernel<true><<<grid, kThreads, 0, st>>>(
        s, d, v, c, x, c8, x8, f, n_edges, n, parity);
  else
    masked_relax_kernel<false><<<grid, kThreads, 0, st>>>(
        s, d, v, c, x, c8, x8, f, n_edges, n, parity);
  return static_cast<int>(cudaGetLastError());
}

// The state before the first round on `stream`: both level buffers (n
// int32) INF and both mirrors (n bytes, allocated to a multiple of 4) 255,
// then 0 at each of the n_sources int64 `sources` (a negative one counts
// from n; one outside sets bit 2 of flags[0]); both flags 0 first.  Two
// launches; returns the CUDA error code.
extern "C" int bfs_start(void* lv0, void* lv1, void* m0, void* m1,
                         void* flags, const void* sources, int64_t n_sources,
                         int32_t n, void* stream) {
  if (n < 0 || n_sources < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* a = static_cast<int*>(lv0);
  auto* b = static_cast<int*>(lv1);
  auto* a8 = static_cast<unsigned char*>(m0);
  auto* b8 = static_cast<unsigned char*>(m1);
  int64_t fill_blocks = (static_cast<int64_t>(n) + kThreads - 1) / kThreads;
  if (fill_blocks < 1) fill_blocks = 1;         // still zeroes the flags
  if (fill_blocks > 8192) fill_blocks = 8192;   // the rest by grid stride
  fill_kernel<<<static_cast<unsigned>(fill_blocks), kThreads, 0, st>>>(
      a, b, a8, b8, static_cast<int*>(flags), n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_sources == 0) return static_cast<int>(err);
  const int64_t seed_blocks = (n_sources + kThreads - 1) / kThreads;
  if (seed_blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  seed_kernel<<<static_cast<unsigned>(seed_blocks), kThreads, 0, st>>>(
      a, b, a8, b8, static_cast<int*>(flags),
      static_cast<const int64_t*>(sources), n_sources, n);
  return static_cast<int>(cudaGetLastError());
}
