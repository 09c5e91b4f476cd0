// Vector loads and stores of table rows, shared by the gather kernels
// (embedding_bag.cu, segment_mp.cu).
//
// A lane owns K consecutive elements of a row.  `Cols<T, K>` loads them
// with as few instructions as their bytes allow (one of 2, 4, 8 or 16
// bytes, or several 16-byte pieces when K * sizeof(T) > 16) and keeps
// them raw in registers, so that a warp can issue several rows' loads
// before it converts any of them.  The caller guarantees alignment: the
// row's base pointer and the lane's offset are multiples of the load.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace vec {

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

template <int B> struct Raw;                  // B bytes as one access
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<2> { using type = unsigned short; };

template <typename T, int K>
struct Cols {
  static constexpr int kBytes = K * static_cast<int>(sizeof(T));
  static constexpr int kPiece = kBytes < 16 ? kBytes : 16;
  static constexpr int kN = kBytes / kPiece;
  using R = typename Raw<kPiece>::type;
  R raw[kN];

  __device__ __forceinline__ void load(const T* __restrict__ p) {
    const R* q = reinterpret_cast<const R*>(p);
#pragma unroll
    for (int i = 0; i < kN; ++i) raw[i] = __ldg(q + i);
  }
  __device__ __forceinline__ float get(int i) const {
    return to_f32(reinterpret_cast<const T*>(raw)[i]);
  }
};

// p[0..K) = f rounded to T, in pieces of at most 16 bytes.
template <typename T, int K>
__device__ __forceinline__ void store_cols(T* __restrict__ p,
                                           const float (&f)[K]) {
  Cols<T, K> c;
  T* e = reinterpret_cast<T*>(c.raw);
#pragma unroll
  for (int i = 0; i < K; ++i) e[i] = from_f32<T>(f[i]);
  typename Cols<T, K>::R* q = reinterpret_cast<typename Cols<T, K>::R*>(p);
#pragma unroll
  for (int i = 0; i < Cols<T, K>::kN; ++i) q[i] = c.raw[i];
}

// Lanes [base, base + g) of the warp, g a power of two <= 32, base the
// lane rounded down to a multiple of g.
__device__ __forceinline__ unsigned group_mask(int lane, int g) {
  return g == 32 ? 0xffffffffu
                 : ((1u << g) - 1u) << (lane & ~(g - 1));
}

}  // namespace vec
