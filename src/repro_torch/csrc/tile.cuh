// Shared pieces of the Huber-residual kernels: how M and W are read, the
// mask modes and the dispatch from runtime codes to template instances,
// for every kernel in this directory (their residual tiles: tile64.cuh).
//
// The data plane M is fp32 or bf16 (upcast on load with __bfloat162float;
// everything after the load is fp32).  The mask W is absent, a dense fp32
// 0/1 plane shaped like M, or bit-packed: uint8 (m, ceil(n/8)), column j of
// row i in bit j % 8 of byte j / 8, the tail byte's high bits zero.  A packed
// bit unpacks to exactly the 0.0f / 1.0f a dense plane holds, and the mask
// multiply is __fmul_rn (never contracted into an FMA), so a packed mask
// gives the bits of the dense mask it packs and an all-ones mask the bits of
// no mask.  Both choices are template parameters, picked at the C entry by
// dispatch() from the codes the wrapper passes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace repro {

// Codes of the data type of M and of the mask mode, as the C entries take
// them (kernels/_launch.py passes the same numbers).
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };
enum MaskMode : int { kNoMask = 0, kDenseMask = 1, kPackedMask = 2 };

// Bytes per row of a packed mask with n columns.
__host__ __device__ constexpr int packed_width(int n) { return (n + 7) / 8; }

// fmaxf / fminf return the other operand for a NaN, so a NaN residual
// would clip to -lam where the plain versions (torch.clamp) and the
// reference (jnp.clip) give NaN.  max.NaN / min.NaN (sm_80 on) propagate
// it at the same cost and equal fmaxf / fminf on every other input.
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float clip(float x, float lam) {
  return min_nan(max_nan(x, -lam), lam);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// One client's (m, n) data plane and its mask.
template <typename TM, int MASK>
struct ClientPlanes {
  const TM* m;
  const void* w;
  int rows, cols;

  __device__ ClientPlanes(const TM* m_all, const void* w_all, int e, int M,
                          int N)
      : m(m_all + static_cast<size_t>(e) * M * N), w(nullptr), rows(M),
        cols(N) {
    if (MASK == kDenseMask)
      w = static_cast<const float*>(w_all) + static_cast<size_t>(e) * M * N;
    if (MASK == kPackedMask)
      w = static_cast<const uint8_t*>(w_all) +
          static_cast<size_t>(e) * M * packed_width(N);
  }

  // x = M[i, j] upcast to fp32 and wt = W[i, j] (1 without a mask); both 0
  // outside the plane.
  __device__ __forceinline__ void load(int i, int j, float& x,
                                       float& wt) const {
    x = 0.f;
    wt = 0.f;
    if (i >= rows || j >= cols) return;
    const size_t at = static_cast<size_t>(i) * cols + j;
    x = to_float(m[at]);
    if (MASK == kNoMask) wt = 1.f;
    if (MASK == kDenseMask) wt = static_cast<const float*>(w)[at];
    if (MASK == kPackedMask) {
      const uint8_t byte = static_cast<const uint8_t*>(
          w)[static_cast<size_t>(i) * packed_width(cols) + (j >> 3)];
      wt = ((byte >> (j & 7)) & 1) ? 1.f : 0.f;
    }
  }
};

// W * x, exactly (no FMA contraction); x itself without a mask.
template <int MASK>
__device__ __forceinline__ float apply_mask(float wt, float x) {
  return MASK == kNoMask ? x : __fmul_rn(wt, x);
}

// ---------------------------------------------------------------------------
// Host-side dispatch from the runtime codes to the template instantiations.
// ---------------------------------------------------------------------------
template <typename T>
struct TypeTag {
  using type = T;
};
template <int V>
using Int = std::integral_constant<int, V>;

// RQ = ceil(r / 32) = 1 .. 8 covers r <= 256 in one register block of 32 RQ
// ranks; RQ = kChunked stands for every r > 256, which each kernel takes
// its own way (contract_v.cu and stripe.cuh in chunks of 256 above 2048,
// dispatching their cluster kernels by the rank slice's width instead;
// shrink.cu does not dispatch by rank there).
constexpr int kChunked = 0;

template <typename F>
cudaError_t by_rank(int r, F&& f) {
  if (r < 1) return cudaErrorInvalidValue;
  switch ((r + 31) / 32) {
    case 1: return f(Int<1>{});
    case 2: return f(Int<2>{});
    case 3: return f(Int<3>{});
    case 4: return f(Int<4>{});
    case 5: return f(Int<5>{});
    case 6: return f(Int<6>{});
    case 7: return f(Int<7>{});
    case 8: return f(Int<8>{});
    default: return f(Int<kChunked>{});
  }
}

template <typename F>
cudaError_t by_dtype(int dtype, F&& f) {
  switch (dtype) {
    case kFloat32: return f(TypeTag<float>{});
    case kBFloat16: return f(TypeTag<__nv_bfloat16>{});
    default: return cudaErrorInvalidValue;
  }
}

template <typename F>
cudaError_t by_mask(int mask, F&& f) {
  switch (mask) {
    case kNoMask: return f(Int<kNoMask>{});
    case kDenseMask: return f(Int<kDenseMask>{});
    case kPackedMask: return f(Int<kPackedMask>{});
    default: return cudaErrorInvalidValue;
  }
}

// f(TypeTag<TM>, Int<MASK>) for the type of M and the mask mode; returns
// f's cudaError_t as an int (cudaErrorInvalidValue for a code no
// instantiation covers).
template <typename F>
int dispatch_planes(int dtype, int mask, F&& f) {
  return static_cast<int>(by_dtype(dtype, [&](auto tm) {
    return by_mask(mask, [&](auto mk) { return f(tm, mk); });
  }));
}

// f(Int<RQ>, TypeTag<TM>, Int<MASK>) for by_rank's RQ, the type of M and
// the mask mode; returns f's cudaError_t as an int (cudaErrorInvalidValue
// for a code or rank no instantiation covers).
template <typename F>
int dispatch(int r, int dtype, int mask, F&& f) {
  return dispatch_planes(dtype, mask, [&](auto tm, auto mk) {
    return by_rank(r, [&](auto rq) { return f(rq, tm, mk); });
  });
}

}  // namespace repro
