// Shared pieces of the Huber-residual kernels: how M and W are read, the
// mask modes and the dispatch from runtime codes to template instances,
// for every kernel in this directory; and the 32 x 32 residual tile
// R = M - U V^T of the shrink (shrink.cu), computed on the CUDA cores in
// full fp32 (the contractions take 64 x 64 tiles: tile64.cuh).
//
// The shrink's tile is built in three steps:
//   1. stage a 32-row slice of U and of V (all r columns, zero-padded up to
//      a multiple of 32) in shared memory;
//   2. each of the 256 threads computes a 2 x 2 patch of U V^T with fp32 FMAs
//      over k = 0 .. r-1 in order, and reads its M (and W) entries from
//      device memory;
//   3. the epilogue (soft threshold, and Psi in the psi mode).
// Zero-padding is exact: a padded row of U or V gives U V^T = 0 and a padded
// entry of M reads as 0, so every padded residual, Psi and S is 0.
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

constexpr int kTile = 32;      // rows and columns of one residual tile
constexpr int kThreads = 256;  // threads per block (8 warps)

// Codes of the data type of M and of the mask mode, as the C entries take
// them (kernels/_launch.py passes the same numbers).
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };
enum MaskMode : int { kNoMask = 0, kDenseMask = 1, kPackedMask = 2 };

// Bytes per row of a packed mask with n columns.
__host__ __device__ constexpr int packed_width(int n) { return (n + 7) / 8; }

// Row stride (in floats) of a staged factor slice: r padded to 32 * RQ, plus
// one so that the 2 x 2 patches of neighbouring threads fall in different
// shared-memory banks.
template <int RQ>
__host__ __device__ constexpr int factor_ld() { return 32 * RQ + 1; }

// Stage rows [row0, row0 + 32) of a (nrows, r) row-major factor into dst
// (32 x factor_ld<RQ>()), writing zeros past nrows and past r.
template <int RQ>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int row0, int nrows, int r) {
  constexpr int RP = 32 * RQ;
  constexpr int LD = factor_ld<RQ>();
  for (int idx = threadIdx.x; idx < kTile * RP; idx += kThreads) {
    const int ii = idx / RP;
    const int k = idx - ii * RP;
    const int row = row0 + ii;
    dst[ii * LD + k] =
        (row < nrows && k < r) ? src[static_cast<size_t>(row) * r + k] : 0.f;
  }
}

// This thread's 2 x 2 patch of Us Vs^T: rows 2*(t/16) + {0,1} of the U slice
// against rows 2*(t%16) + {0,1} of the V slice, summed over k in order.
template <int RQ>
__device__ __forceinline__ void low_rank_patch(const float* Us, const float* Vs,
                                               int r, float low[2][2]) {
  constexpr int LD = factor_ld<RQ>();
  const int ti = threadIdx.x / 16;
  const int tj = threadIdx.x % 16;
  const float* ua = Us + (2 * ti) * LD;
  const float* ub = ua + LD;
  const float* va = Vs + (2 * tj) * LD;
  const float* vb = va + LD;
  float l00 = 0.f, l01 = 0.f, l10 = 0.f, l11 = 0.f;
  for (int k = 0; k < r; ++k) {
    const float a0 = ua[k], a1 = ub[k], b0 = va[k], b1 = vb[k];
    l00 = fmaf(a0, b0, l00);
    l01 = fmaf(a0, b1, l01);
    l10 = fmaf(a1, b0, l10);
    l11 = fmaf(a1, b1, l11);
  }
  low[0][0] = l00;
  low[0][1] = l01;
  low[1][0] = l10;
  low[1][1] = l11;
}

__device__ __forceinline__ float clip(float x, float lam) {
  return fminf(fmaxf(x, -lam), lam);
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

// RQ = 1 .. 8 covers r <= 256 (MAX_RANK in kernels/_launch.py).
template <typename F>
cudaError_t by_rank(int r, F&& f) {
  switch ((r + 31) / 32) {
    case 1: return f(Int<1>{});
    case 2: return f(Int<2>{});
    case 3: return f(Int<3>{});
    case 4: return f(Int<4>{});
    case 5: return f(Int<5>{});
    case 6: return f(Int<6>{});
    case 7: return f(Int<7>{});
    case 8: return f(Int<8>{});
    default: return cudaErrorInvalidValue;
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

// kPacked: whether this kernel takes packed masks at all (the shrink does
// not; its dispatch unpacks first).
template <bool kPacked, typename F>
cudaError_t by_mask(int mask, F&& f) {
  if (mask == kNoMask) return f(Int<kNoMask>{});
  if (mask == kDenseMask) return f(Int<kDenseMask>{});
  if constexpr (kPacked) {
    if (mask == kPackedMask) return f(Int<kPackedMask>{});
  }
  return cudaErrorInvalidValue;
}

// f(Int<RQ>, TypeTag<TM>, Int<MASK>) for RQ = ceil(r / 32), the type of M
// and the mask mode; returns f's cudaError_t as an int (cudaErrorInvalidValue
// for a code or rank no instantiation covers).
template <bool kPacked = true, typename F>
int dispatch(int r, int dtype, int mask, F&& f) {
  return static_cast<int>(by_dtype(dtype, [&](auto tm) {
    return by_mask<kPacked>(mask, [&](auto mk) {
      return by_rank(r, [&](auto rq) { return f(rq, tm, mk); });
    });
  }));
}

}  // namespace repro
