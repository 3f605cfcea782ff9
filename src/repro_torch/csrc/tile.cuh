// Shared pieces of the Huber-residual kernels: one 32 x 32 residual tile
// R = M - U V^T computed on the CUDA cores in full fp32.
//
// Every kernel in this directory is built from the same three steps:
//   1. stage a 32-row slice of U and of V (all r columns, zero-padded up to
//      a multiple of 32) in shared memory;
//   2. each of the 256 threads computes a 2 x 2 patch of U V^T with fp32 FMAs
//      over k = 0 .. r-1 in order, and reads its M (and W) entries from
//      device memory;
//   3. a kernel-specific epilogue (clip, Huber loss, soft threshold) and, for
//      the contractions, a second small product against the staged factor.
// Zero-padding is exact: a padded row of U or V gives U V^T = 0 and a padded
// entry of M reads as 0, so every padded residual, Psi and S is 0.
#pragma once

#include <cuda_runtime.h>

namespace repro {

constexpr int kTile = 32;      // rows and columns of one residual tile
constexpr int kThreads = 256;  // threads per block (8 warps)
constexpr int kMaxRank = 256;  // largest r the kernels take (RQ <= 8)

// Row stride (in floats) of a staged factor slice: r padded to 32 * RQ, plus
// one so that the 2 x 2 patches of neighbouring threads fall in different
// shared-memory banks.
template <int RQ>
__host__ __device__ constexpr int factor_ld() { return 32 * RQ + 1; }

// Dynamic shared memory of one contraction block: the Psi tile, then the
// staged U slice and the staged V slice.
template <int RQ>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) * (kTile * kTile + 2 * kTile * factor_ld<RQ>());
}

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

}  // namespace repro

// Return LAUNCH<RQ, MASKED>(...) for RQ = ceil(r / 32) in 1..8, masked iff
// the mask pointer w is not null; r and w must be in scope.
#define REPRO_RQ_DISPATCH(LAUNCH, ...)                                   \
  switch ((r + 31) / 32) {                                               \
    case 1: return w ? LAUNCH<1, true>(__VA_ARGS__) : LAUNCH<1, false>(__VA_ARGS__); \
    case 2: return w ? LAUNCH<2, true>(__VA_ARGS__) : LAUNCH<2, false>(__VA_ARGS__); \
    case 3: return w ? LAUNCH<3, true>(__VA_ARGS__) : LAUNCH<3, false>(__VA_ARGS__); \
    case 4: return w ? LAUNCH<4, true>(__VA_ARGS__) : LAUNCH<4, false>(__VA_ARGS__); \
    case 5: return w ? LAUNCH<5, true>(__VA_ARGS__) : LAUNCH<5, false>(__VA_ARGS__); \
    case 6: return w ? LAUNCH<6, true>(__VA_ARGS__) : LAUNCH<6, false>(__VA_ARGS__); \
    case 7: return w ? LAUNCH<7, true>(__VA_ARGS__) : LAUNCH<7, false>(__VA_ARGS__); \
    case 8: return w ? LAUNCH<8, true>(__VA_ARGS__) : LAUNCH<8, false>(__VA_ARGS__); \
    default: return static_cast<int>(cudaErrorInvalidValue);             \
  }
