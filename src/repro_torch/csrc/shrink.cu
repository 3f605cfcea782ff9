// Low-rank-residual soft threshold of DCF-PCA, batched over a leading client
// axis E, fp32 on the CUDA cores.
//
//   residual_shrink  S[e] = W[e] * sign(R) * max(|R| - lam[e], 0),
//                    R = M[e] - U[e] V[e]^T   (W = 1 without a mask)
//       replaces repro/kernels/shrinkage.py::_shrink_kernel (:41) and
//       _shrink_masked_kernel (:57).
//
// What bounds it on an H100: arithmetic.  Each output entry costs 2r FLOP of
// U V^T against 8 bytes (read M, write S; 12 with a mask), ~37 FLOP/byte at
// r = 150, right of the fp32 ridge (~20 FLOP/byte).  One block computes one
// 32 x 32 output tile from staged 32-row slices of U and V; the residual
// lives only in registers, and M and S each cross device memory once.  It
// runs once per solve (the finalize step), so it is kept simple.
#include "tile.cuh"

namespace repro {
namespace {

// Grid (n tiles, m tiles, E).
template <int RQ, bool MASKED>
__global__ void __launch_bounds__(kThreads)
shrink_kernel(const float* __restrict__ u, const float* __restrict__ v,
              const float* __restrict__ m, const float* __restrict__ w,
              const float* __restrict__ lam, float* __restrict__ s, int M,
              int N, int r) {
  constexpr int LD = factor_ld<RQ>();
  extern __shared__ float4 smem4[];
  float* Us = reinterpret_cast<float*>(smem4);
  float* Vs = Us + kTile * LD;

  const int e = blockIdx.z;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const size_t plane = static_cast<size_t>(e) * M * N;
  const float lam_e = lam[e];

  stage_rows<RQ>(Us, u + static_cast<size_t>(e) * M * r, i0, M, r);
  stage_rows<RQ>(Vs, v + static_cast<size_t>(e) * N * r, j0, N, r);
  __syncthreads();

  float low[2][2];
  low_rank_patch<RQ>(Us, Vs, r, low);
  const int ti = threadIdx.x / 16, tj = threadIdx.x % 16;
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int i = i0 + 2 * ti + a, j = j0 + 2 * tj + b;
      if (i >= M || j >= N) continue;
      const size_t at = plane + static_cast<size_t>(i) * N + j;
      const float res = m[at] - low[a][b];
      const float mag = fmaxf(fabsf(res) - lam_e, 0.f);
      float out = res > 0.f ? mag : (res < 0.f ? -mag : 0.f);
      if (MASKED) out = __fmul_rn(w[at], out);
      s[at] = out;
    }
}

template <int RQ, bool MASKED>
cudaError_t launch_shrink(const float* u, const float* v, const float* m,
                          const float* w, const float* lam, float* s, int E,
                          int M, int N, int r, cudaStream_t stream) {
  auto kernel = shrink_kernel<RQ, MASKED>;
  const size_t smem = sizeof(float) * 2 * kTile * factor_ld<RQ>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile, E);
  kernel<<<grid, kThreads, smem, stream>>>(u, v, m, w, lam, s, M, N, r);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// Returns cudaGetLastError() of the launch (0 on success).  w may be null.
extern "C" int repro_residual_shrink(const float* u, const float* v,
                                     const float* m, const float* w,
                                     const float* lam, float* s, int E, int M,
                                     int N, int r, void* stream) {
  REPRO_RQ_DISPATCH(repro::launch_shrink, u, v, m, w, lam, s, E, M, N, r,
                    static_cast<cudaStream_t>(stream))
}
