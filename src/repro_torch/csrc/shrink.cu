// Low-rank-residual soft threshold of DCF-PCA, batched over a leading client
// axis E, fp32 on the CUDA cores.
//
//   residual_shrink  S[e] = W[e] * sign(R) * max(|R| - lam[e], 0),
//                    R = M[e] - U[e] V[e]^T   (W = 1 without a mask)
//       replaces repro/kernels/shrinkage.py::_shrink_kernel (:41) and
//       _shrink_masked_kernel (:57).
//   residual_shrink_psi  the same S and, from the same residual in
//                    registers, Psi[e] = W[e] * R - S[e] (R - S unmasked)
//       replaces _shrink_psi_kernel (:48) and _shrink_psi_masked_kernel
//       (:66), with the reference's formulas (not clip(R), which equals
//       them only up to rounding).  WITH_PSI is a template flag on the one
//       tile, so S is the shrink's S bit for bit.
//
// M is fp32 or bf16 (upcast on load); W is absent or a dense fp32 plane: a
// packed mask is unpacked once by the dispatch (kernels/ops.py), as the
// reference does, since this runs once per solve.
//
// What bounds it on an H100: it depends on r.  Each output entry costs 2r
// FLOP of U V^T against 8-12 bytes (read M, write S, read W; 6-10 with bf16
// M): ~37 FLOP/byte at r = 150, right of the fp32 ridge (~20 FLOP/byte), but
// ~11-16 at r = 64, left of it, where the bytes bound it (with Psi, 4 more
// bytes an entry: ~27 FLOP/byte at r = 150).  One block computes one 32 x 32
// output tile from staged 32-row slices of U and V; the residual lives only
// in registers, and M, S (and Psi) each cross device memory once.
#include "tile.cuh"

namespace repro {
namespace {

// Grid (n tiles, m tiles, E).
template <int RQ, typename TM, int MASK, bool WITH_PSI>
__global__ void __launch_bounds__(kThreads)
shrink_kernel(const float* __restrict__ u, const float* __restrict__ v,
              const TM* __restrict__ m, const void* __restrict__ w,
              const float* __restrict__ lam, float* __restrict__ s,
              float* __restrict__ psi, int M, int N, int r) {
  constexpr int LD = factor_ld<RQ>();
  extern __shared__ float4 smem4[];
  float* Us = reinterpret_cast<float*>(smem4);
  float* Vs = Us + kTile * LD;

  const int e = blockIdx.z;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const ClientPlanes<TM, MASK> planes(m, w, e, M, N);
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
      float x, wt;
      planes.load(i, j, x, wt);
      const float res = x - low[a][b];
      const float mag = fmaxf(fabsf(res) - lam_e, 0.f);
      const float out = res > 0.f ? mag : (res < 0.f ? -mag : 0.f);
      const size_t at = static_cast<size_t>(e) * M * N +
                        static_cast<size_t>(i) * N + j;
      const float s_ij = apply_mask<MASK>(wt, out);
      s[at] = s_ij;
      if constexpr (WITH_PSI) psi[at] = apply_mask<MASK>(wt, res) - s_ij;
    }
}

template <int RQ, typename TM, int MASK, bool WITH_PSI>
cudaError_t launch_shrink(const float* u, const float* v, const TM* m,
                          const void* w, const float* lam, float* s,
                          float* psi, int E, int M, int N, int r,
                          cudaStream_t stream) {
  auto kernel = shrink_kernel<RQ, TM, MASK, WITH_PSI>;
  const size_t smem = sizeof(float) * 2 * kTile * factor_ld<RQ>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile, E);
  kernel<<<grid, kThreads, smem, stream>>>(u, v, m, w, lam, s, psi, M, N, r);
  return cudaGetLastError();
}

template <bool WITH_PSI>
int shrink_entry(const float* u, const float* v, const void* m, const void* w,
                 const float* lam, float* s, float* psi, int E, int M, int N,
                 int r, int dtype, int mask, void* stream) {
  return dispatch<false>(r, dtype, mask, [&](auto rq, auto tm, auto mk) {
    using TM = typename decltype(tm)::type;
    return launch_shrink<decltype(rq)::value, TM, decltype(mk)::value,
                         WITH_PSI>(u, v, static_cast<const TM*>(m), w, lam, s,
                                   psi, E, M, N, r,
                                   static_cast<cudaStream_t>(stream));
  });
}

}  // namespace
}  // namespace repro

// Both entries return cudaGetLastError() of the launch (0 on success).  m is
// fp32 or bf16 (dtype code), w null or dense (mask code 0 or 1, tile.cuh).
extern "C" int repro_residual_shrink(const float* u, const float* v,
                                     const void* m, const void* w,
                                     const float* lam, float* s, int E, int M,
                                     int N, int r, int dtype, int mask,
                                     void* stream) {
  return repro::shrink_entry<false>(u, v, m, w, lam, s, nullptr, E, M, N, r,
                                    dtype, mask, stream);
}

extern "C" int repro_residual_shrink_psi(const float* u, const float* v,
                                         const void* m, const void* w,
                                         const float* lam, float* s,
                                         float* psi, int E, int M, int N,
                                         int r, int dtype, int mask,
                                         void* stream) {
  return repro::shrink_entry<true>(u, v, m, w, lam, s, psi, E, M, N, r, dtype,
                                   mask, stream);
}
