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
// M is fp32 or bf16 (upcast on load); W is absent, a dense fp32 plane or a
// bit-packed one, read as it is (the reference unpacks a packed plane
// first; here its bits cost 1/8 byte an entry instead of 4).
//
// What bounds it on an H100: it depends on r.  Each output entry costs 2r
// FLOP of U V^T against 6-16 bytes (read M and W, write S; Psi adds 4):
// ~37 FLOP/byte at r = 150, right of the fp32 ridge (~20 FLOP/byte), so
// the FMAs bound it there; at r = 64 ~11 with fp32 M and a dense mask (the
// bytes bound it) and ~21 with bf16 M and a packed mask (near the ridge).
// The design is tile64.cuh's, shared with the contractions: one block
// computes one 64 x 64 output tile from 64-row slices of U and V staged by
// cp.async, each of its 256 threads a 4 x 4 patch of U V^T read as float4
// along the rank axis (8 shared loads for 64 FMAs per 4 ranks); the rank
// sum runs in one fixed order whatever the mask, so an all-ones mask gives
// the bits of none and a packed mask those of the dense plane it packs.  A thread's M (and W)
// entries load before the staging wait, so their latency hides under it.
// A warp's loads of M and stores of S and Psi cover 4 rows x 8 adjacent
// columns: whole 32-byte sectors.  Two blocks share an SM up to r = 192, so
// one block's staging runs under the other's FMAs.  The residual lives only
// in registers, and M, W, S (and Psi) each cross device memory once.
// Ranks 257-512 (shrink_wide_kernel) stage and sum the rank axis in two
// halves, above 512 (shrink_chunk_kernel) in chunks of 256, one after the
// other (tile64.cuh), one block an SM.
#include "tile.cuh"
#include "tile64.cuh"

namespace repro {
namespace {

// The epilogue of one thread's 4 x 4 patch: S = W sign(R) max(|R| - lam, 0)
// (and Psi = W R - S) for R = x - low, stored where inside the plane.  A
// NaN residual gives a NaN S (max_nan), as the plain versions' sign and
// clamp do; R = 0 gives +0.
template <int MASK, bool WITH_PSI>
__device__ __forceinline__ void shrink_store(const float x[4][4],
                                             const float wt[4][4],
                                             const float low[4][4],
                                             float lam_e, float* s_e,
                                             float* psi_e, int i0, int j0,
                                             int ti, int tj, int M, int N) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ti + 16 * a;
    if (i >= M) continue;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = j0 + tj + 16 * b;
      if (j >= N) continue;
      const float res = x[a][b] - low[a][b];
      const float mag = max_nan(fabsf(res) - lam_e, 0.f);
      const float out = res < 0.f ? -mag : (res == 0.f ? 0.f : mag);
      const float s_ij = apply_mask<MASK>(wt[a][b], out);
      const size_t at = static_cast<size_t>(i) * N + j;
      s_e[at] = s_ij;
      if constexpr (WITH_PSI)
        psi_e[at] = apply_mask<MASK>(wt[a][b], res) - s_ij;
    }
  }
}

template <int RQ>
__host__ __device__ constexpr size_t shrink_smem_bytes() {
  return sizeof(float) * 2 * kT64 * ld64<RQ>();
}

// Grid (n tiles, m tiles, E).
template <int RQ, typename TM, int MASK, bool WITH_PSI>
__global__ void __launch_bounds__(
    kT64Threads, two_blocks_fit(shrink_smem_bytes<RQ>()) ? 2 : 1)
shrink_kernel(const float* __restrict__ u, const float* __restrict__ v,
              const TM* __restrict__ m, const void* __restrict__ w,
              const float* __restrict__ lam, float* __restrict__ s,
              float* __restrict__ psi, int M, int N, int r) {
  constexpr int LD = ld64<RQ>();
  extern __shared__ float4 smem4[];
  float* Us = reinterpret_cast<float*>(smem4);  // kT64 x LD
  float* Vs = Us + kT64 * LD;                   // kT64 x LD

  const int e = blockIdx.z;
  const int i0 = blockIdx.y * kT64;
  const int j0 = blockIdx.x * kT64;
  const ClientPlanes<TM, MASK> planes(m, w, e, M, N);
  const float lam_e = lam[e];

  stage_async<RQ>(Us, u + static_cast<size_t>(e) * M * r, i0, M, r);
  stage_async<RQ>(Vs, v + static_cast<size_t>(e) * N * r, j0, N, r);
  cp_async_commit();

  // Patch rows ti + 16 a, columns tj + 16 b; a warp is 4 x 8 threads.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ti = (warp >> 1) * 4 + (lane >> 3);
  const int tj = (warp & 1) * 8 + (lane & 7);
  float x[4][4], wt[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      planes.load(i0 + ti + 16 * a, j0 + tj + 16 * b, x[a][b], wt[a][b]);
  cp_async_wait_all();
  __syncthreads();

  // The rank loop unrolled by 2 (3-4% at r = 150 on an H100; the
  // contractions, which share it, keep theirs).
  float low[4][4];
  patch44<RQ, 2>(Us, Vs, ti, tj, (r + 3) / 4, low);
  shrink_store<MASK, WITH_PSI>(
      x, wt, low, lam_e, s + static_cast<size_t>(e) * M * N,
      WITH_PSI ? psi + static_cast<size_t>(e) * M * N : nullptr, i0, j0, ti,
      tj, M, N);
}

// Ranks 257 .. 512 in two halves (tile64.cuh): the tile's U and V slices of
// one half at a time, 133 KB at RQH = 8 (one block an SM).  Half 0 is
// staged and its patch summed, then half 1 into the same slices, and the
// residual is M - (low(half 0) + low(half 1)); the epilogue is
// shrink_kernel's.
template <int RQH, typename TM, int MASK, bool WITH_PSI>
__global__ void __launch_bounds__(kT64Threads, 1)
shrink_wide_kernel(const float* __restrict__ u, const float* __restrict__ v,
                   const TM* __restrict__ m, const void* __restrict__ w,
                   const float* __restrict__ lam, float* __restrict__ s,
                   float* __restrict__ psi, int M, int N, int r) {
  constexpr int K0 = wide_half(RQH);
  extern __shared__ float4 smem4[];
  float* Us = reinterpret_cast<float*>(smem4);  // kT64 x ld64<RQH>()
  float* Vs = Us + kT64 * ld64<RQH>();          // kT64 x ld64<RQH>()

  const int e = blockIdx.z;
  const int i0 = blockIdx.y * kT64;
  const int j0 = blockIdx.x * kT64;
  const ClientPlanes<TM, MASK> planes(m, w, e, M, N);
  const float lam_e = lam[e];
  const float* ue = u + static_cast<size_t>(e) * M * r;
  const float* ve = v + static_cast<size_t>(e) * N * r;

  stage_window<RQH>(Us, ue, i0, M, r, 0, K0);
  stage_window<RQH>(Vs, ve, j0, N, r, 0, K0);
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ti = (warp >> 1) * 4 + (lane >> 3);
  const int tj = (warp & 1) * 8 + (lane & 7);
  float x[4][4], wt[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      planes.load(i0 + ti + 16 * a, j0 + tj + 16 * b, x[a][b], wt[a][b]);
  cp_async_wait_all();
  __syncthreads();
  float la[4][4], lb[4][4];
  patch44<RQH, 2>(Us, Vs, ti, tj, K0 / 4, la);
  __syncthreads();  // nobody reads half 0 any more
  stage_window<RQH>(Us, ue, i0, M, r, K0, r - K0);
  stage_window<RQH>(Vs, ve, j0, N, r, K0, r - K0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  patch44<RQH, 2>(Us, Vs, ti, tj, (r - K0 + 3) / 4, lb);
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) la[a][b] += lb[a][b];
  shrink_store<MASK, WITH_PSI>(
      x, wt, la, lam_e, s + static_cast<size_t>(e) * M * N,
      WITH_PSI ? psi + static_cast<size_t>(e) * M * N : nullptr, i0, j0, ti,
      tj, M, N);
}

// Ranks above 512 in chunks of 256 (tile64.cuh's chunked_low), staged one
// after the other into the same two slices (133 KB, one block an SM); the
// residual is M - ((low(c0) + low(c1)) + ...), the epilogue
// shrink_kernel's.
template <typename TM, int MASK, bool WITH_PSI>
__global__ void __launch_bounds__(kT64Threads, 1)
shrink_chunk_kernel(const float* __restrict__ u, const float* __restrict__ v,
                    const TM* __restrict__ m, const void* __restrict__ w,
                    const float* __restrict__ lam, float* __restrict__ s,
                    float* __restrict__ psi, int M, int N, int r) {
  extern __shared__ float4 smem4[];
  float* Us = reinterpret_cast<float*>(smem4);  // kT64 x ld64<kChunkRQ>()
  float* Vs = Us + kT64 * ld64<kChunkRQ>();     // kT64 x ld64<kChunkRQ>()

  const int e = blockIdx.z;
  const int i0 = blockIdx.y * kT64;
  const int j0 = blockIdx.x * kT64;
  const ClientPlanes<TM, MASK> planes(m, w, e, M, N);
  const float lam_e = lam[e];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ti = (warp >> 1) * 4 + (lane >> 3);
  const int tj = (warp & 1) * 8 + (lane & 7);
  float x[4][4], wt[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      planes.load(i0 + ti + 16 * a, j0 + tj + 16 * b, x[a][b], wt[a][b]);
  float low[4][4];
  chunked_low<2>(Us, Vs, u + static_cast<size_t>(e) * M * r,
                           v + static_cast<size_t>(e) * N * r, i0, M, j0, N,
                           r, ti, tj, low);
  shrink_store<MASK, WITH_PSI>(
      x, wt, low, lam_e, s + static_cast<size_t>(e) * M * N,
      WITH_PSI ? psi + static_cast<size_t>(e) * M * N : nullptr, i0, j0, ti,
      tj, M, N);
}

template <int RQ, typename TM, int MASK, bool WITH_PSI>
cudaError_t launch_shrink(const float* u, const float* v, const TM* m,
                          const void* w, const float* lam, float* s,
                          float* psi, int E, int M, int N, int r,
                          cudaStream_t stream) {
  // RQ > 8: two rank halves of RQ / 2 register groups; kChunked: chunks of
  // 256 (tile.cuh's by_rank).
  constexpr int kRQ = RQ == kChunked ? kChunkRQ : RQ > 8 ? RQ / 2 : RQ;
  auto kernel = shrink_chunk_kernel<TM, MASK, WITH_PSI>;
  if constexpr (RQ > 8)
    kernel = shrink_wide_kernel<RQ / 2, TM, MASK, WITH_PSI>;
  else if constexpr (RQ != kChunked)
    kernel = shrink_kernel<RQ, TM, MASK, WITH_PSI>;
  constexpr size_t smem = shrink_smem_bytes<kRQ>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kT64 - 1) / kT64, (M + kT64 - 1) / kT64, E);
  kernel<<<grid, kT64Threads, smem, stream>>>(u, v, m, w, lam, s, psi, M, N,
                                              r);
  return cudaGetLastError();
}

template <bool WITH_PSI>
int shrink_entry(const float* u, const float* v, const void* m, const void* w,
                 const float* lam, float* s, float* psi, int E, int M, int N,
                 int r, int dtype, int mask, void* stream) {
  return dispatch(r, dtype, mask, [&](auto rq, auto tm, auto mk) {
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
// fp32 or bf16 (dtype code), w null, dense or bit-packed (mask code 0, 1 or
// 2, tile.cuh).
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
