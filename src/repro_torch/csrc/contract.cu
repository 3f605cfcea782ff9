// Huber-residual contractions of DCF-PCA, batched over a leading client
// axis E, fp32 on the CUDA cores.
//
//   huber_contract_v       out[e, j, :] = sum_i Psi[e, i, j] U[e, i, :]
//       replaces repro/kernels/huber_contract.py::_contract_v_kernel (:82)
//       and _contract_v_masked_kernel (:97); Psi = clip(R, +-lam), masked
//       Psi = W * clip(R, +-lam).
//   huber_contract_u_diag  out_u[e, i, :] = sum_j Psi[e, i, j] V[e, j, :],
//       obj[e] = sum H_lam(R_W), psi2[e] = sum Psi^2
//       replaces _make_dual_kernel(with_v=False) (:341) behind
//       huber_contract_u_diag[_masked] (:521, :537); R_W = W * R and
//       Psi = clip(R_W, +-lam).
//
// What bounds them on an H100: arithmetic.  Each residual entry costs 2r FLOP
// for U V^T and 2r for the contraction against 4 bytes of M, so at r = 150
// the kernels sit at ~150 FLOP/byte, far right of the fp32 ridge
// (67 TFLOP/s / 3.35 TB/s ~ 20 FLOP/byte).  The design therefore reads M
// exactly once, keeps the residual tile in shared memory (it never reaches
// device memory) and spends its effort on the FMA loops: a 2 x 2 register
// patch for U V^T and a 4 x RQ register patch for the contraction, with the
// staged factor rows read conflict-free.  No tensor cores and no TF32: the
// solver's recovery bar needs full fp32.
//
// Determinism: no atomics.  huber_contract_v splits the m reduction into a
// fixed number of row ranges (chosen from the shape alone) that write
// partial sums, then sums them in index order; huber_contract_u_diag reduces
// over n inside its block, and its two scalars go through per-block partials
// summed in a fixed order by a second launch.  The masked and unmasked
// instantiations share every accumulation, so an all-ones mask gives the
// same bits as no mask.
#include <algorithm>

#include "tile.cuh"

namespace repro {
namespace {

// ---------------------------------------------------------------------------
// out_v = Psi^T U: grid (n tiles, row splits, E).  A block owns 32 columns,
// keeps their V rows staged, and walks its row range 32 rows at a time.
// ---------------------------------------------------------------------------
template <int RQ, bool MASKED>
__global__ void __launch_bounds__(kThreads)
contract_v_kernel(const float* __restrict__ u, const float* __restrict__ v,
                  const float* __restrict__ m, const float* __restrict__ w,
                  const float* __restrict__ lam, float* __restrict__ partial,
                  int E, int M, int N, int r, int rows_per_split) {
  constexpr int LD = factor_ld<RQ>();
  extern __shared__ float4 smem4[];
  float* Ps = reinterpret_cast<float*>(smem4);  // 32 x 32, 16-byte aligned
  float* Us = Ps + kTile * kTile;
  float* Vs = Us + kTile * LD;

  const int e = blockIdx.z;
  const int j0 = blockIdx.x * kTile;
  const int split = blockIdx.y;
  const float* ue = u + static_cast<size_t>(e) * M * r;
  const float* ve = v + static_cast<size_t>(e) * N * r;
  const float* me = m + static_cast<size_t>(e) * M * N;
  const float* we = MASKED ? w + static_cast<size_t>(e) * M * N : nullptr;
  const float lam_e = lam[e];

  const int ti = threadIdx.x / 16, tj = threadIdx.x % 16;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;

  stage_rows<RQ>(Vs, ve, j0, N, r);
  float acc[4][RQ];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int q = 0; q < RQ; ++q) acc[c][q] = 0.f;

  const int row_begin = split * rows_per_split;
  const int row_end = min(M, row_begin + rows_per_split);
  for (int i0 = row_begin; i0 < row_end; i0 += kTile) {
    stage_rows<RQ>(Us, ue, i0, M, r);
    __syncthreads();

    float low[2][2];
    low_rank_patch<RQ>(Us, Vs, r, low);
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int i = i0 + 2 * ti + a, j = j0 + 2 * tj + b;
        float x = 0.f, wt = 0.f;
        if (i < M && j < N) {
          const size_t at = static_cast<size_t>(i) * N + j;
          x = me[at];
          if (MASKED) wt = we[at];
        }
        float psi = clip(x - low[a][b], lam_e);
        if (MASKED) psi = __fmul_rn(wt, psi);
        Ps[(2 * ti + a) * kTile + 2 * tj + b] = psi;
      }
    __syncthreads();

    // acc[c][q] += sum_ii Psi[ii, 4 ty + c] * U[ii, tx + 32 q]
    for (int ii = 0; ii < kTile; ++ii) {
      const float4 p = reinterpret_cast<const float4*>(Ps + ii * kTile)[ty];
      const float* urow = Us + ii * LD;
#pragma unroll
      for (int q = 0; q < RQ; ++q) {
        const float uq = urow[tx + 32 * q];
        acc[0][q] = fmaf(p.x, uq, acc[0][q]);
        acc[1][q] = fmaf(p.y, uq, acc[1][q]);
        acc[2][q] = fmaf(p.z, uq, acc[2][q]);
        acc[3][q] = fmaf(p.w, uq, acc[3][q]);
      }
    }
    __syncthreads();
  }

  float* dst = partial + (static_cast<size_t>(split) * E + e) * N * r;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int j = j0 + 4 * ty + c;
    if (j >= N) continue;
#pragma unroll
    for (int q = 0; q < RQ; ++q) {
      const int k = tx + 32 * q;
      if (k < r) dst[static_cast<size_t>(j) * r + k] = acc[c][q];
    }
  }
}

// out[idx] = sum_s partial[s, idx], s in index order.
__global__ void sum_splits_kernel(const float* __restrict__ partial,
                                  float* __restrict__ out, size_t count,
                                  int splits) {
  for (size_t idx = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       idx < count; idx += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += partial[k * count + idx];
    out[idx] = s;
  }
}

// ---------------------------------------------------------------------------
// out_u = Psi V plus the diagnostics: grid (m tiles, E).  A block owns 32
// rows, keeps their U rows staged, and walks all n columns 32 at a time.
// ---------------------------------------------------------------------------
template <int RQ, bool MASKED>
__global__ void __launch_bounds__(kThreads)
contract_u_diag_kernel(const float* __restrict__ u, const float* __restrict__ v,
                       const float* __restrict__ m, const float* __restrict__ w,
                       const float* __restrict__ lam, float* __restrict__ out_u,
                       float* __restrict__ partial, int E, int M, int N, int r) {
  constexpr int LD = factor_ld<RQ>();
  extern __shared__ float4 smem4[];
  float* Ps = reinterpret_cast<float*>(smem4);
  float* Us = Ps + kTile * kTile;
  float* Vs = Us + kTile * LD;
  __shared__ float red[2][kThreads];

  const int e = blockIdx.y;
  const int i0 = blockIdx.x * kTile;
  const float* ue = u + static_cast<size_t>(e) * M * r;
  const float* ve = v + static_cast<size_t>(e) * N * r;
  const float* me = m + static_cast<size_t>(e) * M * N;
  const float* we = MASKED ? w + static_cast<size_t>(e) * M * N : nullptr;
  const float lam_e = lam[e];
  const float half_lam2 = 0.5f * lam_e * lam_e;

  const int ti = threadIdx.x / 16, tj = threadIdx.x % 16;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;

  stage_rows<RQ>(Us, ue, i0, M, r);
  float acc[4][RQ];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int q = 0; q < RQ; ++q) acc[c][q] = 0.f;
  float obj = 0.f, psi2 = 0.f;

  for (int j0 = 0; j0 < N; j0 += kTile) {
    stage_rows<RQ>(Vs, ve, j0, N, r);
    __syncthreads();

    float low[2][2];
    low_rank_patch<RQ>(Us, Vs, r, low);
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int i = i0 + 2 * ti + a, j = j0 + 2 * tj + b;
        float x = 0.f, wt = 0.f;
        if (i < M && j < N) {
          const size_t at = static_cast<size_t>(i) * N + j;
          x = me[at];
          if (MASKED) wt = we[at];
        }
        float rw = x - low[a][b];
        if (MASKED) rw = __fmul_rn(wt, rw);
        const float psi = clip(rw, lam_e);
        const float ab = fabsf(rw);
        obj += (ab <= lam_e) ? 0.5f * rw * rw : lam_e * ab - half_lam2;
        psi2 = fmaf(psi, psi, psi2);
        Ps[(2 * ti + a) * kTile + 2 * tj + b] = psi;
      }
    __syncthreads();

    // acc[c][q] += sum_jj Psi[4 ty + c, jj] * V[jj, tx + 32 q]
    for (int jj = 0; jj < kTile; ++jj) {
      const float p0 = Ps[(4 * ty + 0) * kTile + jj];
      const float p1 = Ps[(4 * ty + 1) * kTile + jj];
      const float p2 = Ps[(4 * ty + 2) * kTile + jj];
      const float p3 = Ps[(4 * ty + 3) * kTile + jj];
      const float* vrow = Vs + jj * LD;
#pragma unroll
      for (int q = 0; q < RQ; ++q) {
        const float vq = vrow[tx + 32 * q];
        acc[0][q] = fmaf(p0, vq, acc[0][q]);
        acc[1][q] = fmaf(p1, vq, acc[1][q]);
        acc[2][q] = fmaf(p2, vq, acc[2][q]);
        acc[3][q] = fmaf(p3, vq, acc[3][q]);
      }
    }
    __syncthreads();
  }

  float* dst = out_u + static_cast<size_t>(e) * M * r;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int i = i0 + 4 * ty + c;
    if (i >= M) continue;
#pragma unroll
    for (int q = 0; q < RQ; ++q) {
      const int k = tx + 32 * q;
      if (k < r) dst[static_cast<size_t>(i) * r + k] = acc[c][q];
    }
  }

  // Block sum of the two scalars: a fixed tree over the 256 threads.
  red[0][threadIdx.x] = obj;
  red[1][threadIdx.x] = psi2;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      red[0][threadIdx.x] += red[0][threadIdx.x + s];
      red[1][threadIdx.x] += red[1][threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const int tiles = gridDim.x;
    partial[static_cast<size_t>(e) * tiles + blockIdx.x] = red[0][0];
    partial[static_cast<size_t>(E + e) * tiles + blockIdx.x] = red[1][0];
  }
}

// obj[e] = sum_t partial[e, t], psi2[e] = sum_t partial[E + e, t], in order.
__global__ void sum_diag_kernel(const float* __restrict__ partial,
                                float* __restrict__ obj,
                                float* __restrict__ psi2, int E, int tiles) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  float a = 0.f, b = 0.f;
  for (int t = 0; t < tiles; ++t) {
    a += partial[static_cast<size_t>(e) * tiles + t];
    b += partial[static_cast<size_t>(E + e) * tiles + t];
  }
  obj[e] = a;
  psi2[e] = b;
}

template <int RQ, bool MASKED>
cudaError_t launch_v(const float* u, const float* v, const float* m,
                     const float* w, const float* lam, float* out,
                     float* partial, int E, int M, int N, int r, int splits,
                     int rows_per_split, cudaStream_t stream) {
  auto kernel = contract_v_kernel<RQ, MASKED>;
  const size_t smem = smem_bytes<RQ>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kTile - 1) / kTile, splits, E);
  float* dst = splits == 1 ? out : partial;
  kernel<<<grid, kThreads, smem, stream>>>(u, v, m, w, lam, dst, E, M, N, r,
                                           rows_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t count = static_cast<size_t>(E) * N * r;
  const int blocks = static_cast<int>(std::min<size_t>((count + 255) / 256, 4096));
  sum_splits_kernel<<<blocks, 256, 0, stream>>>(partial, out, count, splits);
  return cudaGetLastError();
}

template <int RQ, bool MASKED>
cudaError_t launch_u_diag(const float* u, const float* v, const float* m,
                          const float* w, const float* lam, float* out_u,
                          float* obj, float* psi2, float* partial, int E, int M,
                          int N, int r, cudaStream_t stream) {
  auto kernel = contract_u_diag_kernel<RQ, MASKED>;
  const size_t smem = smem_bytes<RQ>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = (M + kTile - 1) / kTile;
  const dim3 grid(tiles, E);
  kernel<<<grid, kThreads, smem, stream>>>(u, v, m, w, lam, out_u, partial, E,
                                           M, N, r);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_diag_kernel<<<(E + 127) / 128, 128, 0, stream>>>(partial, obj, psi2, E,
                                                        tiles);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

extern "C" int repro_max_rank() { return repro::kMaxRank; }

// Returns cudaGetLastError() of the launches (0 on success).  w may be null.
// partial holds splits * E * N * r floats when splits > 1 (unused otherwise).
extern "C" int repro_huber_contract_v(const float* u, const float* v,
                                      const float* m, const float* w,
                                      const float* lam, float* out,
                                      float* partial, int E, int M, int N,
                                      int r, int splits, int rows_per_split,
                                      void* stream) {
  REPRO_RQ_DISPATCH(repro::launch_v, u, v, m, w, lam, out, partial, E, M, N, r,
                    splits, rows_per_split, static_cast<cudaStream_t>(stream))
}

// partial holds 2 * E * ceil(M / 32) floats.
extern "C" int repro_huber_contract_u_diag(const float* u, const float* v,
                                           const float* m, const float* w,
                                           const float* lam, float* out_u,
                                           float* obj, float* psi2,
                                           float* partial, int E, int M, int N,
                                           int r, void* stream) {
  REPRO_RQ_DISPATCH(repro::launch_u_diag, u, v, m, w, lam, out_u, obj, psi2,
                    partial, E, M, N, r, static_cast<cudaStream_t>(stream))
}
