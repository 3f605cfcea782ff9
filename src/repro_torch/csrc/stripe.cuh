// The row-stripe kernel behind huber_contract_u, huber_contract_u_diag and
// huber_dual_contract (contract_u.cu, contract_u_diag.cu, dual.cu each
// instantiate one flavour, so the three build in parallel).
//
// Grid (m tiles, E).  A block owns one 32-row stripe of one client, keeps
// its U rows staged, and walks all n columns 32 at a time.  From each
// residual tile, with R_W = W * R and Psi = clip(R_W, +-lam):
//   out_u[e, i, :] = sum_j Psi[i, j] V[j, :]    completes in the block's
//                                               registers (always);
//   WITH_DIAG  the block's share of H_lam(R_W) and ||Psi||^2, written as
//              per-block partials and summed in order by a second launch;
//   WITH_V     the stripe's (32-column x r) share of Psi^T U for each column
//              tile, written to a partial plane (stripes, E, n, r) and
//              summed over the stripes in index order by a second launch.
// The three flavours share every accumulation of out_u, so huber_contract_u
// (fused="off") and huber_contract_u_diag (fused="diag") give the same bits,
// and huber_dual_contract's out_u, obj and psi2 are those of u_diag.
//
// What bounds them on an H100: arithmetic (4r FLOP per entry, 6r for the
// dual, against 2-4 bytes of M and 1/8-4 of W).  The dual kernel computes
// U V^T once per tile for both contractions, 6 E m n r FLOP against 8 for a
// v pass plus a u_diag pass; its price is the partial plane, (m / 32) E n r
// floats written once and read once (33.5 MB at E = 4, m = 2048, n = 512,
// r = 64), since blocks on the card run in no order and no fp32 atomics are
// used.
#pragma once

#include "reduce.cuh"
#include "tile.cuh"

namespace repro {

template <int RQ, typename TM, int MASK, bool WITH_DIAG, bool WITH_V>
__global__ void __launch_bounds__(kThreads)
stripe_kernel(const float* __restrict__ u, const float* __restrict__ v,
              const TM* __restrict__ m, const void* __restrict__ w,
              const float* __restrict__ lam, float* __restrict__ out_u,
              float* __restrict__ diag_partial,
              float* __restrict__ v_partial, int E, int M, int N, int r) {
  constexpr int LD = factor_ld<RQ>();
  extern __shared__ float4 smem4[];
  float* Ps = reinterpret_cast<float*>(smem4);  // 32 x 32, 16-byte aligned
  float* Us = Ps + kTile * kTile;
  float* Vs = Us + kTile * LD;

  const int e = blockIdx.y;
  const int i0 = blockIdx.x * kTile;
  const float* ue = u + static_cast<size_t>(e) * M * r;
  const float* ve = v + static_cast<size_t>(e) * N * r;
  const ClientPlanes<TM, MASK> planes(m, w, e, M, N);
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
        float x, wt;
        planes.load(i0 + 2 * ti + a, j0 + 2 * tj + b, x, wt);
        const float rw = apply_mask<MASK>(wt, x - low[a][b]);
        const float psi = clip(rw, lam_e);
        if (WITH_DIAG) {
          const float ab = fabsf(rw);
          obj += (ab <= lam_e) ? 0.5f * rw * rw : lam_e * ab - half_lam2;
          psi2 = fmaf(psi, psi, psi2);
        }
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

    if (WITH_V) {
      // pv[c][q] = sum_ii Psi[ii, 4 ty + c] * U[ii, tx + 32 q]: this
      // stripe's share of out_v for the tile's 32 columns.
      float pv[4][RQ];
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int q = 0; q < RQ; ++q) pv[c][q] = 0.f;
      for (int ii = 0; ii < kTile; ++ii) {
        const float4 p = reinterpret_cast<const float4*>(Ps + ii * kTile)[ty];
        const float* urow = Us + ii * LD;
#pragma unroll
        for (int q = 0; q < RQ; ++q) {
          const float uq = urow[tx + 32 * q];
          pv[0][q] = fmaf(p.x, uq, pv[0][q]);
          pv[1][q] = fmaf(p.y, uq, pv[1][q]);
          pv[2][q] = fmaf(p.z, uq, pv[2][q]);
          pv[3][q] = fmaf(p.w, uq, pv[3][q]);
        }
      }
      float* dst = v_partial + (static_cast<size_t>(blockIdx.x) * E + e) * N * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = j0 + 4 * ty + c;
        if (j >= N) continue;
#pragma unroll
        for (int q = 0; q < RQ; ++q) {
          const int k = tx + 32 * q;
          if (k < r) dst[static_cast<size_t>(j) * r + k] = pv[c][q];
        }
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

  if (WITH_DIAG) {
    // Block sum of the two scalars: a fixed tree over the 256 threads.
    __shared__ float red[2][kThreads];
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
      diag_partial[static_cast<size_t>(e) * tiles + blockIdx.x] = red[0][0];
      diag_partial[static_cast<size_t>(E + e) * tiles + blockIdx.x] = red[1][0];
    }
  }
}

// Number of 32-row stripes: the grid's x extent and the number of partials
// per client (diag_partial holds 2 * E * stripes floats, v_partial
// stripes * E * N * r).
inline int stripes(int M) { return (M + kTile - 1) / kTile; }

// The stripe kernel, then the fixed-order sums of its partials: out_v from
// v_partial (WITH_V), obj and psi2 from diag_partial (WITH_DIAG).
template <int RQ, typename TM, int MASK, bool WITH_DIAG, bool WITH_V>
cudaError_t launch_stripe(const float* u, const float* v, const TM* m,
                          const void* w, const float* lam, float* out_u,
                          float* out_v, float* obj, float* psi2,
                          float* diag_partial, float* v_partial, int E, int M,
                          int N, int r, cudaStream_t stream) {
  auto kernel = stripe_kernel<RQ, TM, MASK, WITH_DIAG, WITH_V>;
  const size_t smem = smem_bytes<RQ>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = stripes(M);
  kernel<<<dim3(tiles, E), kThreads, smem, stream>>>(
      u, v, m, w, lam, out_u, diag_partial, v_partial, E, M, N, r);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (WITH_V) {
    err = launch_sum_splits(v_partial, out_v, static_cast<size_t>(E) * N * r,
                            tiles, stream);
    if (err != cudaSuccess) return err;
  }
  if (WITH_DIAG) err = launch_sum_diag(diag_partial, obj, psi2, E, tiles, stream);
  return err;
}

}  // namespace repro
