// huber_contract_v: the inner-sweep contraction of DCF-PCA, batched over a
// leading client axis E, fp32 on the CUDA cores.
//
//   out[e, j, :] = sum_i Psi[e, i, j] U[e, i, :],  Psi = W * clip(R, +-lam),
//   R = M - U V^T  (W = 1 without a mask; M fp32 or bf16; W dense or packed)
//
//   replaces repro/kernels/huber_contract.py::_contract_v_kernel (:82),
//   _contract_v_masked_kernel (:97) and, with a packed W,
//   huber_contract_v_packed (:553, body _make_dual_kernel :341).
//
// What bounds it on an H100: arithmetic.  Each residual entry costs 2r FLOP
// for U V^T and 2r for the contraction against 4 bytes of M (2 in bf16, plus
// 4 or 1/8 of W), so at r = 64 it sits at >= 64 FLOP/byte, right of the fp32
// ridge (67 TFLOP/s / 3.35 TB/s ~ 20 FLOP/byte); bf16 M and a packed W
// shrink the footprint, not the time.  The design reads M (and W) once,
// keeps the residual tile in shared memory (it never reaches device memory)
// and spends its effort on the FMA loops: a 2 x 2 register patch for U V^T
// and a 4 x RQ register patch for the contraction, with the staged factor
// rows read conflict-free.  No tensor cores and no TF32: the solver's
// recovery bar needs full fp32.
//
// Determinism: no atomics.  The m reduction is split into a fixed number of
// row ranges (chosen from the shape and SM count alone) that write partial
// sums, then summed in index order (reduce.cuh).  Every mask mode and data
// type shares one accumulation order (tile.cuh).
#include "reduce.cuh"
#include "tile.cuh"

namespace repro {
namespace {

// Grid (n tiles, row splits, E).  A block owns 32 columns, keeps their V
// rows staged, and walks its row range 32 rows at a time.
template <int RQ, typename TM, int MASK>
__global__ void __launch_bounds__(kThreads)
contract_v_kernel(const float* __restrict__ u, const float* __restrict__ v,
                  const TM* __restrict__ m, const void* __restrict__ w,
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
  const ClientPlanes<TM, MASK> planes(m, w, e, M, N);
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
        float x, wt;
        planes.load(i0 + 2 * ti + a, j0 + 2 * tj + b, x, wt);
        Ps[(2 * ti + a) * kTile + 2 * tj + b] =
            apply_mask<MASK>(wt, clip(x - low[a][b], lam_e));
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

template <int RQ, typename TM, int MASK>
cudaError_t launch_v(const float* u, const float* v, const TM* m,
                     const void* w, const float* lam, float* out,
                     float* partial, int E, int M, int N, int r, int splits,
                     int rows_per_split, cudaStream_t stream) {
  auto kernel = contract_v_kernel<RQ, TM, MASK>;
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
  return launch_sum_splits(partial, out, static_cast<size_t>(E) * N * r,
                           splits, stream);
}

}  // namespace
}  // namespace repro

// Returns cudaGetLastError() of the launches (0 on success).  m is fp32 or
// bf16 (dtype code), w null, dense or packed (mask code, tile.cuh); partial
// holds splits * E * N * r floats when splits > 1 (unused otherwise).
extern "C" int repro_huber_contract_v(const float* u, const float* v,
                                      const void* m, const void* w,
                                      const float* lam, float* out,
                                      float* partial, int E, int M, int N,
                                      int r, int dtype, int mask, int splits,
                                      int rows_per_split, void* stream) {
  return repro::dispatch(r, dtype, mask, [&](auto rq, auto tm, auto mk) {
    using TM = typename decltype(tm)::type;
    return repro::launch_v<decltype(rq)::value, TM, decltype(mk)::value>(
        u, v, static_cast<const TM*>(m), w, lam, out, partial, E, M, N, r,
        splits, rows_per_split, static_cast<cudaStream_t>(stream));
  });
}
