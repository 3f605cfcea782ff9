// huber_contract_u_diag: the default U-step contraction of DCF-PCA with the
// round diagnostics, batched over a leading client axis E, fp32 on the CUDA
// cores.
//
//   out_u[e, i, :] = sum_j Psi[e, i, j] V[e, j, :],  obj[e] = sum H_lam(R_W),
//   psi2[e] = sum Psi^2,  R_W = W * (M - U V^T),  Psi = clip(R_W, +-lam)
//   (W = 1 without a mask; M fp32 or bf16; W dense or packed)
//
//   replaces _make_dual_kernel(with_v=False) (:341) behind
//   repro/kernels/huber_contract.py::huber_contract_u_diag (:521) and
//   huber_contract_u_diag_masked (:537, dense or packed W).
//
// What bounds it on an H100: fp32 arithmetic, 4r FLOP per residual entry
// (2r of U V^T, 2r of Psi V) against 2-4 bytes of M.  The design is
// stripe.cuh's with diagnostics, without out_v: 64-row stripes on a grid
// whose column splits fill the card at E = 1 (one client's 47 stripes were
// 94 blocks of 32 rows on 132 SMs before), 4 x 4 U V^T patches and 2-row x
// RQ Psi V blocks read as float4, a cp.async ring of V tiles.  The two
// scalars go through per-block partials and a fixed-order second launch
// (reduce.cuh), and so does out_u when the columns are split.
#include "stripe.cuh"

// Returns cudaGetLastError() of the launches (0 on success); r > 256 takes
// the cluster kernel with `slices` blocks of rank slices of `slice`, or
// with slices == 0 the chunks of 256 (stripe.cuh's stripe_entry).  partial
// holds 2 * E * ceil(M / 64) * splits floats (times slices on the cluster
// route), u_partial splits * E * M * r when splits > 1.
extern "C" int repro_huber_contract_u_diag(const float* u, const float* v,
                                           const void* m, const void* w,
                                           const float* lam, float* out_u,
                                           float* obj, float* psi2,
                                           float* partial, float* u_partial,
                                           int E, int M, int N, int r,
                                           int dtype, int mask, int splits,
                                           int cols_per_split, int slices,
                                           int slice, void* stream) {
  return repro::stripe_entry<true, false>(
      u, v, m, w, lam, out_u, nullptr, obj, psi2, partial, u_partial,
      nullptr, E, M, N, r, dtype, mask, splits, cols_per_split, 1, 0, slices,
      slice, stream);
}

// The most clusters of `cluster` blocks of the cluster kernel (rank slices
// of `slice`) resident at once on the current device
// (cudaOccupancyMaxActiveClusters), or -1 on an error: one block an SM
// whatever the flavour, so this flavour's count is the three's.
extern "C" int repro_stripe_cluster_slots(int cluster, int slice) {
  return repro::stripe_cluster_slots<true, false>(cluster, slice);
}
