// huber_dual_contract: both contractions of one DCF-PCA local iteration and
// the round diagnostics from one pass over M, batched over a leading client
// axis E, fp32 on the CUDA cores.
//
//   out_v[e] = Psi^T U (n, r),  out_u[e] = Psi V (m, r),
//   obj[e] = sum H_lam(R_W),  psi2[e] = sum Psi^2,
//   R_W = W * (M - U V^T),  Psi = clip(R_W, +-lam)
//   (W = 1 without a mask; M fp32 or bf16; W dense or packed)
//
//   replaces _make_dual_kernel(with_v=True) (:341, via _dual_call :403)
//   behind repro/kernels/huber_contract.py::huber_dual_contract (:481) and
//   huber_dual_contract_masked (:502, dense or packed W).
//
// What bounds it on an H100: fp32 arithmetic, 6r FLOP per residual entry
// (U V^T once per tile, then both contractions from the same Psi tile),
// 6 E m n r in all.  The TPU kernel kept out_v resident in VMEM across a
// sequential grid (two passes past 4 MiB of it); here blocks run in no
// order, so out_u completes inside each row-stripe block's column range
// (summed over the column splits) and out_v inside a row group: a
// thread-block cluster of up to 8 stripes whose blocks add their shares in
// distributed shared memory (stripe.cuh), the groups' planes within 4 MiB
// (kernels/huber_contract.py::dual_plan; past that the wrapper takes the
// reference's two passes, huber_contract_v and huber_contract_u_diag); a
// second launch adds the groups' planes in index order (reduce.cuh).  The design is stripe.cuh's with
// both contractions: 4 x 4 U V^T patches, 2-row (Psi V) and 2-column
// (Psi^T U) x RQ contraction blocks read as float4, a cp.async ring of V
// tiles.  One launch sequence always: there is no two-pass route.
#include "stripe.cuh"

// Returns cudaGetLastError() of the launches (0 on success); r > 256 takes
// the cluster kernel with `slices` blocks of rank slices of `slice`, or
// with slices == 0 the chunks of 256 (stripe.cuh's stripe_entry).
// diag_partial holds 2 * E * ceil(M / 64) * splits floats (times slices on
// the cluster route), u_partial splits * E * M * r when splits > 1,
// v_partial groups * E * N * r when groups > 1 (unused otherwise: out_v is
// written directly); the row groups are `groups` clusters of `cluster`
// stripes.
extern "C" int repro_huber_dual_contract(const float* u, const float* v,
                                         const void* m, const void* w,
                                         const float* lam, float* out_v,
                                         float* out_u, float* obj,
                                         float* psi2, float* diag_partial,
                                         float* u_partial, float* v_partial,
                                         int E, int M, int N, int r,
                                         int dtype, int mask, int splits,
                                         int cols_per_split, int cluster,
                                         int groups, int slices, int slice,
                                         void* stream) {
  return repro::stripe_entry<true, true>(
      u, v, m, w, lam, out_u, out_v, obj, psi2, diag_partial, u_partial,
      v_partial, E, M, N, r, dtype, mask, splits, cols_per_split, cluster,
      groups, slices, slice, stream);
}
