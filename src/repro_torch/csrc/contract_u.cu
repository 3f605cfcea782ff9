// huber_contract_u: the U-step contraction of DCF-PCA under fused="off",
// batched over a leading client axis E, fp32 on the CUDA cores.
//
//   out_u[e, i, :] = sum_j Psi[e, i, j] V[e, j, :],  Psi = clip(W * R, +-lam),
//   R = M - U V^T  (W = 1 without a mask; M fp32 or bf16; W dense or packed)
//
//   replaces repro/kernels/huber_contract.py::_contract_u_kernel (:118),
//   _contract_u_masked_kernel (:133) and, with a packed W,
//   huber_contract_u_packed (:572, body _make_dual_kernel :341).
//
// What bounds it on an H100: fp32 arithmetic, 4r FLOP per residual entry
// (2r of U V^T, 2r of Psi V) against 2-4 bytes of M.  The design is
// stripe.cuh's without diagnostics and without out_v: 64-row stripes on a
// grid whose column splits fill the card at E = 1, 4 x 4 U V^T patches and
// 2-row x RQ Psi V blocks read as float4, a cp.async ring of V tiles.  It
// is huber_contract_u_diag with the diagnostics compiled out (the same
// splits and sums), so the two give the same out_u bits and fused="off"
// and fused="diag" the same factors.
// clip(W * R) equals the reference's W * clip(R) for a 0/1 W.
#include "stripe.cuh"

// Returns cudaGetLastError() of the launches (0 on success); r > 256 takes
// the cluster kernel with `slices` blocks of rank slices of `slice`, or
// with slices == 0 the chunks of 256 (stripe.cuh's stripe_entry).  m is
// fp32 or bf16 (dtype code), w null, dense or packed (mask code, tile.cuh);
// the splits' column ranges are whole 64-column tiles; u_partial holds
// splits * E * M * r floats when splits > 1 (unused otherwise).
extern "C" int repro_huber_contract_u(const float* u, const float* v,
                                      const void* m, const void* w,
                                      const float* lam, float* out_u,
                                      float* u_partial, int E, int M, int N,
                                      int r, int dtype, int mask, int splits,
                                      int cols_per_split, int slices,
                                      int slice, void* stream) {
  return repro::stripe_entry<false, false>(
      u, v, m, w, lam, out_u, nullptr, nullptr, nullptr, nullptr, u_partial,
      nullptr, E, M, N, r, dtype, mask, splits, cols_per_split, 1, 0, slices,
      slice, stream);
}
