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
// What bounds it on an H100, and the design: stripe.cuh (the row-stripe
// kernel with diagnostics, without out_v).  The two scalars go through
// per-block partials and a fixed-order second launch (reduce.cuh).
#include "stripe.cuh"

// Returns cudaGetLastError() of the launches (0 on success).  partial holds
// 2 * E * ceil(M / 32) floats.
extern "C" int repro_huber_contract_u_diag(const float* u, const float* v,
                                           const void* m, const void* w,
                                           const float* lam, float* out_u,
                                           float* obj, float* psi2,
                                           float* partial, int E, int M,
                                           int N, int r, int dtype, int mask,
                                           void* stream) {
  return repro::dispatch(r, dtype, mask, [&](auto rq, auto tm, auto mk) {
    using TM = typename decltype(tm)::type;
    return repro::launch_stripe<decltype(rq)::value, TM, decltype(mk)::value,
                                true, false>(
        u, v, static_cast<const TM*>(m), w, lam, out_u, nullptr, obj, psi2,
        partial, nullptr, E, M, N, r, static_cast<cudaStream_t>(stream));
  });
}
