// Fixed-order second passes over per-block partial sums.  Blocks on the card
// run in no order, so a sum that spans blocks is written as partials by the
// first launch and added here in index order: the result is the same bits
// on every run, with no atomics.  Each source that includes this header is
// its own library, so the kernels are defined here once per library.
#pragma once

#include <algorithm>

#include <cuda_runtime.h>

namespace repro {

// out[idx] = sum_s partial[s, idx], s = 0 .. splits-1 in order.
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

inline cudaError_t launch_sum_splits(const float* partial, float* out,
                                     size_t count, int splits,
                                     cudaStream_t stream) {
  const int blocks =
      static_cast<int>(std::min<size_t>((count + 255) / 256, 4096));
  sum_splits_kernel<<<blocks, 256, 0, stream>>>(partial, out, count, splits);
  return cudaGetLastError();
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

inline cudaError_t launch_sum_diag(const float* partial, float* obj,
                                   float* psi2, int E, int tiles,
                                   cudaStream_t stream) {
  sum_diag_kernel<<<(E + 127) / 128, 128, 0, stream>>>(partial, obj, psi2, E,
                                                        tiles);
  return cudaGetLastError();
}

}  // namespace repro
