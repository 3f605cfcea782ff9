// Fixed-order second passes over per-block partial sums.  Blocks on the card
// run in no order, so a sum that spans blocks is written as partials by the
// first launch and added here in index order: the result is the same bits
// on every run, with no atomics.  Each source that includes this header is
// its own library, so the kernel is defined here once per library.
#pragma once

#include <algorithm>

#include <cuda_runtime.h>

namespace repro {

// out[idx] = sum_k partial[idx * istride + k * kstride], k = 0 .. terms-1
// in order, for idx < count.
struct SumJob {
  const float* partial;
  float* out;
  size_t count, istride, kstride;
  int terms;
};

// Up to four sums in one launch: grid (blocks, jobs), blockIdx.y the job.
constexpr int kMaxSumJobs = 4;
struct SumJobs {
  SumJob job[kMaxSumJobs];
  int n;
};

__global__ void sum_partials_kernel(SumJobs jobs) {
  const int y = blockIdx.y;
  const SumJob jb = y == 0 ? jobs.job[0]
                  : y == 1 ? jobs.job[1]
                  : y == 2 ? jobs.job[2]
                           : jobs.job[3];
  for (size_t idx = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       idx < jb.count; idx += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const float* p = jb.partial + idx * jb.istride;
    float s = 0.f;
    for (int k = 0; k < jb.terms; ++k) s += p[k * jb.kstride];
    jb.out[idx] = s;
  }
}

inline cudaError_t launch_sums(const SumJobs& jobs, cudaStream_t stream) {
  if (jobs.n < 1 || jobs.n > kMaxSumJobs) return cudaErrorInvalidValue;
  size_t most = 0;
  for (int j = 0; j < jobs.n; ++j) most = std::max(most, jobs.job[j].count);
  const int blocks = static_cast<int>(std::min<size_t>((most + 255) / 256, 4096));
  sum_partials_kernel<<<dim3(blocks, jobs.n), 256, 0, stream>>>(jobs);
  return cudaGetLastError();
}

// The job out[idx] = sum_s partial[s, idx] over a (splits, count) plane.
inline SumJob sum_over_splits(const float* partial, float* out, size_t count,
                              int splits) {
  return SumJob{partial, out, count, 1, count, splits};
}

inline cudaError_t launch_sum_splits(const float* partial, float* out,
                                     size_t count, int splits,
                                     cudaStream_t stream) {
  SumJobs jobs{};
  jobs.job[0] = sum_over_splits(partial, out, count, splits);
  jobs.n = 1;
  return launch_sums(jobs, stream);
}

}  // namespace repro
