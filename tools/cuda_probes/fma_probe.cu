// FMA-rate probes: pure FFMA, the contraction's and the patch's inner loops
// from shared memory, at 8 warps an SM.  "contr c44" is the 4-column x 4
// rank-group block of csrc/contract_v.cu's cluster kernel, "patch" the 4 x 4
// U V^T patch of csrc/tile64.cuh (patch44), each over a 64-row tile of 256
// ranks; a line gives the share of the SM sub-partitions' FFMA issue slots
// used and the SM clock over the run.  On a card:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//       -o build/fma_probe tools/cuda_probes/fma_probe.cu && build/fma_probe
#include <cstdio>
#include <cuda_runtime.h>
__global__ void ffma(float* out, int iters, long long* cyc) {
  float a[16];
  for (int i = 0; i < 16; ++i) a[i] = threadIdx.x * 1e-3f + i;
  const float x = 1.0001f, y = 1e-4f;
  long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int i = 0; i < 16; ++i) a[i] = fmaf(a[i], x, y);
  }
  long long t1 = clock64();
  float s = 0; for (int i = 0; i < 16; ++i) s += a[i];
  if (s == 1234.5f) out[0] = s;
  if (threadIdx.x == 0 && blockIdx.x == 0) *cyc = t1 - t0;
}
constexpr int LD = 260;
// contraction c44: per ii one float4 of Psi (4 cols) and 4 float4 of U
__global__ void contr(float* out, int reps, long long* cyc) {
  extern __shared__ float4 sm4[];
  float* Us = reinterpret_cast<float*>(sm4);
  float* Ps = Us + 64 * LD;
  for (int i = threadIdx.x; i < 64 * LD + 64 * 64; i += blockDim.x) Us[i] = (i % 97) * 1e-3f;
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cq = (warp & 1) * 8 + (lane >> 2), kl = (warp >> 1) * 4 + (lane & 3);
  float acc[4][4][4] = {};
  long long t0 = clock64();
  for (int rep = 0; rep < reps; ++rep) {
    for (int ii = 0; ii < 64; ++ii) {
      const float4 p = *reinterpret_cast<const float4*>(Ps + ii * 64 + ((4 * cq) ^ ((ii & 3) << 3)));
      const float* urow = Us + ii * LD;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 uq = *reinterpret_cast<const float4*>(urow + 4 * (kl + 16 * q));
        const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[c][q][0] = fmaf(pv[c], uq.x, acc[c][q][0]);
          acc[c][q][1] = fmaf(pv[c], uq.y, acc[c][q][1]);
          acc[c][q][2] = fmaf(pv[c], uq.z, acc[c][q][2]);
          acc[c][q][3] = fmaf(pv[c], uq.w, acc[c][q][3]);
        }
      }
    }
  }
  long long t1 = clock64();
  float s = 0;
  for (int c = 0; c < 4; ++c) for (int q = 0; q < 4; ++q) for (int k = 0; k < 4; ++k) s += acc[c][q][k];
  if (s == 1234.5f) out[0] = s;
  if (threadIdx.x == 0 && blockIdx.x == 0) *cyc = t1 - t0;
}
// patch 4x4 from U (64 x LD) and V (64 x LD) rows, 64 rank groups
template <int UNR>
__global__ void patch(float* out, int reps, long long* cyc) {
  extern __shared__ float4 sm4[];
  float* Us = reinterpret_cast<float*>(sm4);
  float* Vs = Us + 64 * LD;
  for (int i = threadIdx.x; i < 2 * 64 * LD; i += blockDim.x) Us[i] = (i % 89) * 1e-3f;
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ti = (warp >> 1) * 4 + (lane >> 3), tj = (warp & 1) * 8 + (lane & 7);
  float low[4][4] = {};
  long long t0 = clock64();
  for (int rep = 0; rep < reps; ++rep) {
#pragma unroll UNR
    for (int kq = 0; kq < 64; ++kq) {
      float4 ua[4], vb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) ua[a] = *reinterpret_cast<const float4*>(Us + (ti + 16 * a) * LD + 4 * kq);
#pragma unroll
      for (int b = 0; b < 4; ++b) vb[b] = *reinterpret_cast<const float4*>(Vs + (tj + 16 * b) * LD + 4 * kq);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          float l = low[a][b];
          l = fmaf(ua[a].x, vb[b].x, l); l = fmaf(ua[a].y, vb[b].y, l);
          l = fmaf(ua[a].z, vb[b].z, l); l = fmaf(ua[a].w, vb[b].w, l);
          low[a][b] = l;
        }
    }
  }
  long long t1 = clock64();
  float s = 0; for (int a = 0; a < 4; ++a) for (int b = 0; b < 4; ++b) s += low[a][b];
  if (s == 1234.5f) out[0] = s;
  if (threadIdx.x == 0 && blockIdx.x == 0) *cyc = t1 - t0;
}
template <class F>
void run(const char* name, F launch, double ffma_per_thread, int threads) {
  float* out; long long* cyc; cudaMalloc(&out, 64); cudaMalloc(&cyc, 8);
  cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
  launch(out, cyc); cudaDeviceSynchronize();
  cudaEventRecord(a); launch(out, cyc); cudaEventRecord(b); cudaEventSynchronize(b);
  float ms; cudaEventElapsedTime(&ms, a, b); long long c; cudaMemcpy(&c, cyc, 8, cudaMemcpyDeviceToHost);
  double warp_ffma_per_smsp = ffma_per_thread * (threads / 32) / 4.0;
  printf("%-14s threads %4d  FFMA issue share %.3f  clock %.3f GHz  ms %.3f  err %s\n", name, threads,
         warp_ffma_per_smsp / c, c / (ms * 1e6), ms, cudaGetErrorString(cudaGetLastError()));
}
int main() {
  const int iters = 1 << 15, reps = 512;
  for (int threads : {256, 1024})
    run("ffma", [&](float* o, long long* c) { ffma<<<132, threads>>>(o, iters, c); }, 64.0 * iters, threads);
  const int smc = (64 * LD + 64 * 64) * 4, smp = 2 * 64 * LD * 4;
  cudaFuncSetAttribute(contr, cudaFuncAttributeMaxDynamicSharedMemorySize, smc);
  cudaFuncSetAttribute(patch<1>, cudaFuncAttributeMaxDynamicSharedMemorySize, smp);
  cudaFuncSetAttribute(patch<4>, cudaFuncAttributeMaxDynamicSharedMemorySize, smp);
  run("contr c44", [&](float* o, long long* c) { contr<<<132, 256, smc>>>(o, reps, c); }, 64.0 * 64 * reps, 256);
  run("patch", [&](float* o, long long* c) { patch<1><<<132, 256, smp>>>(o, reps, c); }, 64.0 * 64 * reps, 256);
  run("patch unroll4", [&](float* o, long long* c) { patch<4><<<132, 256, smp>>>(o, reps, c); }, 64.0 * 64 * reps, 256);
  return 0;
}
