// FMA-rate probes: pure FFMA, the contraction's and the patch's inner loops
// from shared memory, at 8 warps an SM.  "contr c44" is the 4-column x 4
// rank-group block of csrc/contract_v.cu's cluster kernel, "patch" the 4 x 4
// U V^T patch of csrc/tile64.cuh (patch44), each over a 64-row tile of 256
// ranks; "patch88" and "patch84" are 8 x 8 and 8 x 4 patches of 128-thread
// blocks over a 32-rank slab (csrc/shrink.cu's shrink_stream_kernel: rows
// ti + 16 a, columns tj + 8 b, 16 and 12 float4 loads for 256 and 128
// FFMAs a 4-rank step), two blocks an SM (8 warps) and one (4 warps) for
// the 8 x 8, two and three (12 warps) for the 8 x 4.  A line gives the share of the SM sub-partitions' FFMA
// issue slots used and the SM clock over the run.  On a card:
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
// A PA x PB patch: rows ti + 16 a of a (16 PA)-row U slab against rows
// tj + 8 b of an (8 PB)-row V slab, both 32 ranks wide (stride 36 floats),
// each thread of a 128-thread block (ti = warp * 4 + lane / 8, tj = lane % 8).
// MIX = 1 multiplies each U component by V's other component of its pair
// (x by y, z by w: not the product, the same instructions with the two
// factors in registers of unlike parity).  The empty asm keeps the
// compiler from hoisting the slab's loads out of the repetitions.
constexpr int SLAB_LD = 36;
template <int PA, int PB, int MINB, int MIX = 0>
__global__ void __launch_bounds__(128, MINB) patch_slab(float* out, int reps,
                                                        long long* cyc) {
  extern __shared__ float4 sm4[];
  float* Us = reinterpret_cast<float*>(sm4);
  float* Vs = Us + 16 * PA * SLAB_LD;
  for (int i = threadIdx.x; i < (16 * PA + 8 * PB) * SLAB_LD; i += blockDim.x) Us[i] = (i % 89) * 1e-3f;
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ti = warp * 4 + (lane >> 3), tj = lane & 7;
  float low[PA][PB] = {};
  long long t0 = clock64();
  for (int rep = 0; rep < reps; ++rep) {
    asm volatile("" ::: "memory");
#pragma unroll
    for (int kq = 0; kq < 8; ++kq) {
      float4 ua[PA], vb[PB];
#pragma unroll
      for (int a = 0; a < PA; ++a) ua[a] = *reinterpret_cast<const float4*>(Us + (ti + 16 * a) * SLAB_LD + 4 * kq);
#pragma unroll
      for (int b = 0; b < PB; ++b) vb[b] = *reinterpret_cast<const float4*>(Vs + (tj + 8 * b) * SLAB_LD + 4 * kq);
#pragma unroll
      for (int a = 0; a < PA; ++a)
#pragma unroll
        for (int b = 0; b < PB; ++b) {
          float l = low[a][b];
          if (MIX) {
            l = fmaf(ua[a].x, vb[b].y, l); l = fmaf(ua[a].y, vb[b].x, l);
            l = fmaf(ua[a].z, vb[b].w, l); l = fmaf(ua[a].w, vb[b].z, l);
          } else {
            l = fmaf(ua[a].x, vb[b].x, l); l = fmaf(ua[a].y, vb[b].y, l);
            l = fmaf(ua[a].z, vb[b].z, l); l = fmaf(ua[a].w, vb[b].w, l);
          }
          low[a][b] = l;
        }
    }
  }
  long long t1 = clock64();
  float s = 0;
#pragma unroll
  for (int a = 0; a < PA; ++a)
#pragma unroll
    for (int b = 0; b < PB; ++b) s += low[a][b];  // unrolled: no local array
  if (s == 1234.5f) out[0] = s;
  if (threadIdx.x == 0 && blockIdx.x == 0) *cyc = t1 - t0;
}
// The 8 x 8 patch as rank-major outer products: a slab stored rank by rank
// (32 ranks of 128 U rows, then of 64 V rows, stride 132 / 68 floats), each
// thread's rows 4 ti .. 4 ti + 3 and 64 + 4 ti .., columns 4 tj .. and
// 32 + 4 tj .. (ti = warp * 4 + lane / 8, tj = lane % 8): 4 float4 loads
// and 64 FFMAs a rank.
constexpr int KM_LDU = 132, KM_LDV = 68;
__global__ void __launch_bounds__(128, 2) outer_slab(float* out, int reps,
                                                     long long* cyc) {
  extern __shared__ float4 sm4[];
  float* Us = reinterpret_cast<float*>(sm4);
  float* Vs = Us + 32 * KM_LDU;
  for (int i = threadIdx.x; i < 32 * (KM_LDU + KM_LDV); i += blockDim.x) Us[i] = (i % 89) * 1e-3f;
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ti = warp * 4 + (lane >> 3), tj = lane & 7;
  float low[8][8] = {};
  long long t0 = clock64();
  for (int rep = 0; rep < reps; ++rep) {
    asm volatile("" ::: "memory");
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const float4 u0 = *reinterpret_cast<const float4*>(Us + k * KM_LDU + 4 * ti);
      const float4 u1 = *reinterpret_cast<const float4*>(Us + k * KM_LDU + 64 + 4 * ti);
      const float4 v0 = *reinterpret_cast<const float4*>(Vs + k * KM_LDV + 4 * tj);
      const float4 v1 = *reinterpret_cast<const float4*>(Vs + k * KM_LDV + 32 + 4 * tj);
      const float ua[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
      const float vb[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) low[a][b] = fmaf(ua[a], vb[b], low[a][b]);
    }
  }
  long long t1 = clock64();
  float s = 0;
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) s += low[a][b];
  if (s == 1234.5f) out[0] = s;
  if (threadIdx.x == 0 && blockIdx.x == 0) *cyc = t1 - t0;
}
// `blocks` blocks an SM run side by side (132 of them a block), each timing
// the loop on its own clock.
template <class F>
void run(const char* name, F launch, double ffma_per_thread, int threads,
         int blocks = 1) {
  float* out; long long* cyc; cudaMalloc(&out, 64); cudaMalloc(&cyc, 8);
  cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
  launch(out, cyc); cudaDeviceSynchronize();
  cudaEventRecord(a); launch(out, cyc); cudaEventRecord(b); cudaEventSynchronize(b);
  float ms; cudaEventElapsedTime(&ms, a, b); long long c; cudaMemcpy(&c, cyc, 8, cudaMemcpyDeviceToHost);
  double warp_ffma_per_smsp = ffma_per_thread * blocks * (threads / 32) / 4.0;
  printf("%-14s warps/SM %3d  FFMA issue share %.3f  clock %.3f GHz  ms %.3f  err %s\n", name, blocks * threads / 32,
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
  const int sm88 = (128 + 64) * SLAB_LD * 4, sm84 = (128 + 32) * SLAB_LD * 4, slab_reps = 8 * reps;
  const int smo = 32 * (KM_LDU + KM_LDV) * 4;
  cudaFuncSetAttribute(patch_slab<8, 8, 2>, cudaFuncAttributeMaxDynamicSharedMemorySize, sm88);
  cudaFuncSetAttribute(patch_slab<8, 8, 2, 1>, cudaFuncAttributeMaxDynamicSharedMemorySize, sm88);
  cudaFuncSetAttribute(patch_slab<8, 4, 2>, cudaFuncAttributeMaxDynamicSharedMemorySize, sm84);
  cudaFuncSetAttribute(patch_slab<8, 4, 3>, cudaFuncAttributeMaxDynamicSharedMemorySize, sm84);
  cudaFuncSetAttribute(outer_slab, cudaFuncAttributeMaxDynamicSharedMemorySize, smo);
  run("patch88 x1", [&](float* o, long long* c) { patch_slab<8, 8, 2><<<132, 128, sm88>>>(o, slab_reps, c); }, 8.0 * 256 * slab_reps, 128, 1);
  run("patch88", [&](float* o, long long* c) { patch_slab<8, 8, 2><<<2 * 132, 128, sm88>>>(o, slab_reps, c); }, 8.0 * 256 * slab_reps, 128, 2);
  run("patch88 mix", [&](float* o, long long* c) { patch_slab<8, 8, 2, 1><<<2 * 132, 128, sm88>>>(o, slab_reps, c); }, 8.0 * 256 * slab_reps, 128, 2);
  run("patch84", [&](float* o, long long* c) { patch_slab<8, 4, 2><<<2 * 132, 128, sm84>>>(o, slab_reps, c); }, 8.0 * 128 * slab_reps, 128, 2);
  run("patch84 x3", [&](float* o, long long* c) { patch_slab<8, 4, 3><<<3 * 132, 128, sm84>>>(o, slab_reps, c); }, 8.0 * 128 * slab_reps, 128, 3);
  run("outer88", [&](float* o, long long* c) { outer_slab<<<2 * 132, 128, smo>>>(o, slab_reps, c); }, 32.0 * 64 * slab_reps, 128, 2);
  run("outer88 x1", [&](float* o, long long* c) { outer_slab<<<132, 128, smo>>>(o, slab_reps, c); }, 32.0 * 64 * slab_reps, 128, 1);
  return 0;
}
