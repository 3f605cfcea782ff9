// Shared-memory wavefront probe: cycles per warp-wide ld.shared of 128, 64
// and 32 bits for several address patterns (32 warps an SM, SM cycles per
// warp-wide load over the run).  "4addr x8lanes" is the pattern of the U
// loads of tile64.cuh's patch44, "8addr x4lanes" that of its V loads.  On a
// card:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 \
//       -o build/smem_probe tools/cuda_probes/smem_probe.cu && build/smem_probe
#include <cstdio>
#include <cstdint>
#include <cuda_runtime.h>
__device__ __forceinline__ float4 lds128(uint32_t a) { float4 x;
  asm volatile("ld.shared.v4.f32 {%0,%1,%2,%3}, [%4];" : "=f"(x.x),"=f"(x.y),"=f"(x.z),"=f"(x.w) : "r"(a)); return x; }
__device__ __forceinline__ float2 lds64(uint32_t a) { float2 x;
  asm volatile("ld.shared.v2.f32 {%0,%1}, [%2];" : "=f"(x.x),"=f"(x.y) : "r"(a)); return x; }
__device__ __forceinline__ float lds32(uint32_t a) { float x;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(x) : "r"(a)); return x; }
template <int BITS>
__global__ void probe(float* out, int iters, int mode, long long* cyc) {
  __shared__ __align__(16) float s[8192];
  for (int i = threadIdx.x; i < 8192; i += blockDim.x) s[i] = i * 1e-3f;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  int off;  // byte offset a lane reads
  const int W = BITS / 8;
  switch (mode) {
    case 0: off = (lane >> 3) * (W + 16); break;   // 4 distinct, 8 lanes each (patch U)
    case 1: off = (lane & 7) * W; break;           // 8 distinct, 4 lanes each (contraction U)
    case 2: off = lane * W; break;                 // 32 distinct, consecutive
    case 3: off = 0; break;                        // one address
    default: off = (lane >> 3) * (W + 16) + 0; break;
  }
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(s)) + off;
  float acc = 0.f;
  long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
    const uint32_t a = base + ((i & 7) << 9);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (BITS == 128) { float4 x = lds128(a + (j << 6)); acc += x.x + x.w; }
      else if (BITS == 64) { float2 x = lds64(a + (j << 6)); acc += x.x + x.y; }
      else { acc += lds32(a + (j << 6)); }
    }
  }
  long long t1 = clock64();
  if (threadIdx.x == 0 && blockIdx.x == 0) *cyc = t1 - t0;
  if (acc == 12345.f) out[threadIdx.x] = acc;
}
int main() {
  float* out; long long* cyc; cudaMalloc(&out, 4096); cudaMalloc(&cyc, 8);
  const int iters = 4096;
  const char* names[] = {"4addr x8lanes", "8addr x4lanes", "32 distinct", "1 addr"};
  for (int bits : {128, 64, 32}) for (int mode = 0; mode < 4; ++mode) {
    cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
    auto launch = [&]() {
      if (bits == 128) probe<128><<<132, 1024>>>(out, iters, mode, cyc);
      else if (bits == 64) probe<64><<<132, 1024>>>(out, iters, mode, cyc);
      else probe<32><<<132, 1024>>>(out, iters, mode, cyc);
    };
    launch(); cudaEventRecord(a); launch(); cudaEventRecord(b); cudaEventSynchronize(b);
    float ms; cudaEventElapsedTime(&ms, a, b); long long c; cudaMemcpy(&c, cyc, 8, cudaMemcpyDeviceToHost);
    // loads per SM: 32 warps x iters x 8
    double loads = 32.0 * iters * 8;
    printf("bits %3d %-16s SM cycles per warp-load %.3f  ms %.3f\n", bits, names[mode], (double)c / loads, ms);
  }
  return 0;
}
