// Shared pieces of the 64 x 64 fp32 residual-tile kernels on the CUDA cores
// (contract_v.cu, stripe.cuh and shrink.cu up to r = 256): factor slices
// staged by cp.async, and the 4 x 4 U V^T patch each of a block's 256
// threads computes.
//
// A staged slice holds 64 factor rows row-major, the rank axis padded with
// zeros to 32 RQ and the row stride 32 RQ + 4 floats (an odd number of
// 16-byte groups), so that the products read it as float4 along the rank
// axis without bank conflicts.  Zero padding is exact: a padded row or rank
// adds nothing to U V^T.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace repro {

constexpr int kT64 = 64;          // rows and columns of one residual tile
constexpr int kT64Threads = 256;  // threads a block (8 warps)

// Row stride (floats) of a staged factor slice.
template <int RQ>
__host__ __device__ constexpr int ld64() { return 32 * RQ + 4; }

// Whether two blocks of `bytes` dynamic shared memory each fit one SM
// (228 KB, of which every block reserves 1 KB).
__host__ __device__ constexpr bool two_blocks_fit(size_t bytes) {
  return 2 * (bytes + 1024) <= 233472;
}

// BYTES (4, 8 or 16) global -> shared; zeros when !valid (src is then not
// read).
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "n"(BYTES), "r"(valid ? BYTES : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage rows [row0, row0 + 64) of a (nrows, r) row-major factor into dst
// (64 x ld64<RQ>()) asynchronously in pieces of BYTES (r a multiple of
// BYTES / 4), zeros past nrows and past r.
template <int RQ, int BYTES>
__device__ __forceinline__ void stage_pieces(float* dst, const float* src,
                                             int row0, int nrows, int r) {
  constexpr int W = BYTES / 4;  // floats a piece
  constexpr int RP = 32 * RQ / W;
  constexpr int LD = ld64<RQ>();
  for (int idx = threadIdx.x; idx < kT64 * RP; idx += kT64Threads) {
    const int ii = idx / RP;
    const int k = (idx - ii * RP) * W;
    const int row = row0 + ii;
    const bool ok = row < nrows && k < r;
    cp_async<BYTES>(dst + ii * LD + k,
                    ok ? src + static_cast<size_t>(row) * r + k : src, ok);
  }
}

// The widest pieces that the rank and the factor's address allow: its rows
// are 16-byte aligned when r % 4 == 0 (8-byte when r is even) and the
// factor itself is.
template <int RQ>
__device__ __forceinline__ void stage_async(float* dst, const float* src,
                                            int row0, int nrows, int r) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(src);
  if (r % 4 == 0 && at % 16 == 0)
    stage_pieces<RQ, 16>(dst, src, row0, nrows, r);
  else if (r % 2 == 0 && at % 8 == 0)
    stage_pieces<RQ, 8>(dst, src, row0, nrows, r);
  else
    stage_pieces<RQ, 4>(dst, src, row0, nrows, r);
}

// Ranks above 2048 (the "chunked" kernels of contract_v.cu and
// stripe.cuh): the rank axis in chunks of kRankChunk, chunk c holding ranks
// [256 c, min(256 (c + 1), r)), each staged into a slice of
// ld64<kChunkRQ>() floats a row (the last one zero-padded).  Three slices of
// 66.5 KB and a Psi tile pass a block's 227 KB, so a block no longer keeps
// a factor's chunks staged side by side: it stages one chunk of U and one
// of V at a time.  Every residual entry sums the chunks' patches in one
// fixed order, low = ((low(c0) + low(c1)) + low(c2)) + ..., each patch in
// rank order from zero (fp32 addition is not associative, so with three
// terms no block may take its own chunk first).
constexpr int kRankChunk = 256;
constexpr int kChunkRQ = kRankChunk / 32;
__host__ __device__ constexpr int rank_chunks(int r) {
  return (r + kRankChunk - 1) / kRankChunk;
}

// Ranks 257 .. 2048 (the "cluster" kernels: contract_v.cu, stripe.cuh):
// the rank axis cut into slices over a thread-block cluster of up to 8
// blocks, block c holding ranks [c slice, min((c + 1) slice, r)).  Each
// block forms its slice's partial U V^T patch in rank order from zero and
// the cluster adds the partials in slice order, ((p0 + p1) + p2) + ...,
// so slices of 256 sum as the chunks above do.
constexpr int kSliceMax = 256;   // widest slice: 32 RQ ranks at RQ = 8
constexpr int kClusterMax = 8;   // blocks a cluster (portable on Hopper)
constexpr int kClusterMinRQ = 5; // slices of r > 256 over <= 8 blocks
                                 // are at least 129 ranks wide

// Dynamic shared memory of one block of a cluster kernel at RQ = ceil(slice
// / 32): one factor's slice resident and two stages of the other's (64 rows
// of ld64<RQ>() floats each), then a 64 x 64 partial and a 64 x 64 Psi,
// both unpadded (XOR-swizzled against bank conflicts instead).
template <int RQ>
__host__ __device__ constexpr size_t cluster_smem_bytes() {
  return sizeof(float) * (3 * kT64 * ld64<RQ>() + 2 * kT64 * kT64);
}
static_assert(cluster_smem_bytes<8>() == 232448,
              "a cluster block takes exactly the 227 KB an H100 block may");

// Whether (cluster, slice) cut r into slices as the cluster kernels take
// them: slice a multiple of 4 (so every slice but the last holds whole
// 4-rank groups and starts 16-byte aligned), none wider than kSliceMax,
// the last one not empty.
__host__ __device__ inline bool slices_valid(int r, int cluster, int slice) {
  return cluster >= 1 && cluster <= kClusterMax && slice >= 4 &&
         slice <= kSliceMax && slice % 4 == 0 &&
         (cluster - 1) * slice < r && r <= cluster * slice;
}

// Stage rows [row0, row0 + 64) of ranks [k0, k0 + kw) of a (nrows, r)
// row-major factor into dst (64 x ld64<RQ>()) by cp.async in the widest
// pieces r and the factor's address allow, up to kw rounded up to 4
// (zeros past kw and past nrows); the columns beyond stay as they are.
template <int RQ, int BYTES>
__device__ __forceinline__ void stage_slice_pieces(float* dst,
                                                   const float* src,
                                                   int row0, int nrows,
                                                   int r, int k0, int kw) {
  constexpr int W = BYTES / 4;
  constexpr int LD = ld64<RQ>();
  const int rp = ((kw + 3) & ~3) / W;  // pieces a row
  for (int idx = threadIdx.x; idx < kT64 * rp; idx += kT64Threads) {
    const int ii = idx / rp;
    const int k = (idx - ii * rp) * W;
    const int row = row0 + ii;
    const bool ok = row < nrows && k < kw;
    cp_async<BYTES>(dst + ii * LD + k,
                    ok ? src + static_cast<size_t>(row) * r + k0 + k : src,
                    ok);
  }
}

template <int RQ>
__device__ __forceinline__ void stage_slice(float* dst, const float* src,
                                            int row0, int nrows, int r,
                                            int k0, int kw) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(src);
  if (r % 4 == 0 && at % 16 == 0)
    stage_slice_pieces<RQ, 16>(dst, src, row0, nrows, r, k0, kw);
  else if (r % 2 == 0 && at % 8 == 0)
    stage_slice_pieces<RQ, 8>(dst, src, row0, nrows, r, k0, kw);
  else
    stage_slice_pieces<RQ, 4>(dst, src, row0, nrows, r, k0, kw);
}

// The launch configuration of a cluster kernel: clusters of `cluster`
// blocks along x, kT64Threads threads and `smem` bytes of dynamic shared
// memory a block; attr (one attribute, at least) must outlive it.
inline cudaLaunchConfig_t cluster_launch_config(cudaLaunchAttribute* attr,
                                                dim3 grid, int cluster,
                                                size_t smem,
                                                cudaStream_t stream) {
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(kT64Threads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return config;
}

// The most clusters of `cluster` blocks of `kernel` (`smem` bytes of dynamic
// shared memory a block) resident at once on the current device
// (cudaOccupancyMaxActiveClusters), or -1 on an error.
template <typename Kernel>
int max_active_clusters(Kernel kernel, size_t smem, int cluster) {
  if (cluster < 1 || cluster > kClusterMax ||
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return -1;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t config =
      cluster_launch_config(attr, dim3(cluster), cluster, smem, nullptr);
  int slots = -1;
  return cudaOccupancyMaxActiveClusters(&slots, kernel, &config) ==
                 cudaSuccess
             ? slots
             : -1;
}

// Zero columns [4 w4, ld64<RQ>()) of `rows` consecutive staged rows at dst:
// the register blocks of the cluster kernels' contractions read 32 RQ
// ranks, past a slice's 4-rank groups, into columns never written out.
template <int RQ>
__device__ __forceinline__ void zero_past_slice(float* dst, int rows,
                                                int w4) {
  constexpr int LD = ld64<RQ>();
  const int pad = LD - 4 * w4;
  for (int idx = threadIdx.x; idx < rows * pad; idx += kT64Threads) {
    const int row = idx / pad;
    dst[row * LD + 4 * w4 + (idx - row * pad)] = 0.f;
  }
}

// Stage rows [row0, row0 + 64) of ranks [k0, k0 + kw) of a (nrows, r)
// row-major factor into dst (64 x ld64<RQ>()) in pieces of BYTES (r and k0
// multiples of BYTES / 4), zeros past nrows and past kw.
template <int RQ, int BYTES>
__device__ __forceinline__ void stage_window_pieces(float* dst,
                                                    const float* src,
                                                    int row0, int nrows,
                                                    int r, int k0, int kw) {
  constexpr int W = BYTES / 4;
  constexpr int RP = 32 * RQ / W;
  constexpr int LD = ld64<RQ>();
  for (int idx = threadIdx.x; idx < kT64 * RP; idx += kT64Threads) {
    const int ii = idx / RP;
    const int k = (idx - ii * RP) * W;
    const int row = row0 + ii;
    const bool ok = row < nrows && k < kw;
    cp_async<BYTES>(dst + ii * LD + k,
                    ok ? src + static_cast<size_t>(row) * r + k0 + k : src,
                    ok);
  }
}

// stage_async for the rank window [k0, k0 + kw): k0 is a multiple of 32,
// so the widest pieces are those of the whole rows.
template <int RQ>
__device__ __forceinline__ void stage_window(float* dst, const float* src,
                                             int row0, int nrows, int r,
                                             int k0, int kw) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(src);
  if (r % 4 == 0 && at % 16 == 0)
    stage_window_pieces<RQ, 16>(dst, src, row0, nrows, r, k0, kw);
  else if (r % 2 == 0 && at % 8 == 0)
    stage_window_pieces<RQ, 8>(dst, src, row0, nrows, r, k0, kw);
  else
    stage_window_pieces<RQ, 4>(dst, src, row0, nrows, r, k0, kw);
}

// Adds ranks 4 kq .. 4 kq + 3 to this thread's 4 x 4 patch `low` of Us
// Vs^T: rows ti + 16 a of the U slice against rows tj + 16 b of the V
// slice.  8 float4 loads feed 64 FMAs; with ti = (warp / 2) * 4 + lane / 8
// and tj = (warp % 2) * 8 + lane % 8, a warp reads 4 distinct U rows and 8
// distinct V rows.
template <int RQ>
__device__ __forceinline__ void patch44_step(const float* Us, const float* Vs,
                                             int ti, int tj, int kq,
                                             float low[4][4]) {
  constexpr int LD = ld64<RQ>();
  float4 ua[4], vb[4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
    ua[a] = *reinterpret_cast<const float4*>(Us + (ti + 16 * a) * LD +
                                             4 * kq);
#pragma unroll
  for (int b = 0; b < 4; ++b)
    vb[b] = *reinterpret_cast<const float4*>(Vs + (tj + 16 * b) * LD +
                                             4 * kq);
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      float l = low[a][b];
      l = fmaf(ua[a].x, vb[b].x, l);
      l = fmaf(ua[a].y, vb[b].y, l);
      l = fmaf(ua[a].z, vb[b].z, l);
      l = fmaf(ua[a].w, vb[b].w, l);
      low[a][b] = l;
    }
}

// This thread's 4 x 4 patch of Us Vs^T, summed over k = 0 .. 4 r4 - 1 in
// order; UNROLL > 1 unrolls the rank loop that many times (1 leaves it to
// the compiler).
template <int RQ, int UNROLL = 1>
__device__ __forceinline__ void patch44(const float* Us, const float* Vs,
                                        int ti, int tj, int r4,
                                        float low[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) low[a][b] = 0.f;
  if constexpr (UNROLL == 1) {
    for (int kq = 0; kq < r4; ++kq) patch44_step<RQ>(Us, Vs, ti, tj, kq, low);
  } else {
#pragma unroll UNROLL
    for (int kq = 0; kq < r4; ++kq) patch44_step<RQ>(Us, Vs, ti, tj, kq, low);
  }
}


// low = the residual tile's U V^T patch summed over the rank chunks of 256
// in order (above): for each chunk, U's rows [i0, i0 + 64) and V's rows
// [j0, j0 + 64) of that chunk are staged into Us and Vs (64 x
// ld64<kChunkRQ>() each) and the chunk's patch added (its rank loop
// unrolled UNROLL times, as patch44's).  Callers must have no copies in
// flight and be done with Us and Vs (a barrier).  Ends after a barrier,
// with the last chunk still staged and nobody reading it.
template <int UNROLL = 1>
__device__ __forceinline__ void chunked_low(float* Us, float* Vs,
                                            const float* ue, const float* ve,
                                            int i0, int M, int j0, int N,
                                            int r, int ti, int tj,
                                            float low[4][4]) {
  const int chunks = rank_chunks(r);
  for (int k = 0; k < chunks; ++k) {
    const int k0 = k * kRankChunk;
    const int kw = min(kRankChunk, r - k0);
    if (k > 0) __syncthreads();  // nobody reads the last chunk any more
    stage_window<kChunkRQ>(Us, ue, i0, M, r, k0, kw);
    stage_window<kChunkRQ>(Vs, ve, j0, N, r, k0, kw);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    if (k == 0) {
      patch44<kChunkRQ, UNROLL>(Us, Vs, ti, tj, (kw + 3) / 4, low);
    } else {
      float lk[4][4];
      patch44<kChunkRQ, UNROLL>(Us, Vs, ti, tj, (kw + 3) / 4, lk);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) low[a][b] += lk[a][b];
    }
  }
  __syncthreads();
}

}  // namespace repro
