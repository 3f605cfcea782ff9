// huber_contract_v: the inner-sweep contraction of DCF-PCA, batched over a
// leading client axis E, fp32 on the CUDA cores.
//
//   out[e, j, :] = sum_i Psi[e, i, j] U[e, i, :],  Psi = W * clip(R, +-lam),
//   R = M - U V^T  (W = 1 without a mask; M fp32 or bf16; W dense or packed)
//
//   replaces repro/kernels/huber_contract.py::_contract_v_kernel (:82),
//   _contract_v_masked_kernel (:97) and, with a packed W,
//   huber_contract_v_packed (:553, body _make_dual_kernel :341).
//
// What bounds it on an H100: fp32 arithmetic.  Each residual entry costs 2r
// FLOP for U V^T and 2r for the contraction against 4 bytes of M (2 in bf16,
// plus 4 or 1/8 of W), so at r = 64 it sits at >= 64 FLOP/byte, right of the
// fp32 ridge (67 TFLOP/s / 3.35 TB/s ~ 20 FLOP/byte).  The CUDA cores take
// one FMA instruction a clock per SM sub-partition, so the loops must issue
// little else (16-byte shared loads, each feeding many FMAs), and the loads
// and barriers of one block must sit under another block's FMAs.  No tensor
// cores and no TF32: the solver's recovery bar needs full fp32.
//
// The design, one SIMT micro-kernel for each of the two products:
//   - a block owns 64 columns (their V rows staged once) and walks its row
//     range in 64 x 64 residual tiles; 256 threads; two blocks share an SM
//     while both fit its shared memory (r <= 160);
//   - U and V rows are staged row-major by cp.async in the widest pieces the
//     rank allows (16 bytes when r % 4 == 0, 8 when r is even), the rank
//     axis padded to 32 RQ and the row stride to 32 RQ + 4 floats (an odd
//     number of 16-byte groups), so that both products read them as float4
//     along the rank axis without bank conflicts, and one staged copy of U
//     serves both;
//   - U V^T: each thread owns a 4 x 4 patch (rows ti + 16 a, columns tj +
//     16 b); per 4 ranks it loads 8 float4 for 64 FMAs, a warp's 4 x 8
//     threads reading 4 distinct U rows and 8 distinct V rows (the staging
//     and this patch are tile64.cuh's, shared with stripe.cuh);
//   - each thread's M (and W) entries are loaded before the U V^T loop that
//     hides their latency;
//   - Psi^T U: each thread owns 2 columns x RQ rank groups of 4: per tile
//     row one float2 of Psi and RQ float4 of U for 8 RQ FMAs, a warp reading
//     one Psi row and 8 consecutive U groups.
// The rank loop of U V^T stops at r rounded up to 4 (r = 150 pays for 152);
// the contraction's register block covers 32 RQ ranks (160 at r = 150).
//
// Ranks 257 .. 2048 (contract_v_cluster_kernel) split the rank axis over a
// thread-block cluster of C = ceil(r / 256) blocks a column tile, block c
// owning the slice c of U and V (slices of 4-rank groups, as even as they
// allow: 252 + 248 at r = 500, 3 x 200 at r = 600).  Per row tile each
// block forms its partial U_c V_c^T once, the cluster adds the partials in
// slice order through distributed shared memory (each block a share of the
// rows, written into every block's Psi), and each block contracts Psi^T U_c
// for its slice only, while the next tile's U slice lands in a second
// buffer.  U V^T is done once a tile, with no scratch in global memory.
// Ranks above 2048 (contract_v_chunk_kernel) take the rank axis in chunks
// of 256, the chunk axis folded into the grid's x, each block forming the
// tile's whole Psi (tile64.cuh's chunked_low: every chunk's U and V staged
// in turn) and contracting it against its chunk.
//
// Determinism: no atomics.  U V^T sums over k in order (over a slice's or
// chunk's ranks in order, then over the slices or chunks in order:
// ((p0 + p1) + p2) + ..., so slices of 256 sum as the chunks do), the
// contraction over the rows of a split in order; the m reduction is split
// into a fixed number of row ranges (kernels/huber_contract.py::v_splits,
// from the shape and SM count alone) that write partial sums, then summed
// in index order (reduce.cuh).  Every mask mode and data type shares one
// accumulation order (tile.cuh: a packed mask unpacks to the dense mask's
// 0.0f / 1.0f and the mask multiply is __fmul_rn), so a packed mask gives
// the dense mask's bits and an all-ones mask the bits of none.
#include "hopper.cuh"
#include "reduce.cuh"
#include "tile.cuh"
#include "tile64.cuh"

namespace repro {
namespace {

constexpr int kVRows = kT64;    // rows of one residual tile (the m step)
constexpr int kVCols = kT64;    // columns of one residual tile (a block's)
constexpr int kPsiLd = kVCols + 8;  // Psi row stride: patch stores spread

// The U slice and the V slice, then the Psi tile.
template <int RQ>
__host__ __device__ constexpr size_t v_smem_bytes() {
  return sizeof(float) * ((kVRows + kVCols) * ld64<RQ>() + kVRows * kPsiLd);
}

// Two blocks share an SM (one's loads and barriers under the other's FMAs)
// while both fit its 227 KB of shared memory: r <= 160.
template <int RQ>
__host__ __device__ constexpr int v_blocks_per_sm() {
  return 2 * v_smem_bytes<RQ>() <= 232448 ? 2 : 1;
}

// Grid (column tiles, row splits, E).
template <int RQ, typename TM, int MASK>
__global__ void __launch_bounds__(kT64Threads, v_blocks_per_sm<RQ>())
contract_v_kernel(const float* __restrict__ u, const float* __restrict__ v,
                  const TM* __restrict__ m, const void* __restrict__ w,
                  const float* __restrict__ lam, float* __restrict__ partial,
                  int E, int M, int N, int r, int rows_per_split) {
  constexpr int LD = ld64<RQ>();
  extern __shared__ float4 smem4[];
  float* Us = reinterpret_cast<float*>(smem4);  // kVRows x LD
  float* Vs = Us + kVRows * LD;                 // kVCols x LD
  float* Ps = Vs + kVCols * LD;                 // kVRows x kPsiLd

  const int e = blockIdx.z;
  const int j0 = blockIdx.x * kVCols;
  const int split = blockIdx.y;
  const float* ue = u + static_cast<size_t>(e) * M * r;
  const float* ve = v + static_cast<size_t>(e) * N * r;
  const ClientPlanes<TM, MASK> planes(m, w, e, M, N);
  const float lam_e = lam[e];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // U V^T patch: rows ti + 16 a, columns tj + 16 b; a warp is 4 x 8 threads.
  const int ti = (warp >> 1) * 4 + (lane >> 3);
  const int tj = (warp & 1) * 8 + (lane & 7);
  // Contraction block: columns 2 cj + c, rank groups ck + 8 q.
  const int cj = warp * 4 + (lane >> 3);
  const int ck = lane & 7;
  const int r4 = (r + 3) / 4;

  const int row_begin = split * rows_per_split;
  const int row_end = min(M, row_begin + rows_per_split);
  stage_async<RQ>(Vs, ve, j0, N, r);
  stage_async<RQ>(Us, ue, row_begin, M, r);
  cp_async_commit();

  float acc[2][RQ][4];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int q = 0; q < RQ; ++q)
#pragma unroll
      for (int s = 0; s < 4; ++s) acc[c][q][s] = 0.f;
  cp_async_wait_all();
  __syncthreads();

  for (int i0 = row_begin; i0 < row_end; i0 += kVRows) {
    // This thread's M (and W) entries, loaded before the FMAs that hide
    // their latency.
    float x[4][4], wt[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        planes.load(i0 + ti + 16 * a, j0 + tj + 16 * b, x[a][b], wt[a][b]);

    float low[4][4];
    patch44<RQ>(Us, Vs, ti, tj, r4, low);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        Ps[(ti + 16 * a) * kPsiLd + tj + 16 * b] =
            apply_mask<MASK>(wt[a][b], clip(x[a][b] - low[a][b], lam_e));
    __syncthreads();

    // acc[c][q] += sum_ii Psi[ii, 2 cj + c] * U[ii, 4 (ck + 8 q) .. + 3]
    for (int ii = 0; ii < kVRows; ++ii) {
      const float2 p =
          *reinterpret_cast<const float2*>(Ps + ii * kPsiLd + 2 * cj);
      const float* urow = Us + ii * LD;
#pragma unroll
      for (int q = 0; q < RQ; ++q) {
        const float4 uq =
            *reinterpret_cast<const float4*>(urow + 4 * (ck + 8 * q));
        acc[0][q][0] = fmaf(p.x, uq.x, acc[0][q][0]);
        acc[0][q][1] = fmaf(p.x, uq.y, acc[0][q][1]);
        acc[0][q][2] = fmaf(p.x, uq.z, acc[0][q][2]);
        acc[0][q][3] = fmaf(p.x, uq.w, acc[0][q][3]);
        acc[1][q][0] = fmaf(p.y, uq.x, acc[1][q][0]);
        acc[1][q][1] = fmaf(p.y, uq.y, acc[1][q][1]);
        acc[1][q][2] = fmaf(p.y, uq.z, acc[1][q][2]);
        acc[1][q][3] = fmaf(p.y, uq.w, acc[1][q][3]);
      }
    }
    __syncthreads();  // nobody reads this U slice or Psi any more
    if (i0 + kVRows < row_end) {
      stage_async<RQ>(Us, ue, i0 + kVRows, M, r);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
    }
  }

  float* dst = partial + (static_cast<size_t>(split) * E + e) * N * r;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int j = j0 + 2 * cj + c;
    if (j >= N) continue;
#pragma unroll
    for (int q = 0; q < RQ; ++q)
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int k = 4 * (ck + 8 * q) + s;
        if (k < r) dst[static_cast<size_t>(j) * r + k] = acc[c][q][s];
      }
  }
}

// Ranks 257 .. 2048 (8 slices of 256): one thread-block cluster of `cluster`
// blocks a column tile, block c owning the rank slice [c slice, min((c + 1)
// slice, r)) (kernels/huber_contract.py::v_slices).  Its V slice stays
// staged for the whole row range beside two U-slice buffers, the tile's
// partial U_c V_c^T and Psi (tile64.cuh's cluster_smem_bytes): 227 KB at
// RQ = 8, one block an SM.

// Offset of entry (i, j) of a 64 x 64 tile stored with row stride 64 and
// its columns XOR-swizzled by 8 (i % 4): the 4 x 8 threads of a warp that
// store U V^T patches hit 32 banks, a warp's float2 reads of a Psi row
// and float4 accesses along a row stay contiguous.
__device__ __forceinline__ int swz64(int i, int j) {
  return i * kT64 + (j ^ ((i & 3) << 3));
}

// Grid (column tiles x cluster, row splits, E), clusters (cluster, 1, 1):
// block x = cluster t + c writes the rank slice c of out[e] for column tile
// t.  Per 64-row tile of its range a block
//   1. loads its share of M (and W): rows [64 c / C, 64 (c + 1) / C) of the
//      tile, C = cluster;
//   2. waits for its U slice of the tile, and starts staging the next
//      tile's into the other buffer (it lands under steps 3-5);
//   3. forms its partial U_c V_c^T (patch44 over its slice) in shared
//      memory; cluster barrier;
//   4. adds its share's entries of the C partials in slice order through
//      distributed shared memory, low = ((P_0 + P_1) + P_2) + ..., forms
//      Psi = W clip(M - low, +-lam) there and writes it into every block's
//      Psi; cluster barrier;
//   5. contracts Psi^T U_c into a register block of 32 RQ ranks: each
//      thread 4 columns x 4 rank groups a step (one float4 of Psi and four
//      of U for 64 FMAs; the 2-column blocks of contract_v_kernel load
//      twice as much shared memory an FMA, which bounds them on an H100).
// Each block sums a share of the rows rather than all of the tile: M and W
// are read once, and a block moves 2 x 16 KB of distributed shared memory
// a tile whatever C (every block summing all C partials would read C x 16
// KB and M C times).  U V^T is done once a tile and the contraction covers
// the C slices once; the rank groups of U V^T stop at the slice rounded up
// to 4.  Each block's contraction takes 32 RQ ranks, RQ = ceil(slice / 32),
// so slices of 200 contract 224; the last, narrower slice takes as many
// (its block keeps the pace of the others, which the barriers set).
template <int RQ, typename TM, int MASK>
__global__ void __launch_bounds__(kT64Threads, 1)
contract_v_cluster_kernel(const float* __restrict__ u,
                          const float* __restrict__ v,
                          const TM* __restrict__ m,
                          const void* __restrict__ w,
                          const float* __restrict__ lam,
                          float* __restrict__ partial, int E, int M, int N,
                          int r, int rows_per_split, int cluster,
                          int slice) {
  constexpr int LD = ld64<RQ>();
  extern __shared__ float4 smem4[];
  float* Vs = reinterpret_cast<float*>(smem4);  // kT64 x LD, V's slice
  float* Ub = Vs + kT64 * LD;                   // 2 x kT64 x LD, U's slice
  float* Pp = Ub + 2 * kT64 * LD;               // 64 x 64 partial (swz64)
  float* Ps = Pp + kT64 * kT64;                 // 64 x 64 Psi (swz64)

  const int c = blockIdx.x % cluster;
  const int j0 = (blockIdx.x / cluster) * kT64;
  const int split = blockIdx.y, e = blockIdx.z;
  const float* ue = u + static_cast<size_t>(e) * M * r;
  const float* ve = v + static_cast<size_t>(e) * N * r;
  const ClientPlanes<TM, MASK> planes(m, w, e, M, N);
  const float lam_e = lam[e];
  // This block's rank slice [k0, k0 + kw) and its rank groups of U V^T.
  const int k0 = c * slice, kw = min(slice, r - k0);
  const int w4 = (kw + 3) / 4;
  // This block's share of the tile's rows, in float4 entries of 4 columns.
  const int share_row0 = c * kT64 / cluster;
  const int share4 = ((c + 1) * kT64 / cluster - share_row0) * (kT64 / 4);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ti = (warp >> 1) * 4 + (lane >> 3);
  const int tj = (warp & 1) * 8 + (lane & 7);
  // Contraction block: columns 4 cq + cc, rank groups kl + 16 q; a warp
  // reads 8 column quads of one Psi row and 4 consecutive U groups, and
  // kl < 8 (the groups an odd RQ leaves out of its last q) holds for
  // warps 0-3 alone, one of the two warps of each SM sub-partition.
  const int cq = (warp & 1) * 8 + (lane >> 2);
  const int kl = (warp >> 1) * 4 + (lane & 3);

  const int row_begin = split * rows_per_split;
  const int row_end = min(M, row_begin + rows_per_split);
  // The columns past the slice's 4-rank groups are read only into register
  // columns that are never written out; zero them once all the same.
  zero_past_slice<RQ>(Vs, 3 * kT64, w4);
  stage_slice<RQ>(Vs, ve, j0, N, r, k0, kw);
  stage_slice<RQ>(Ub, ue, row_begin, M, r, k0, kw);
  cp_async_commit();

  constexpr int QH = (RQ + 1) / 2;  // 16 rank groups a step: 8 RQ in all
  float acc[4][QH][4];
#pragma unroll
  for (int cc = 0; cc < 4; ++cc)
#pragma unroll
    for (int q = 0; q < QH; ++q)
#pragma unroll
      for (int s = 0; s < 4; ++s) acc[cc][q][s] = 0.f;

  for (int i0 = row_begin, t = 0; i0 < row_end; i0 += kT64, ++t) {
    const float* Us = Ub + (t & 1) * kT64 * LD;
    float x[2][4], wt[2][4];
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int q = threadIdx.x + kT64Threads * g;
      const int i = share_row0 + q / 16, j = 4 * (q % 16);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        x[g][s] = wt[g][s] = 0.f;
        if (q < share4)
          planes.load(i0 + i, j0 + j + s, x[g][s], wt[g][s]);
      }
    }
    cp_async_wait_all();
    __syncthreads();  // this tile's U slice staged; the last one's read
    if (i0 + kT64 < row_end) {
      stage_slice<RQ>(Ub + ((t + 1) & 1) * kT64 * LD, ue, i0 + kT64, M, r,
                      k0, kw);
      cp_async_commit();
    }

    float low[4][4];
    patch44<RQ, 4>(Us, Vs, ti, tj, w4, low);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        Pp[swz64(ti + 16 * a, tj + 16 * b)] = low[a][b];
    hopper::cluster_sync();  // every block's partial written

#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int q = threadIdx.x + kT64Threads * g;
      if (q >= share4) continue;
      const int at = swz64(share_row0 + q / 16, 4 * (q % 16));
      const float4 lo = hopper::cluster_sum4(Pp + at, cluster);
      const float4 psi = make_float4(
          apply_mask<MASK>(wt[g][0], clip(x[g][0] - lo.x, lam_e)),
          apply_mask<MASK>(wt[g][1], clip(x[g][1] - lo.y, lam_e)),
          apply_mask<MASK>(wt[g][2], clip(x[g][2] - lo.z, lam_e)),
          apply_mask<MASK>(wt[g][3], clip(x[g][3] - lo.w, lam_e)));
      hopper::cluster_store4(Ps + at, cluster, psi);
    }
    hopper::cluster_sync();  // Psi whole in every block; partials read

    // acc[cc][q] += sum_ii Psi[ii, 4 cq + cc] * U[ii, k0 + 4 (kl + 16 q) ..]
#pragma unroll 2
    for (int ii = 0; ii < kT64; ++ii) {
      const float4 p =
          *reinterpret_cast<const float4*>(Ps + swz64(ii, 4 * cq));
      const float pc[4] = {p.x, p.y, p.z, p.w};
      const float* urow = Us + ii * LD;
#pragma unroll
      for (int q = 0; q < QH; ++q) {
        if (RQ % 2 == 0 || q < QH - 1 || kl < 8) {
          const float4 uq =
              *reinterpret_cast<const float4*>(urow + 4 * (kl + 16 * q));
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            acc[cc][q][0] = fmaf(pc[cc], uq.x, acc[cc][q][0]);
            acc[cc][q][1] = fmaf(pc[cc], uq.y, acc[cc][q][1]);
            acc[cc][q][2] = fmaf(pc[cc], uq.z, acc[cc][q][2]);
            acc[cc][q][3] = fmaf(pc[cc], uq.w, acc[cc][q][3]);
          }
        }
      }
    }
  }

  float* dst = partial + (static_cast<size_t>(split) * E + e) * N * r + k0;
#pragma unroll
  for (int cc = 0; cc < 4; ++cc) {
    const int j = j0 + 4 * cq + cc;
    if (j >= N) continue;
#pragma unroll
    for (int q = 0; q < QH; ++q)
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int k = 4 * (kl + 16 * q) + s;
        if (k < kw) dst[static_cast<size_t>(j) * r + k] = acc[cc][q][s];
      }
  }
}

template <int RQ, typename TM, int MASK>
cudaError_t launch_v_cluster(const float* u, const float* v, const TM* m,
                             const void* w, const float* lam, float* out,
                             float* partial, int E, int M, int N, int r,
                             int splits, int rows_per_split, int cluster,
                             int slice, cudaStream_t stream) {
  auto kernel = contract_v_cluster_kernel<RQ, TM, MASK>;
  constexpr size_t smem = cluster_smem_bytes<RQ>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long tiles = (N + kVCols - 1) / kVCols;
  float* dst = splits == 1 ? out : partial;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t config = cluster_launch_config(
      attr, dim3(static_cast<unsigned>(tiles * cluster), splits, E), cluster,
      smem, stream);
  err = cudaLaunchKernelEx(&config, kernel, u, v, m, w, lam, dst, E, M, N,
                           r, rows_per_split, cluster, slice);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return launch_sum_splits(partial, out, static_cast<size_t>(E) * N * r,
                           splits, stream);
}

// Ranks above 2048 in chunks of 256 (tile64.cuh): one chunk of U and one
// of V at a time, Psi.  151 KB: one block an SM.
__host__ __device__ constexpr size_t v_chunk_smem_bytes() {
  return sizeof(float) *
         ((kVRows + kVCols) * ld64<kChunkRQ>() + kVRows * kPsiLd);
}

// Grid (column tiles x chunks, row splits, E): block x = C t + c writes the
// rank chunk c of out[e] for column tile t (C = rank_chunks(r)).  Per row
// tile each block forms the tile's whole Psi (U V^T over every chunk, in
// chunk order: chunked_low), stages U's chunk c again unless it is the
// last one (still staged), and contracts Psi against it.  The U V^T work is
// C times one pass's; the contraction's is one pass's.
template <typename TM, int MASK>
__global__ void __launch_bounds__(kT64Threads, 1)
contract_v_chunk_kernel(const float* __restrict__ u,
                        const float* __restrict__ v, const TM* __restrict__ m,
                        const void* __restrict__ w,
                        const float* __restrict__ lam,
                        float* __restrict__ partial, int E, int M, int N,
                        int r, int rows_per_split) {
  constexpr int RQ = kChunkRQ;
  constexpr int LD = ld64<RQ>();
  extern __shared__ float4 smem4[];
  float* Us = reinterpret_cast<float*>(smem4);  // kVRows x LD, one chunk
  float* Vs = Us + kVRows * LD;                 // kVCols x LD, one chunk
  float* Ps = Vs + kVCols * LD;                 // kVRows x kPsiLd

  const int chunks = rank_chunks(r);
  const int c = blockIdx.x % chunks;
  const int j0 = (blockIdx.x / chunks) * kVCols;
  const int e = blockIdx.z;
  const int split = blockIdx.y;
  const float* ue = u + static_cast<size_t>(e) * M * r;
  const float* ve = v + static_cast<size_t>(e) * N * r;
  const ClientPlanes<TM, MASK> planes(m, w, e, M, N);
  const float lam_e = lam[e];
  // This block's output chunk [ck, ck + cw).
  const int ck = c * kRankChunk, cw = min(kRankChunk, r - ck);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ti = (warp >> 1) * 4 + (lane >> 3);
  const int tj = (warp & 1) * 8 + (lane & 7);
  const int cj = warp * 4 + (lane >> 3);
  const int ckq = lane & 7;

  const int row_begin = split * rows_per_split;
  const int row_end = min(M, row_begin + rows_per_split);

  float acc[2][RQ][4];
#pragma unroll
  for (int cc = 0; cc < 2; ++cc)
#pragma unroll
    for (int q = 0; q < RQ; ++q)
#pragma unroll
      for (int s = 0; s < 4; ++s) acc[cc][q][s] = 0.f;

  for (int i0 = row_begin; i0 < row_end; i0 += kVRows) {
    float x[4][4], wt[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        planes.load(i0 + ti + 16 * a, j0 + tj + 16 * b, x[a][b], wt[a][b]);
    float low[4][4];
    chunked_low(Us, Vs, ue, ve, i0, M, j0, N, r, ti, tj, low);
    if (c != chunks - 1) {
      stage_window<RQ>(Us, ue, i0, M, r, ck, cw);
      cp_async_commit();
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        Ps[(ti + 16 * a) * kPsiLd + tj + 16 * b] =
            apply_mask<MASK>(wt[a][b], clip(x[a][b] - low[a][b], lam_e));
    cp_async_wait_all();
    __syncthreads();  // Psi written, U's chunk c staged

    // acc[cc][q] += sum_ii Psi[ii, 2 cj + cc] * U[ii, ck + 4 (ckq + 8 q) ..]
    for (int ii = 0; ii < kVRows; ++ii) {
      const float2 p =
          *reinterpret_cast<const float2*>(Ps + ii * kPsiLd + 2 * cj);
      const float* urow = Us + ii * LD;
#pragma unroll
      for (int q = 0; q < RQ; ++q) {
        const float4 uq =
            *reinterpret_cast<const float4*>(urow + 4 * (ckq + 8 * q));
        acc[0][q][0] = fmaf(p.x, uq.x, acc[0][q][0]);
        acc[0][q][1] = fmaf(p.x, uq.y, acc[0][q][1]);
        acc[0][q][2] = fmaf(p.x, uq.z, acc[0][q][2]);
        acc[0][q][3] = fmaf(p.x, uq.w, acc[0][q][3]);
        acc[1][q][0] = fmaf(p.y, uq.x, acc[1][q][0]);
        acc[1][q][1] = fmaf(p.y, uq.y, acc[1][q][1]);
        acc[1][q][2] = fmaf(p.y, uq.z, acc[1][q][2]);
        acc[1][q][3] = fmaf(p.y, uq.w, acc[1][q][3]);
      }
    }
    __syncthreads();  // nobody reads this U chunk or Psi any more
  }

  float* dst = partial + (static_cast<size_t>(split) * E + e) * N * r + ck;
#pragma unroll
  for (int cc = 0; cc < 2; ++cc) {
    const int j = j0 + 2 * cj + cc;
    if (j >= N) continue;
#pragma unroll
    for (int q = 0; q < RQ; ++q)
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int k = 4 * (ckq + 8 * q) + s;
        if (k < cw) dst[static_cast<size_t>(j) * r + k] = acc[cc][q][s];
      }
  }
}

template <typename TM, int MASK>
cudaError_t launch_v_chunked(const float* u, const float* v, const TM* m,
                             const void* w, const float* lam, float* out,
                             float* partial, int E, int M, int N, int r,
                             int splits, int rows_per_split,
                             cudaStream_t stream) {
  auto kernel = contract_v_chunk_kernel<TM, MASK>;
  constexpr size_t smem = v_chunk_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long tiles = (N + kVCols - 1) / kVCols;
  const dim3 grid(static_cast<unsigned>(tiles * rank_chunks(r)), splits, E);
  float* dst = splits == 1 ? out : partial;
  kernel<<<grid, kT64Threads, smem, stream>>>(u, v, m, w, lam, dst, E, M, N,
                                              r, rows_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return launch_sum_splits(partial, out, static_cast<size_t>(E) * N * r,
                           splits, stream);
}

template <int RQ, typename TM, int MASK>
cudaError_t launch_v(const float* u, const float* v, const TM* m,
                     const void* w, const float* lam, float* out,
                     float* partial, int E, int M, int N, int r, int splits,
                     int rows_per_split, cudaStream_t stream) {
  auto kernel = contract_v_kernel<RQ, TM, MASK>;
  constexpr size_t smem = v_smem_bytes<RQ>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kVCols - 1) / kVCols, splits, E);
  float* dst = splits == 1 ? out : partial;
  kernel<<<grid, kT64Threads, smem, stream>>>(u, v, m, w, lam, dst, E, M, N, r,
                                            rows_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return launch_sum_splits(partial, out, static_cast<size_t>(E) * N * r,
                           splits, stream);
}

}  // namespace
}  // namespace repro

// Returns cudaGetLastError() of the launches (0 on success).  m is fp32 or
// bf16 (dtype code), w null, dense or packed (mask code, tile.cuh); the
// splits' row ranges are whole 64-row tiles; partial holds splits * E * N * r
// floats when splits > 1 (unused otherwise).  r <= 256 takes one register
// block (contract_v_kernel); above, cluster > 0 takes the cluster kernel
// with rank slices of `slice` (slices_valid), and cluster == 0 the
// chunks of 256 (contract_v_chunk_kernel; kernels/_launch.py::v_chunked).
extern "C" int repro_huber_contract_v(const float* u, const float* v,
                                      const void* m, const void* w,
                                      const float* lam, float* out,
                                      float* partial, int E, int M, int N,
                                      int r, int dtype, int mask, int splits,
                                      int rows_per_split, int cluster,
                                      int slice, void* stream) {
  if (splits < 1 || rows_per_split % repro::kVRows != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (r > repro::kRankChunk && cluster > 0) {
    if (!repro::slices_valid(r, cluster, slice))
      return static_cast<int>(cudaErrorInvalidValue);
    // One register block of the slice's width: RQ = ceil(slice / 32).
    return repro::dispatch(slice, dtype, mask,
                           [&](auto rq, auto tm, auto mk) {
      using TM = typename decltype(tm)::type;
      constexpr int RQ = decltype(rq)::value;
      constexpr int MASK = decltype(mk)::value;
      if constexpr (RQ >= repro::kClusterMinRQ && RQ <= 8)
        return repro::launch_v_cluster<RQ, TM, MASK>(
            u, v, static_cast<const TM*>(m), w, lam, out, partial, E, M, N,
            r, splits, rows_per_split, cluster, slice, st);
      else
        return cudaErrorInvalidValue;
    });
  }
  return repro::dispatch(
      r, dtype, mask,
      [&](auto rq, auto tm, auto mk) {
        using TM = typename decltype(tm)::type;
        constexpr int RQ = decltype(rq)::value;
        constexpr int MASK = decltype(mk)::value;
        if constexpr (RQ == repro::kChunked)
          return repro::launch_v_chunked<TM, MASK>(
              u, v, static_cast<const TM*>(m), w, lam, out, partial, E, M, N,
              r, splits, rows_per_split, st);
        else
          return repro::launch_v<RQ, TM, MASK>(
              u, v, static_cast<const TM*>(m), w, lam, out, partial, E, M, N,
              r, splits, rows_per_split, st);
      });
}

// The most clusters of `cluster` blocks of contract_v_cluster_kernel (rank
// slices of `slice`) resident at once on the current device
// (cudaOccupancyMaxActiveClusters), or -1 on an error.
extern "C" int repro_contract_v_cluster_slots(int cluster, int slice) {
  int slots = -1;
  repro::dispatch(slice, repro::kFloat32, repro::kNoMask,
                  [&](auto rq, auto, auto) {
    constexpr int RQ = decltype(rq)::value;
    if constexpr (RQ >= repro::kClusterMinRQ && RQ <= 8)
      slots = repro::max_active_clusters(
          repro::contract_v_cluster_kernel<RQ, float, repro::kNoMask>,
          repro::cluster_smem_bytes<RQ>(), cluster);
    return cudaSuccess;
  });
  return slots;
}
