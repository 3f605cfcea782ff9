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
// Ranks 257-512 (contract_v_wide_kernel) take the rank axis in two halves
// (tile64.cuh): a grid axis over the output's rank halves, each block
// forming the tile's whole Psi (U V^T over both halves, staged one after
// the other) and contracting it against its half of U.  Ranks above 512
// (contract_v_chunk_kernel) take it in chunks of 256 the same way, the
// chunk axis folded into the grid's x, each chunk's U and V staged in turn.
//
// Determinism: no atomics.  U V^T sums over k in order, the contraction over
// the rows of a split in order; the m reduction is split into a fixed number
// of row ranges (kernels/huber_contract.py::v_splits, from the shape and SM
// count alone) that write partial sums, then summed in index order
// (reduce.cuh).  Every mask mode and data type shares one accumulation order
// (tile.cuh: a packed mask unpacks to the dense mask's 0.0f / 1.0f and the
// mask multiply is __fmul_rn), so a packed mask gives the dense mask's bits
// and an all-ones mask the bits of none.
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

// Ranks 257 .. 512 in two halves (tile64.cuh): V's two halves, one half of
// U, Psi.  218 KB at RQH = 8: one block an SM.
template <int RQH>
__host__ __device__ constexpr size_t v_wide_smem_bytes() {
  return sizeof(float) *
         ((kVRows + 2 * kVCols) * ld64<RQH>() + kVRows * kPsiLd);
}

// Grid (column tiles, row splits, 2 E): block z = 2 e + h writes the rank
// half h of out[e] (ranks [h k0, ...), k0 = 32 RQH).  Each of the two
// blocks of a column tile forms the tile's whole Psi (U V^T over both
// halves: its only redundant work) and contracts it against its half of U.
// Per row tile: U's other half is staged (under the previous tile's end),
// its patch summed; then U's own half, its patch, Psi, and Psi^T U_h, which
// needs U_h still staged.  V's halves stay staged for the whole range.
template <int RQH, typename TM, int MASK>
__global__ void __launch_bounds__(kT64Threads, 1)
contract_v_wide_kernel(const float* __restrict__ u,
                       const float* __restrict__ v, const TM* __restrict__ m,
                       const void* __restrict__ w,
                       const float* __restrict__ lam,
                       float* __restrict__ partial, int E, int M, int N,
                       int r, int rows_per_split) {
  constexpr int LD = ld64<RQH>();
  constexpr int K0 = wide_half(RQH);
  extern __shared__ float4 smem4[];
  float* Us = reinterpret_cast<float*>(smem4);  // kVRows x LD, one half
  float* Va = Us + kVRows * LD;                 // kVCols x LD, ranks < K0
  float* Vb = Va + kVCols * LD;                 // kVCols x LD, ranks >= K0
  float* Ps = Vb + kVCols * LD;                 // kVRows x kPsiLd

  const int e = blockIdx.z >> 1, h = blockIdx.z & 1;
  const int j0 = blockIdx.x * kVCols;
  const int split = blockIdx.y;
  const float* ue = u + static_cast<size_t>(e) * M * r;
  const float* ve = v + static_cast<size_t>(e) * N * r;
  const ClientPlanes<TM, MASK> planes(m, w, e, M, N);
  const float lam_e = lam[e];
  // This block's rank half [hk, hk + hw) and the other one [ok, ok + ow).
  const int hk = h ? K0 : 0, hw = h ? r - K0 : K0;
  const int ok = h ? 0 : K0, ow = h ? K0 : r - K0;
  const float* v_own = h ? Vb : Va;
  const float* v_other = h ? Va : Vb;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ti = (warp >> 1) * 4 + (lane >> 3);
  const int tj = (warp & 1) * 8 + (lane & 7);
  const int cj = warp * 4 + (lane >> 3);
  const int ck = lane & 7;

  const int row_begin = split * rows_per_split;
  const int row_end = min(M, row_begin + rows_per_split);
  stage_window<RQH>(Va, ve, j0, N, r, 0, K0);
  stage_window<RQH>(Vb, ve, j0, N, r, K0, r - K0);
  stage_window<RQH>(Us, ue, row_begin, M, r, ok, ow);
  cp_async_commit();

  float acc[2][RQH][4];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int q = 0; q < RQH; ++q)
#pragma unroll
      for (int s = 0; s < 4; ++s) acc[c][q][s] = 0.f;

  for (int i0 = row_begin; i0 < row_end; i0 += kVRows) {
    float x[4][4], wt[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        planes.load(i0 + ti + 16 * a, j0 + tj + 16 * b, x[a][b], wt[a][b]);
    cp_async_wait_all();
    __syncthreads();  // U's other half of this tile (and V) staged
    float lo[4][4], lh[4][4];
    patch44<RQH>(Us, v_other, ti, tj, (ow + 3) / 4, lo);
    __syncthreads();  // nobody reads U's other half any more
    stage_window<RQH>(Us, ue, i0, M, r, hk, hw);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    patch44<RQH>(Us, v_own, ti, tj, (hw + 3) / 4, lh);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        Ps[(ti + 16 * a) * kPsiLd + tj + 16 * b] = apply_mask<MASK>(
            wt[a][b], clip(x[a][b] - (lo[a][b] + lh[a][b]), lam_e));
    __syncthreads();

    // acc[c][q] += sum_ii Psi[ii, 2 cj + c] * U[ii, hk + 4 (ck + 8 q) ..]
    for (int ii = 0; ii < kVRows; ++ii) {
      const float2 p =
          *reinterpret_cast<const float2*>(Ps + ii * kPsiLd + 2 * cj);
      const float* urow = Us + ii * LD;
#pragma unroll
      for (int q = 0; q < RQH; ++q) {
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
    __syncthreads();  // nobody reads this U half or Psi any more
    if (i0 + kVRows < row_end) {
      stage_window<RQH>(Us, ue, i0 + kVRows, M, r, ok, ow);
      cp_async_commit();
    }
  }

  float* dst = partial + (static_cast<size_t>(split) * E + e) * N * r + hk;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int j = j0 + 2 * cj + c;
    if (j >= N) continue;
#pragma unroll
    for (int q = 0; q < RQH; ++q)
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int k = 4 * (ck + 8 * q) + s;
        if (k < hw) dst[static_cast<size_t>(j) * r + k] = acc[c][q][s];
      }
  }
}

// Ranks above 512 in chunks of 256 (tile64.cuh): one chunk of U and one of
// V at a time, Psi.  151 KB: one block an SM.
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
  // RQ > 8: two rank halves of RQ / 2 register groups (tile.cuh's by_rank).
  constexpr bool kWide = RQ > 8;
  auto kernel = contract_v_kernel<kWide ? 1 : RQ, TM, MASK>;
  if constexpr (kWide) kernel = contract_v_wide_kernel<RQ / 2, TM, MASK>;
  const size_t smem =
      kWide ? v_wide_smem_bytes<RQ / 2>() : v_smem_bytes<RQ>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kVCols - 1) / kVCols, splits, kWide ? 2 * E : E);
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
// floats when splits > 1 (unused otherwise); chunked != 0 takes r 257-512 in
// chunks of 256 too (tile.cuh's by_rank).
extern "C" int repro_huber_contract_v(const float* u, const float* v,
                                      const void* m, const void* w,
                                      const float* lam, float* out,
                                      float* partial, int E, int M, int N,
                                      int r, int dtype, int mask, int splits,
                                      int rows_per_split, int chunked,
                                      void* stream) {
  if (splits < 1 || rows_per_split % repro::kVRows != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return repro::dispatch(
      r, dtype, mask,
      [&](auto rq, auto tm, auto mk) {
        using TM = typename decltype(tm)::type;
        constexpr int RQ = decltype(rq)::value;
        constexpr int MASK = decltype(mk)::value;
        const auto st = static_cast<cudaStream_t>(stream);
        if constexpr (RQ == repro::kChunked)
          return repro::launch_v_chunked<TM, MASK>(
              u, v, static_cast<const TM*>(m), w, lam, out, partial, E, M, N,
              r, splits, rows_per_split, st);
        else
          return repro::launch_v<RQ, TM, MASK>(
              u, v, static_cast<const TM*>(m), w, lam, out, partial, E, M, N,
              r, splits, rows_per_split, st);
      },
      chunked != 0);
}
