// The row-stripe kernel behind huber_contract_u, huber_contract_u_diag and
// huber_dual_contract (contract_u.cu, contract_u_diag.cu, dual.cu each
// instantiate one flavour, so the three build in parallel).
//
// Grid (m stripes, column splits, E).  A block owns one 64-row stripe of one
// client, stages its U rows once, and walks its range of columns in 64 x 64
// residual tiles.  From each tile, with R_W = W * R and Psi = clip(R_W,
// +-lam):
//   out_u[e, i, :] = sum_j Psi[i, j] V[j, :]   over the block's columns, in
//                                              its registers (always);
//   WITH_DIAG  the block's share of H_lam(R_W) and ||Psi||^2, written as
//              per-block partials;
//   WITH_V     the stripe's (64-column x r) share of Psi^T U for each column
//              tile, summed over its row group into one of the group
//              partial planes (groups, E, n, r) (below).
// One second launch adds the partials in index order (reduce.cuh): out_u
// over the column splits (none with one split: out_u is written directly),
// out_v over the row groups (none with one group), the scalars over the
// blocks.  No atomics.  The three
// flavours share the splits (kernels/huber_contract.py::u_splits, from the
// shape and SM count alone) and every accumulation of out_u, obj and psi2,
// so huber_contract_u (fused="off") and huber_contract_u_diag
// (fused="diag") give the same bits, and huber_dual_contract's out_u, obj
// and psi2 are those of u_diag.
//
// What bounds them on an H100: fp32 arithmetic, 4r FLOP per residual entry
// (6r in the dual) against 2-4 bytes of M and 1/8-4 of W, far right of the
// fp32 ridge (~20 FLOP/byte).  The CUDA cores issue one FMA instruction a
// clock per SM sub-partition, so the loops must issue little else and the
// card must be full.  No tensor cores and no TF32: the solver's recovery
// bar needs full fp32.  The design:
//   - the column axis is split into ranges of whole 64-column tiles, so
//     that (stripes x splits x E) blocks fill 132 SMs even at E = 1;
//   - U V^T is tile64.cuh's 4 x 4 patch a thread (8 float4 loads for 64
//     FMAs per 4 ranks, shared with contract_v.cu); each thread's M (and W)
//     entries are loaded before it, so their latency hides under it;
//   - Psi is stored transposed (Psi^T, row stride 68: the patch stores and
//     both contractions' float2 reads are free of bank conflicts);
//   - Psi V: each thread owns 2 rows x RQ rank groups of 4: per tile column
//     one float2 of Psi^T and RQ float4 of V for 8 RQ FMAs;
//   - Psi^T U (WITH_V): each thread owns 2 columns x RQ rank groups of 4:
//     per two tile rows two float2 of Psi^T and 2 RQ float4 of U for 16 RQ
//     FMAs;
//   - V tiles come through a two-stage cp.async ring (the next tile loads
//     under this tile's FMAs) and two blocks share an SM where shared
//     memory and registers allow both (r <= 96, the dual r <= 64); at
//     96 < r <= 160 the u flavours run two blocks with one V stage (the
//     next tile loads behind a barrier, under the other block's FMAs:
//     faster than one block with two stages); elsewhere one block with
//     two stages.
// The rank loop of U V^T stops at r rounded up to 4; the contractions'
// register blocks cover 32 RQ ranks.  Ranks 257-2048
// (stripe_cluster_kernel) split the rank axis over a thread-block cluster
// of C = ceil(r / 256) blocks a stripe, block c owning slice c of U and V
// (as even as 4-rank groups allow: 252 + 248 at r = 500, 3 x 200 at 600):
// per column tile each block forms its partial U_c V_c^T once, the cluster
// adds the partials in slice order through distributed shared memory (each
// block a share of the tile, written into every block's Psi^T), and each
// block contracts Psi V_c (and Psi^T U_c) for its slice only, while the
// next tile's V slice lands in a second stage.  Ranks above 2048
// (stripe_chunk_kernel) take the rank axis in chunks of 256, the chunk axis
// folded into the grid's x, each block forming the tile's whole Psi
// (tile64.cuh's chunked_low: each chunk's U and V staged in turn) and
// contracting it against its chunk.
//
// The dual's out_v scratch does not grow with m: its stripes form row
// groups (kernels/huber_contract.py::dual_plan), each a thread-block
// cluster of `cluster` consecutive stripes (1, 2, 4 or 8), and a group adds
// its stripes' shares into one partial plane, so the planes are at most the
// 4 MiB the reference bounds its resident out_v by.  For every column tile
// each block pushes its share into the receive buffer (distributed shared
// memory) of the block that owns those columns, and that block adds its
// 64 / cluster columns over the cluster's blocks in rank order: the same
// order on every run.  The buffers alternate between two parities and the
// cluster barrier is split: a block arrives after its push and waits (then
// sums) after the next tile's U V^T, Psi and Psi V, so the blocks need not
// run in lockstep.  Clusters are placed by load balancing (at D, 66
// clusters of 4 fit an H100 at once, 62 by default: one wave, not two).
// With cluster 1 (the u flavours, and the dual where every stripe may have
// a plane) a block writes its plane directly.
#pragma once

#include "hopper.cuh"
#include "reduce.cuh"
#include "tile.cuh"
#include "tile64.cuh"

namespace repro {

constexpr int kPsiTLd = kT64 + 4;  // row stride of Psi^T

// Floats of the dual's receive buffer when its row groups are clusters:
// two parities x 64 columns x 32 RQ ranks.
template <int RQ>
__host__ __device__ constexpr size_t recv_floats() {
  return 2 * kT64 * 32 * RQ;
}

// This block's columns [c, c + 1) * 64 / cluster of the column tile at
// j0, c its rank in the cluster: its receive buffer (parity par) holds the
// cluster's blocks' shares, added here in rank order and written to its
// group's plane of v_target (groups, E, N, r).  Not inlined: the dual holds
// 128 registers a thread for two blocks an SM, and a call once a tile
// costs less than the spills its inlined loop caused in the tile loop
// (0.093 -> 0.080 ms at D16 on an H100).
template <int RQ>
__device__ __noinline__ void cluster_sum(const float* recv, int par,
                                            float* v_target, int j0, int E,
                                            int N, int r, int cluster) {
  constexpr int RP = 32 * RQ;
  const int width = kT64 / cluster;
  const int crank = blockIdx.x % cluster, group = blockIdx.x / cluster;
  float* dst =
      v_target + (static_cast<size_t>(group) * E + blockIdx.z) * N * r;
  const float* buf = recv + static_cast<size_t>(par) * kT64 * RP;
  for (int idx = threadIdx.x; idx < width * RP; idx += kT64Threads) {
    const int cc = idx / RP, k = idx - cc * RP;
    float sum = 0.f;
    for (int b = 0; b < cluster; ++b) sum += buf[(b * width + cc) * RP + k];
    const int j = j0 + crank * width + cc;
    if (j < N && k < r) dst[static_cast<size_t>(j) * r + k] = sum;
  }
}

// Dynamic shared memory of a stripe block: the U stripe, STAGES V tiles,
// Psi^T.
template <int RQ, int STAGES>
__host__ __device__ constexpr size_t stripe_smem_bytes() {
  return sizeof(float) *
         ((1 + STAGES) * kT64 * ld64<RQ>() + kT64 * kPsiTLd);
}

// Two blocks share an SM where both fit its shared memory with one V stage
// (r <= 160) and its registers (128 a thread): the dual's two register
// blocks of 8 RQ floats and its row-group exchange fit beside the rest
// only up to RQ = 2 (r <= 64; at RQ = 3 they spilled, and its clusters'
// receive buffers leave room for one block anyway).
template <int RQ, bool WITH_V>
__host__ __device__ constexpr bool stripe_two_blocks() {
  return two_blocks_fit(stripe_smem_bytes<RQ, 1>()) && (!WITH_V || RQ <= 2);
}

// Two V stages wherever they fit beside the blocks an SM holds; one where a
// second stage would cost the second block (r 97-160 without out_v).
template <int RQ, bool WITH_V>
__host__ __device__ constexpr int stripe_stages() {
  return (!stripe_two_blocks<RQ, WITH_V>() ||
          two_blocks_fit(stripe_smem_bytes<RQ, 2>()))
             ? 2
             : 1;
}

template <int RQ, typename TM, int MASK, bool WITH_DIAG, bool WITH_V>
__global__ void __launch_bounds__(kT64Threads,
                                  stripe_two_blocks<RQ, WITH_V>() ? 2 : 1)
stripe_kernel(const float* __restrict__ u, const float* __restrict__ v,
              const TM* __restrict__ m, const void* __restrict__ w,
              const float* __restrict__ lam, float* __restrict__ out_u,
              float* __restrict__ diag_partial,
              float* __restrict__ v_target, int E, int M, int N, int r,
              int cols_per_split, int cluster) {
  constexpr int LD = ld64<RQ>();
  constexpr int STAGES = stripe_stages<RQ, WITH_V>();
  extern __shared__ float4 smem4[];
  float* Us = reinterpret_cast<float*>(smem4);  // kT64 x LD
  float* Vring = Us + kT64 * LD;                // STAGES x kT64 x LD
  float* PsT = Vring + STAGES * kT64 * LD;      // kT64 x kPsiTLd
  float* recv = PsT + kT64 * kPsiTLd;  // the dual's, with cluster > 1

  const int stripe = blockIdx.x, split = blockIdx.y, e = blockIdx.z;
  const int i0 = stripe * kT64;
  const int col_begin = split * cols_per_split;
  const int col_end = min(N, col_begin + cols_per_split);
  const float* ue = u + static_cast<size_t>(e) * M * r;
  const float* ve = v + static_cast<size_t>(e) * N * r;
  const ClientPlanes<TM, MASK> planes(m, w, e, M, N);
  const float lam_e = lam[e];
  const float half_lam2 = 0.5f * lam_e * lam_e;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // U V^T patch: rows ti + 16 a, columns tj + 16 b; a warp is 4 x 8 threads.
  const int ti = (warp >> 1) * 4 + (lane >> 3);
  const int tj = (warp & 1) * 8 + (lane & 7);
  // Contraction blocks: rows (Psi V) or columns (Psi^T U) 2 cr + c, rank
  // groups ck + 8 q.
  const int cr = warp * 4 + (lane >> 3);
  const int ck = lane & 7;
  const int r4 = (r + 3) / 4;
  // The dual's row groups: clusters of `cluster` consecutive stripes.
  // Their blocks push into each other's receive buffers, so all of them
  // must be running before the first push.
  if (WITH_V && cluster > 1) hopper::cluster_sync();

  stage_async<RQ>(Us, ue, i0, M, r);
  stage_async<RQ>(Vring, ve, col_begin, N, r);
  cp_async_commit();

  float acc[2][RQ][4];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int q = 0; q < RQ; ++q)
#pragma unroll
      for (int s = 0; s < 4; ++s) acc[c][q][s] = 0.f;
  float obj = 0.f, psi2 = 0.f;

  int t = 0;
  for (int j0 = col_begin; j0 < col_end; j0 += kT64, ++t) {
    float* Vs = Vring + (STAGES == 2 ? (t & 1) : 0) * kT64 * LD;
    const bool more = j0 + kT64 < col_end;
    // This thread's M (and W) entries, loaded before the wait and the FMAs
    // that hide their latency.
    float x[4][4], wt[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        planes.load(i0 + ti + 16 * a, j0 + tj + 16 * b, x[a][b], wt[a][b]);
    // The only copies in flight are this tile's V (and, on the first tile,
    // U).  The barrier also ends the last tile: nobody reads its Psi^T or
    // its V stage any more.
    cp_async_wait_all();
    __syncthreads();
    if (STAGES == 2 && more) {
      stage_async<RQ>(Vring + ((t + 1) & 1) * kT64 * LD, ve, j0 + kT64, N,
                      r);
      cp_async_commit();
    }

    float low[4][4];
    patch44<RQ>(Us, Vs, ti, tj, r4, low);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float rw = apply_mask<MASK>(wt[a][b], x[a][b] - low[a][b]);
        const float psi = clip(rw, lam_e);
        if (WITH_DIAG) {
          const float ab = fabsf(rw);
          obj += (ab <= lam_e) ? 0.5f * rw * rw : lam_e * ab - half_lam2;
          psi2 = fmaf(psi, psi, psi2);
        }
        PsT[(tj + 16 * b) * kPsiTLd + ti + 16 * a] = psi;
      }
    __syncthreads();

    // acc[c][q] += sum_jj Psi[2 cr + c, jj] * V[jj, 4 (ck + 8 q) .. + 3]
    for (int jj = 0; jj < kT64; ++jj) {
      const float2 p =
          *reinterpret_cast<const float2*>(PsT + jj * kPsiTLd + 2 * cr);
      const float* vrow = Vs + jj * LD;
#pragma unroll
      for (int q = 0; q < RQ; ++q) {
        const float4 vq =
            *reinterpret_cast<const float4*>(vrow + 4 * (ck + 8 * q));
        acc[0][q][0] = fmaf(p.x, vq.x, acc[0][q][0]);
        acc[0][q][1] = fmaf(p.x, vq.y, acc[0][q][1]);
        acc[0][q][2] = fmaf(p.x, vq.z, acc[0][q][2]);
        acc[0][q][3] = fmaf(p.x, vq.w, acc[0][q][3]);
        acc[1][q][0] = fmaf(p.y, vq.x, acc[1][q][0]);
        acc[1][q][1] = fmaf(p.y, vq.y, acc[1][q][1]);
        acc[1][q][2] = fmaf(p.y, vq.z, acc[1][q][2]);
        acc[1][q][3] = fmaf(p.y, vq.w, acc[1][q][3]);
      }
    }
    if (STAGES == 1 && more) {
      __syncthreads();  // nobody reads this V tile any more
      stage_async<RQ>(Vs, ve, j0 + kT64, N, r);
      cp_async_commit();
    }
    if (WITH_V && cluster > 1 && t > 0) {
      // The last tile's pushes have landed everywhere: its sums, here where
      // only acc is live, before this tile's push reuses the other parity.
      hopper::cluster_wait();
      cluster_sum<RQ>(recv, (t - 1) & 1, v_target, j0 - kT64, E, N, r,
                      cluster);
    }

    if constexpr (WITH_V) {
      // pv[c][q] = sum_ii Psi[ii, 2 cr + c] * U[ii, 4 (ck + 8 q) .. + 3]:
      // this stripe's share of out_v for the tile's 64 columns.
      float pv[2][RQ][4];
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int q = 0; q < RQ; ++q)
#pragma unroll
          for (int s = 0; s < 4; ++s) pv[c][q][s] = 0.f;
      const float* p0row = PsT + (2 * cr) * kPsiTLd;
      const float* p1row = p0row + kPsiTLd;
      for (int ii = 0; ii < kT64; ii += 2) {
        const float2 p0 = *reinterpret_cast<const float2*>(p0row + ii);
        const float2 p1 = *reinterpret_cast<const float2*>(p1row + ii);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float a0 = h ? p0.y : p0.x;
          const float a1 = h ? p1.y : p1.x;
          const float* urow = Us + (ii + h) * LD;
#pragma unroll
          for (int q = 0; q < RQ; ++q) {
            const float4 uq =
                *reinterpret_cast<const float4*>(urow + 4 * (ck + 8 * q));
            pv[0][q][0] = fmaf(a0, uq.x, pv[0][q][0]);
            pv[0][q][1] = fmaf(a0, uq.y, pv[0][q][1]);
            pv[0][q][2] = fmaf(a0, uq.z, pv[0][q][2]);
            pv[0][q][3] = fmaf(a0, uq.w, pv[0][q][3]);
            pv[1][q][0] = fmaf(a1, uq.x, pv[1][q][0]);
            pv[1][q][1] = fmaf(a1, uq.y, pv[1][q][1]);
            pv[1][q][2] = fmaf(a1, uq.z, pv[1][q][2]);
            pv[1][q][3] = fmaf(a1, uq.w, pv[1][q][3]);
          }
        }
      }
      if (cluster == 1) {
        float* dst = v_target + (static_cast<size_t>(stripe) * E + e) * N * r;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = j0 + 2 * cr + c;
          if (j >= N) continue;
#pragma unroll
          for (int q = 0; q < RQ; ++q)
#pragma unroll
            for (int s = 0; s < 4; ++s) {
              const int k = 4 * (ck + 8 * q) + s;
              if (k < r) dst[static_cast<size_t>(j) * r + k] = pv[c][q][s];
            }
        }
      } else {
        // Columns 2 cr, 2 cr + 1 go to block 2 cr / (64 / cluster), into
        // its receive buffer of this tile's parity at this block's slot.
        const int width = kT64 / cluster;
        const int crank = stripe % cluster;
        const uint32_t to = hopper::cluster_addr(
            recv + ((static_cast<size_t>(t & 1) * cluster + crank) * width +
                    (2 * cr) % width) * (32 * RQ) + 4 * ck,
            (2 * cr) / width);
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int q = 0; q < RQ; ++q)
            hopper::st_cluster(to + 4 * (c * 32 * RQ + 32 * q),
                       make_float4(pv[c][q][0], pv[c][q][1], pv[c][q][2],
                                   pv[c][q][3]));
        hopper::cluster_arrive();
      }
    }
  }
  if (WITH_V && cluster > 1 && t > 0) {
    hopper::cluster_wait();
    cluster_sum<RQ>(recv, (t - 1) & 1, v_target, col_begin + (t - 1) * kT64,
                    E, N, r, cluster);
  }

  // out_u itself with one split, else this split's partial plane.
  float* dst = out_u + (static_cast<size_t>(split) * E + e) * M * r;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int i = i0 + 2 * cr + c;
    if (i >= M) continue;
#pragma unroll
    for (int q = 0; q < RQ; ++q)
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int k = 4 * (ck + 8 * q) + s;
        if (k < r) dst[static_cast<size_t>(i) * r + k] = acc[c][q][s];
      }
  }

  if (WITH_DIAG) {
    // Block sum of the two scalars: a fixed tree over the 256 threads, in
    // the Psi^T tile once every thread is done with it.
    float* red = PsT;
    __syncthreads();
    red[threadIdx.x] = obj;
    red[kT64Threads + threadIdx.x] = psi2;
    __syncthreads();
    for (int s = kT64Threads / 2; s > 0; s >>= 1) {
      if (threadIdx.x < s) {
        red[threadIdx.x] += red[threadIdx.x + s];
        red[kT64Threads + threadIdx.x] += red[kT64Threads + threadIdx.x + s];
      }
      __syncthreads();
    }
    const int n_stripes = (M + kT64 - 1) / kT64;  // past it: idle blocks
    if (threadIdx.x == 0 && stripe < n_stripes) {
      const int blocks = n_stripes * gridDim.y;  // per client
      const int b = stripe * gridDim.y + split;
      diag_partial[static_cast<size_t>(e) * blocks + b] = red[0];
      diag_partial[static_cast<size_t>(E + e) * blocks + b] =
          red[kT64Threads];
    }
  }
}

// Ranks 257 .. 2048 (tile64.cuh's rank slices): one thread-block cluster of
// `cluster` blocks a (stripe, column split, client), block c owning the
// rank slice c (kernels/huber_contract.py::u_slices).  Its U stripe slice
// stays staged for the whole column range beside two V-slice stages, the
// tile's partial U_c V_c^T and Psi^T (tile64.cuh's cluster_smem_bytes):
// 227 KB at RQ = 8, one block an SM.

// Offset of entry (j, i) of a 64 x 64 tile stored transposed (row j holds
// column j of the tile, Psi^T and the partial) with row stride 64 and its
// entries XOR-swizzled by 4 (j % 8).  stripe_kernel's Psi^T pads its rows
// to 68 instead, which would take the cluster block 1 KB past the 227 KB:
// with the swizzle the 4 x 8 threads of a warp that store U V^T patches
// hit 32 banks, and every float4 along i (4 rows of one column: the Psi
// sum's, Psi V's and Psi^T U's accesses) stays contiguous.
__device__ __forceinline__ int swz_t(int j, int i) {
  return j * kT64 + (i ^ ((j & 7) << 2));
}

// Writes a thread's register block blk[cc][q][s] of the cluster kernel's
// contractions to rows row0 + 4 cq + cc (below rows) and ranks
// 4 (kl + 16 q) + s (below kw) of dst, row stride r: a float4 for each
// whole 4-rank group where dst's rows are 16-byte aligned, scalars
// otherwise.
template <int QH>
__device__ __forceinline__ void store_block(float* dst,
                                            const float (&blk)[4][QH][4],
                                            int row0, int rows, int r,
                                            int kw, int cq, int kl) {
  const bool vec = r % 4 == 0 && reinterpret_cast<uintptr_t>(dst) % 16 == 0;
#pragma unroll
  for (int cc = 0; cc < 4; ++cc) {
    const int i = row0 + 4 * cq + cc;
    if (i >= rows) continue;
#pragma unroll
    for (int q = 0; q < QH; ++q) {
      const int k = 4 * (kl + 16 * q);
      float* at = dst + static_cast<size_t>(i) * r + k;
      if (vec && k + 3 < kw) {
        *reinterpret_cast<float4*>(at) = make_float4(
            blk[cc][q][0], blk[cc][q][1], blk[cc][q][2], blk[cc][q][3]);
      } else {
#pragma unroll
        for (int s = 0; s < 4; ++s)
          if (k + s < kw) at[s] = blk[cc][q][s];
      }
    }
  }
}

// Grid (stripes x cluster, column splits, E), clusters (cluster, 1, 1):
// block x = cluster s + c writes the rank slice c of out_u[e] (and of the
// stripe's out_v plane) for stripe s.  Per 64-column tile of its range a
// block
//   1. loads its share of M (and W): columns [64 c / C, 64 (c + 1) / C) of
//      the tile (C = cluster: 22 + 21 + 21 at C = 3), a thread 4 rows of
//      one column, a warp's loads along rows;
//   2. waits for its V slice of the tile, and starts staging the next
//      tile's into the other stage (it lands under steps 3-5);
//   3. forms its partial U_c V_c^T (patch44 over its slice) in shared
//      memory, transposed; cluster barrier;
//   4. adds its share's entries of the C partials in slice order through
//      distributed shared memory, low = ((P_0 + P_1) + P_2) + ..., forms
//      R_W = W (M - low), Psi = clip(R_W, +-lam) and (WITH_DIAG) the
//      diagnostics of those entries, and writes them into every block's
//      Psi^T; cluster barrier;
//   5. contracts Psi V_c into a register block of 32 RQ ranks: each thread
//      4 rows x 4 rank groups a step (one float4 of Psi^T and four of V
//      for 64 FMAs); WITH_V also Psi^T U_c, this stripe's share of the
//      tile's out_v (4 columns x 4 rank groups, a 4 x 4 block of Psi^T
//      and 16 float4 of U for 256 FMAs a step of 4 rows).
// U V^T is formed once a tile, and each contraction covers the C slices
// once.  Each block sums a share of the entries rather than all of the
// tile: M and W are read once and a block moves 2 x 16 KB of distributed
// shared memory a tile whatever C.  The diagnostics sum over the entries
// a block formed, one partial a block (stripes x splits x C a client,
// summed in index order by the sum launch).  The dual's row groups are
// single stripes here (kernels/huber_contract.py::dual_plan).
template <int RQ, typename TM, int MASK, bool WITH_DIAG, bool WITH_V>
__global__ void __launch_bounds__(kT64Threads, 1)
stripe_cluster_kernel(const float* __restrict__ u,
                      const float* __restrict__ v, const TM* __restrict__ m,
                      const void* __restrict__ w,
                      const float* __restrict__ lam,
                      float* __restrict__ out_u,
                      float* __restrict__ diag_partial,
                      float* __restrict__ v_target, int E, int M, int N,
                      int r, int cols_per_split, int cluster, int slice) {
  constexpr int LD = ld64<RQ>();
  extern __shared__ float4 smem4[];
  float* Us = reinterpret_cast<float*>(smem4);  // kT64 x LD, U's slice
  float* Vring = Us + kT64 * LD;                // 2 x kT64 x LD, V's slice
  float* Pp = Vring + 2 * kT64 * LD;            // 64 x 64 partial (swz_t)
  float* PsT = Pp + kT64 * kT64;                // 64 x 64 Psi^T (swz_t)

  const int c = blockIdx.x % cluster;
  const int stripe = blockIdx.x / cluster;
  const int split = blockIdx.y, e = blockIdx.z;
  const int i0 = stripe * kT64;
  const int col_begin = split * cols_per_split;
  const int col_end = min(N, col_begin + cols_per_split);
  const float* ue = u + static_cast<size_t>(e) * M * r;
  const float* ve = v + static_cast<size_t>(e) * N * r;
  const ClientPlanes<TM, MASK> planes(m, w, e, M, N);
  const float lam_e = lam[e];
  const float half_lam2 = 0.5f * lam_e * lam_e;
  // This block's rank slice [k0, k0 + kw) and its rank groups of U V^T.
  const int k0 = c * slice, kw = min(slice, r - k0);
  const int w4 = (kw + 3) / 4;
  // This block's share of the tile: columns [share_col0, + ncols); thread
  // q < 16 ncols takes rows 4 (q / ncols) .. + 3 of column q % ncols of it
  // (g = 0, 1 for q = tid, tid + 256).
  const int share_col0 = c * kT64 / cluster;
  const int ncols = (c + 1) * kT64 / cluster - share_col0;
  int sj[2], si[2];
  bool sok[2];
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int q = threadIdx.x + kT64Threads * g;
    sok[g] = q < 16 * ncols;
    si[g] = 4 * (q / ncols);
    sj[g] = share_col0 + q % ncols;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // U V^T patch: rows ti + 16 a, columns tj + 16 b; a warp is 4 x 8 threads.
  const int ti = (warp >> 1) * 4 + (lane >> 3);
  const int tj = (warp & 1) * 8 + (lane & 7);
  // Contraction blocks: rows (Psi V) or columns (Psi^T U) 4 cq + cc, rank
  // groups kl + 16 q; kl < 8 (the groups an odd RQ leaves out of its last
  // q) holds for warps 0-3 alone, one of the two warps of each SM
  // sub-partition.
  const int cq = (warp & 1) * 8 + (lane >> 2);
  const int kl = (warp >> 1) * 4 + (lane & 3);

  // The columns past the slice's 4-rank groups are read only into register
  // columns that are never written out; zero them once all the same.
  zero_past_slice<RQ>(Us, 3 * kT64, w4);
  stage_slice<RQ>(Us, ue, i0, M, r, k0, kw);
  stage_slice<RQ>(Vring, ve, col_begin, N, r, k0, kw);
  cp_async_commit();

  constexpr int QH = (RQ + 1) / 2;  // 16 rank groups a step: 8 RQ in all
  float acc[4][QH][4];
#pragma unroll
  for (int cc = 0; cc < 4; ++cc)
#pragma unroll
    for (int q = 0; q < QH; ++q)
#pragma unroll
      for (int s = 0; s < 4; ++s) acc[cc][q][s] = 0.f;
  float obj = 0.f, psi2 = 0.f;

  for (int j0 = col_begin, t = 0; j0 < col_end; j0 += kT64, ++t) {
    const float* Vs = Vring + (t & 1) * kT64 * LD;
    // This thread's M (and W) entries of the share, loaded before the wait
    // and the FMAs that hide their latency.
    float x[2][4], wt[2][4];
#pragma unroll
    for (int g = 0; g < 2; ++g)
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        x[g][s] = wt[g][s] = 0.f;
        if (sok[g])
          planes.load(i0 + si[g] + s, j0 + sj[g], x[g][s], wt[g][s]);
      }
    cp_async_wait_all();
    __syncthreads();  // this tile's V slice staged; the last one's read
    if (j0 + kT64 < col_end) {
      stage_slice<RQ>(Vring + ((t + 1) & 1) * kT64 * LD, ve, j0 + kT64, N,
                      r, k0, kw);
      cp_async_commit();
    }

    float low[4][4];
    patch44<RQ, 4>(Us, Vs, ti, tj, w4, low);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        Pp[swz_t(tj + 16 * b, ti + 16 * a)] = low[a][b];
    hopper::cluster_sync();  // every block's partial written

#pragma unroll
    for (int g = 0; g < 2; ++g) {
      if (!sok[g]) continue;
      const int at = swz_t(sj[g], si[g]);
      const float4 lo = hopper::cluster_sum4(Pp + at, cluster);
      const float los[4] = {lo.x, lo.y, lo.z, lo.w};
      float ps[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const float rw = apply_mask<MASK>(wt[g][s], x[g][s] - los[s]);
        ps[s] = clip(rw, lam_e);
        if (WITH_DIAG) {
          const float ab = fabsf(rw);
          obj += (ab <= lam_e) ? 0.5f * rw * rw : lam_e * ab - half_lam2;
          psi2 = fmaf(ps[s], ps[s], psi2);
        }
      }
      hopper::cluster_store4(PsT + at, cluster,
                             make_float4(ps[0], ps[1], ps[2], ps[3]));
    }
    hopper::cluster_sync();  // Psi^T whole in every block; partials read

    // acc[cc][q] += sum_jj Psi[4 cq + cc, jj] * V[jj, k0 + 4 (kl + 16 q) ..]
    // (unrolled 16 deep: with store_block's float4 stores, the kernel ran
    // faster on an H100 than at 2, 4, 8, 32 or 64 deep, with the same bits)
#pragma unroll 16
    for (int jj = 0; jj < kT64; ++jj) {
      const float4 p =
          *reinterpret_cast<const float4*>(PsT + swz_t(jj, 4 * cq));
      const float pc[4] = {p.x, p.y, p.z, p.w};
      const float* vrow = Vs + jj * LD;
#pragma unroll
      for (int q = 0; q < QH; ++q) {
        if (RQ % 2 == 0 || q < QH - 1 || kl < 8) {
          const float4 vq =
              *reinterpret_cast<const float4*>(vrow + 4 * (kl + 16 * q));
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            acc[cc][q][0] = fmaf(pc[cc], vq.x, acc[cc][q][0]);
            acc[cc][q][1] = fmaf(pc[cc], vq.y, acc[cc][q][1]);
            acc[cc][q][2] = fmaf(pc[cc], vq.z, acc[cc][q][2]);
            acc[cc][q][3] = fmaf(pc[cc], vq.w, acc[cc][q][3]);
          }
        }
      }
    }

    if constexpr (WITH_V) {
      // pv[cc][q] = sum_ii Psi[ii, 4 cq + cc] * U[ii, k0 + 4 (kl + 16 q) ..]:
      // this stripe's share of out_v for the tile's 64 columns, ranks of
      // slice c, written to the stripe's own plane.
      float pv[4][QH][4];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
#pragma unroll
        for (int q = 0; q < QH; ++q)
#pragma unroll
          for (int s = 0; s < 4; ++s) pv[cc][q][s] = 0.f;
      for (int ii = 0; ii < kT64; ii += 4) {
        float4 p[4];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
          p[cc] = *reinterpret_cast<const float4*>(PsT +
                                                   swz_t(4 * cq + cc, ii));
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          float a[4];
#pragma unroll
          for (int cc = 0; cc < 4; ++cc)
            a[cc] = h == 0 ? p[cc].x : h == 1 ? p[cc].y
                  : h == 2 ? p[cc].z : p[cc].w;
          const float* urow = Us + (ii + h) * LD;
#pragma unroll
          for (int q = 0; q < QH; ++q) {
            if (RQ % 2 == 0 || q < QH - 1 || kl < 8) {
              const float4 uq =
                  *reinterpret_cast<const float4*>(urow + 4 * (kl + 16 * q));
#pragma unroll
              for (int cc = 0; cc < 4; ++cc) {
                pv[cc][q][0] = fmaf(a[cc], uq.x, pv[cc][q][0]);
                pv[cc][q][1] = fmaf(a[cc], uq.y, pv[cc][q][1]);
                pv[cc][q][2] = fmaf(a[cc], uq.z, pv[cc][q][2]);
                pv[cc][q][3] = fmaf(a[cc], uq.w, pv[cc][q][3]);
              }
            }
          }
        }
      }
      store_block<QH>(
          v_target + (static_cast<size_t>(stripe) * E + e) * N * r + k0, pv,
          j0, N, r, kw, cq, kl);
    }
  }

  // out_u itself with one split, else this split's partial plane.
  store_block<QH>(out_u + (static_cast<size_t>(split) * E + e) * M * r + k0,
                  acc, i0, M, r, kw, cq, kl);

  if (WITH_DIAG) {
    // Block sum of the two scalars, as stripe_kernel's, in the partial
    // tile: after the last cluster barrier nobody reads it.
    float* red = Pp;
    red[threadIdx.x] = obj;
    red[kT64Threads + threadIdx.x] = psi2;
    __syncthreads();
    for (int s = kT64Threads / 2; s > 0; s >>= 1) {
      if (threadIdx.x < s) {
        red[threadIdx.x] += red[threadIdx.x + s];
        red[kT64Threads + threadIdx.x] += red[kT64Threads + threadIdx.x + s];
      }
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      const int blocks = gridDim.x * gridDim.y;  // per client
      const int b = (stripe * gridDim.y + split) * cluster + c;
      diag_partial[static_cast<size_t>(e) * blocks + b] = red[0];
      diag_partial[static_cast<size_t>(E + e) * blocks + b] =
          red[kT64Threads];
    }
  }
}

// Ranks above 2048 in chunks of 256 (tile64.cuh): one chunk of U and one
// of V at a time, Psi^T.  147 KB: one block an SM.
__host__ __device__ constexpr size_t stripe_chunk_smem_bytes() {
  return sizeof(float) * (2 * kT64 * ld64<kChunkRQ>() + kT64 * kPsiTLd);
}

// Grid (stripes x chunks, column splits, E): block x = C s + c writes the
// rank chunk c of out_u[e] (and of its out_v plane) for stripe s (C =
// rank_chunks(r)).  Per column tile each block forms the tile's whole Psi
// (U V^T over every chunk, in chunk order: chunked_low), stages V's (and
// for out_v U's) chunk c again unless it is the last one (still staged),
// and contracts.  The scalars come from the same Psi in every block; the
// c = 0 block writes them.  The dual's row groups are single stripes.  Its
// U V^T work is C times one pass's; at r 449-512 (the cluster limit
// lowered) it gives the cluster kernel's out_u and out_v bits with slices
// of 256.
template <typename TM, int MASK, bool WITH_DIAG, bool WITH_V>
__global__ void __launch_bounds__(kT64Threads, 1)
stripe_chunk_kernel(const float* __restrict__ u, const float* __restrict__ v,
                    const TM* __restrict__ m, const void* __restrict__ w,
                    const float* __restrict__ lam, float* __restrict__ out_u,
                    float* __restrict__ diag_partial,
                    float* __restrict__ v_target, int E, int M, int N, int r,
                    int cols_per_split, int cluster) {
  constexpr int RQ = kChunkRQ;
  constexpr int LD = ld64<RQ>();
  extern __shared__ float4 smem4[];
  float* Us = reinterpret_cast<float*>(smem4);  // kT64 x LD, one chunk
  float* Vs = Us + kT64 * LD;                   // kT64 x LD, one chunk
  float* PsT = Vs + kT64 * LD;                  // kT64 x kPsiTLd

  const int chunks = rank_chunks(r);
  const int c = blockIdx.x % chunks;
  const int stripe = blockIdx.x / chunks;
  const int split = blockIdx.y, e = blockIdx.z;
  const int i0 = stripe * kT64;
  const int col_begin = split * cols_per_split;
  const int col_end = min(N, col_begin + cols_per_split);
  const float* ue = u + static_cast<size_t>(e) * M * r;
  const float* ve = v + static_cast<size_t>(e) * N * r;
  const ClientPlanes<TM, MASK> planes(m, w, e, M, N);
  const float lam_e = lam[e];
  const float half_lam2 = 0.5f * lam_e * lam_e;
  // This block's output chunk [ck, ck + cw).
  const int ck = c * kRankChunk, cw = min(kRankChunk, r - ck);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ti = (warp >> 1) * 4 + (lane >> 3);
  const int tj = (warp & 1) * 8 + (lane & 7);
  const int cr = warp * 4 + (lane >> 3);
  const int ckq = lane & 7;

  float acc[2][RQ][4];
#pragma unroll
  for (int cc = 0; cc < 2; ++cc)
#pragma unroll
    for (int q = 0; q < RQ; ++q)
#pragma unroll
      for (int s = 0; s < 4; ++s) acc[cc][q][s] = 0.f;
  float obj = 0.f, psi2 = 0.f;

  for (int j0 = col_begin; j0 < col_end; j0 += kT64) {
    float x[4][4], wt[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        planes.load(i0 + ti + 16 * a, j0 + tj + 16 * b, x[a][b], wt[a][b]);
    float low[4][4];
    chunked_low(Us, Vs, ue, ve, i0, M, j0, N, r, ti, tj, low);
    if (c != chunks - 1) {
      if (WITH_V) stage_window<RQ>(Us, ue, i0, M, r, ck, cw);
      stage_window<RQ>(Vs, ve, j0, N, r, ck, cw);
      cp_async_commit();
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float rw = apply_mask<MASK>(wt[a][b], x[a][b] - low[a][b]);
        const float psi = clip(rw, lam_e);
        if (WITH_DIAG) {
          const float ab = fabsf(rw);
          obj += (ab <= lam_e) ? 0.5f * rw * rw : lam_e * ab - half_lam2;
          psi2 = fmaf(psi, psi, psi2);
        }
        PsT[(tj + 16 * b) * kPsiTLd + ti + 16 * a] = psi;
      }
    cp_async_wait_all();
    __syncthreads();  // Psi^T written, the chunk c of V (and U) staged

    // acc[cc][q] += sum_jj Psi[2 cr + cc, jj] * V[jj, ck + 4 (ckq + 8 q) ..]
    for (int jj = 0; jj < kT64; ++jj) {
      const float2 p =
          *reinterpret_cast<const float2*>(PsT + jj * kPsiTLd + 2 * cr);
      const float* vrow = Vs + jj * LD;
#pragma unroll
      for (int q = 0; q < RQ; ++q) {
        const float4 vq =
            *reinterpret_cast<const float4*>(vrow + 4 * (ckq + 8 * q));
        acc[0][q][0] = fmaf(p.x, vq.x, acc[0][q][0]);
        acc[0][q][1] = fmaf(p.x, vq.y, acc[0][q][1]);
        acc[0][q][2] = fmaf(p.x, vq.z, acc[0][q][2]);
        acc[0][q][3] = fmaf(p.x, vq.w, acc[0][q][3]);
        acc[1][q][0] = fmaf(p.y, vq.x, acc[1][q][0]);
        acc[1][q][1] = fmaf(p.y, vq.y, acc[1][q][1]);
        acc[1][q][2] = fmaf(p.y, vq.z, acc[1][q][2]);
        acc[1][q][3] = fmaf(p.y, vq.w, acc[1][q][3]);
      }
    }

    if constexpr (WITH_V) {
      // This stripe's share of out_v[e] for the tile's 64 columns, ranks
      // of chunk c, written to the stripe's own plane.
      float pv[2][RQ][4];
#pragma unroll
      for (int cc = 0; cc < 2; ++cc)
#pragma unroll
        for (int q = 0; q < RQ; ++q)
#pragma unroll
          for (int s = 0; s < 4; ++s) pv[cc][q][s] = 0.f;
      const float* p0row = PsT + (2 * cr) * kPsiTLd;
      const float* p1row = p0row + kPsiTLd;
      for (int ii = 0; ii < kT64; ii += 2) {
        const float2 p0 = *reinterpret_cast<const float2*>(p0row + ii);
        const float2 p1 = *reinterpret_cast<const float2*>(p1row + ii);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float a0 = hh ? p0.y : p0.x;
          const float a1 = hh ? p1.y : p1.x;
          const float* urow = Us + (ii + hh) * LD;
#pragma unroll
          for (int q = 0; q < RQ; ++q) {
            const float4 uq =
                *reinterpret_cast<const float4*>(urow + 4 * (ckq + 8 * q));
            pv[0][q][0] = fmaf(a0, uq.x, pv[0][q][0]);
            pv[0][q][1] = fmaf(a0, uq.y, pv[0][q][1]);
            pv[0][q][2] = fmaf(a0, uq.z, pv[0][q][2]);
            pv[0][q][3] = fmaf(a0, uq.w, pv[0][q][3]);
            pv[1][q][0] = fmaf(a1, uq.x, pv[1][q][0]);
            pv[1][q][1] = fmaf(a1, uq.y, pv[1][q][1]);
            pv[1][q][2] = fmaf(a1, uq.z, pv[1][q][2]);
            pv[1][q][3] = fmaf(a1, uq.w, pv[1][q][3]);
          }
        }
      }
      float* dst =
          v_target + (static_cast<size_t>(stripe) * E + e) * N * r + ck;
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int j = j0 + 2 * cr + cc;
        if (j >= N) continue;
#pragma unroll
        for (int q = 0; q < RQ; ++q)
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const int k = 4 * (ckq + 8 * q) + s;
            if (k < cw) dst[static_cast<size_t>(j) * r + k] = pv[cc][q][s];
          }
      }
    }
    __syncthreads();  // nobody reads these chunks or Psi^T any more
  }

  // out_u itself with one split, else this split's partial plane.
  float* dst =
      out_u + (static_cast<size_t>(split) * E + e) * M * r + ck;
#pragma unroll
  for (int cc = 0; cc < 2; ++cc) {
    const int i = i0 + 2 * cr + cc;
    if (i >= M) continue;
#pragma unroll
    for (int q = 0; q < RQ; ++q)
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int k = 4 * (ckq + 8 * q) + s;
        if (k < cw) dst[static_cast<size_t>(i) * r + k] = acc[cc][q][s];
      }
  }

  if (WITH_DIAG && c == 0) {
    // Block sum of the two scalars, as stripe_kernel's (after the last
    // barrier of the tile loop, nobody reads Psi^T).
    float* red = PsT;
    red[threadIdx.x] = obj;
    red[kT64Threads + threadIdx.x] = psi2;
    __syncthreads();
    for (int s = kT64Threads / 2; s > 0; s >>= 1) {
      if (threadIdx.x < s) {
        red[threadIdx.x] += red[threadIdx.x + s];
        red[kT64Threads + threadIdx.x] += red[kT64Threads + threadIdx.x + s];
      }
      __syncthreads();
    }
    const int n_stripes = (M + kT64 - 1) / kT64;
    if (threadIdx.x == 0 && stripe < n_stripes) {
      const int blocks = n_stripes * gridDim.y;
      const int b = stripe * gridDim.y + split;
      diag_partial[static_cast<size_t>(e) * blocks + b] = red[0];
      diag_partial[static_cast<size_t>(E + e) * blocks + b] =
          red[kT64Threads];
    }
  }
}

// Number of 64-row stripes.
inline int stripes(int M) { return (M + kT64 - 1) / kT64; }

// Whether the column splits and row groups describe a launch: the splits'
// column ranges whole 64-column tiles, none empty; WITH_V `groups`
// clusters of `cluster` stripes (1, 2, 4 or 8), together every stripe,
// none empty.
inline bool stripe_layout_valid(int M, int N, int splits, int cols_per_split,
                                int cluster, int groups) {
  const int tiles = stripes(M);
  return splits >= 1 && cols_per_split % kT64 == 0 &&
         (splits - 1) * cols_per_split < N &&
         static_cast<long long>(splits) * cols_per_split >= N &&
         (cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8) &&
         groups >= 1 && groups * cluster >= tiles &&
         (groups - 1) * cluster < tiles;
}

// One launch of the fixed-order sums of a stripe kernel's partials that the
// flavour needs: out_u from u_partial (splits > 1), out_v from v_partial
// (WITH_V, groups > 1), obj and psi2 from diag_partial (WITH_DIAG; `blocks`
// partials a client).  u_partial holds splits E M r floats, v_partial
// groups E N r, diag_partial 2 E blocks.
template <bool WITH_DIAG, bool WITH_V>
cudaError_t launch_stripe_sums(float* out_u, float* out_v, float* obj,
                               float* psi2, const float* diag_partial,
                               const float* u_partial,
                               const float* v_partial, int E, int M, int N,
                               int r, int splits, int groups, size_t blocks,
                               cudaStream_t stream) {
  SumJobs jobs{};
  if (splits > 1)
    jobs.job[jobs.n++] = sum_over_splits(
        u_partial, out_u, static_cast<size_t>(E) * M * r, splits);
  if (WITH_V && groups > 1)
    jobs.job[jobs.n++] = sum_over_splits(
        v_partial, out_v, static_cast<size_t>(E) * N * r, groups);
  if (WITH_DIAG) {
    // diag_partial: (2, E, blocks).
    jobs.job[jobs.n++] = SumJob{diag_partial, obj, static_cast<size_t>(E),
                                blocks, 1, static_cast<int>(blocks)};
    jobs.job[jobs.n++] = SumJob{diag_partial + E * blocks, psi2,
                                static_cast<size_t>(E), blocks, 1,
                                static_cast<int>(blocks)};
  }
  return jobs.n > 0 ? launch_sums(jobs, stream) : cudaSuccess;
}

// stripe_kernel (RQ <= 8) or stripe_chunk_kernel (RQ == kChunked), then the
// sums.  WITH_V takes kernels/huber_contract.py::dual_plan's row groups
// (clusters of stripes only for stripe_kernel); the u flavours one stripe a
// block.  diag_partial holds 2 E stripes splits floats.
template <int RQ, typename TM, int MASK, bool WITH_DIAG, bool WITH_V>
cudaError_t launch_stripe(const float* u, const float* v, const TM* m,
                          const void* w, const float* lam, float* out_u,
                          float* out_v, float* obj, float* psi2,
                          float* diag_partial, float* u_partial,
                          float* v_partial, int E, int M, int N, int r,
                          int splits, int cols_per_split, int cluster,
                          int groups, cudaStream_t stream) {
  const int tiles = stripes(M);
  if (!WITH_V) {
    cluster = 1;
    groups = tiles;
  }
  constexpr bool kChunks = RQ == kChunked;
  if (!stripe_layout_valid(M, N, splits, cols_per_split, cluster, groups) ||
      (kChunks && cluster != 1))
    return cudaErrorInvalidValue;
  auto kernel = stripe_chunk_kernel<TM, MASK, WITH_DIAG, WITH_V>;
  size_t smem = stripe_chunk_smem_bytes();
  if constexpr (!kChunks) {
    kernel = stripe_kernel<RQ, TM, MASK, WITH_DIAG, WITH_V>;
    smem = stripe_smem_bytes<RQ, stripe_stages<RQ, WITH_V>()>() +
           (cluster > 1 ? sizeof(float) * recv_floats<RQ>() : 0);
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  float* u_dst = splits == 1 ? out_u : u_partial;
  float* v_dst = groups > 1 ? v_partial : out_v;
  const dim3 grid(groups * cluster * (kChunks ? rank_chunks(r) : 1), splits,
                  E);
  if (cluster == 1) {
    kernel<<<grid, kT64Threads, smem, stream>>>(
        u, v, m, w, lam, u_dst, diag_partial, v_dst, E, M, N, r,
        cols_per_split, cluster);
  } else {
    cudaLaunchAttribute attr[2];
    cudaLaunchConfig_t config =
        cluster_launch_config(attr, grid, cluster, smem, stream);
    attr[1].id = cudaLaunchAttributeClusterSchedulingPolicyPreference;
    attr[1].val.clusterSchedulingPolicyPreference =
        cudaClusterSchedulingPolicyLoadBalancing;
    config.numAttrs = 2;
    err = cudaLaunchKernelEx(&config, kernel, u, v, m, w, lam, u_dst,
                             diag_partial, v_dst, E, M, N, r,
                             cols_per_split, cluster);
    if (err != cudaSuccess) return err;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_stripe_sums<WITH_DIAG, WITH_V>(
      out_u, out_v, obj, psi2, diag_partial, u_partial, v_partial, E, M, N,
      r, splits, groups, static_cast<size_t>(tiles) * splits, stream);
}

// stripe_cluster_kernel with rank slices of `slice` over clusters of
// `slices` blocks, then the sums.  WITH_V's row groups are single stripes
// (cluster 1, groups = stripes); diag_partial holds 2 E stripes splits
// slices floats.
template <int RQ, typename TM, int MASK, bool WITH_DIAG, bool WITH_V>
cudaError_t launch_stripe_cluster(const float* u, const float* v,
                                  const TM* m, const void* w,
                                  const float* lam, float* out_u,
                                  float* out_v, float* obj, float* psi2,
                                  float* diag_partial, float* u_partial,
                                  float* v_partial, int E, int M, int N,
                                  int r, int splits, int cols_per_split,
                                  int cluster, int groups, int slices,
                                  int slice, cudaStream_t stream) {
  const int tiles = stripes(M);
  if (!WITH_V) {
    cluster = 1;
    groups = tiles;
  }
  if (!stripe_layout_valid(M, N, splits, cols_per_split, cluster, groups) ||
      cluster != 1)
    return cudaErrorInvalidValue;
  auto kernel = stripe_cluster_kernel<RQ, TM, MASK, WITH_DIAG, WITH_V>;
  constexpr size_t smem = cluster_smem_bytes<RQ>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  float* u_dst = splits == 1 ? out_u : u_partial;
  float* v_dst = groups > 1 ? v_partial : out_v;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t config = cluster_launch_config(
      attr, dim3(tiles * slices, splits, E), slices, smem, stream);
  err = cudaLaunchKernelEx(&config, kernel, u, v, m, w, lam, u_dst,
                           diag_partial, v_dst, E, M, N, r, cols_per_split,
                           slices, slice);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_stripe_sums<WITH_DIAG, WITH_V>(
      out_u, out_v, obj, psi2, diag_partial, u_partial, v_partial, E, M, N,
      r, splits, groups, static_cast<size_t>(tiles) * splits * slices,
      stream);
}

// The C entries' launch of one flavour: m is fp32 or bf16 (dtype code), w
// null, dense or packed (mask code, tile.cuh).  r <= 256 takes one register
// block (stripe_kernel); above, slices > 0 the cluster kernel with rank
// slices of `slice` (slices_valid), slices == 0 the chunks of 256
// (stripe_chunk_kernel: kernels/_launch.py::u_chunked).  Returns
// cudaGetLastError() of the launches (0 on success).
template <bool WITH_DIAG, bool WITH_V>
int stripe_entry(const float* u, const float* v, const void* m,
                 const void* w, const float* lam, float* out_u,
                 float* out_v, float* obj, float* psi2, float* diag_partial,
                 float* u_partial, float* v_partial, int E, int M, int N,
                 int r, int dtype, int mask, int splits, int cols_per_split,
                 int cluster, int groups, int slices, int slice,
                 void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (r > kRankChunk && slices > 0) {
    if (!slices_valid(r, slices, slice))
      return static_cast<int>(cudaErrorInvalidValue);
    // One register block of the slice's width: RQ = ceil(slice / 32).
    return dispatch(slice, dtype, mask, [&](auto rq, auto tm, auto mk) {
      using TM = typename decltype(tm)::type;
      constexpr int RQ = decltype(rq)::value;
      if constexpr (RQ >= kClusterMinRQ && RQ <= 8)
        return launch_stripe_cluster<RQ, TM, decltype(mk)::value, WITH_DIAG,
                                     WITH_V>(
            u, v, static_cast<const TM*>(m), w, lam, out_u, out_v, obj,
            psi2, diag_partial, u_partial, v_partial, E, M, N, r, splits,
            cols_per_split, cluster, groups, slices, slice, st);
      else
        return cudaErrorInvalidValue;
    });
  }
  return dispatch(r, dtype, mask, [&](auto rq, auto tm, auto mk) {
    using TM = typename decltype(tm)::type;
    constexpr int RQ = decltype(rq)::value;
    return launch_stripe<RQ, TM, decltype(mk)::value, WITH_DIAG, WITH_V>(
        u, v, static_cast<const TM*>(m), w, lam, out_u, out_v, obj, psi2,
        diag_partial, u_partial, v_partial, E, M, N, r, splits,
        cols_per_split, cluster, groups, st);
  });
}

// The most clusters of `cluster` blocks of stripe_cluster_kernel (this
// flavour, rank slices of `slice`) resident at once on the current device
// (cudaOccupancyMaxActiveClusters), or -1 on an error.
template <bool WITH_DIAG, bool WITH_V>
int stripe_cluster_slots(int cluster, int slice) {
  int slots = -1;
  dispatch(slice, kFloat32, kNoMask, [&](auto rq, auto, auto) {
    constexpr int RQ = decltype(rq)::value;
    if constexpr (RQ >= kClusterMinRQ && RQ <= 8)
      slots = max_active_clusters(
          stripe_cluster_kernel<RQ, float, kNoMask, WITH_DIAG, WITH_V>,
          cluster_smem_bytes<RQ>(), cluster);
    return cudaSuccess;
  });
  return slots;
}

}  // namespace repro
