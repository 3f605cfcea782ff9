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
// register blocks cover 32 RQ ranks.  Ranks 257-512 (stripe_wide_kernel)
// take the rank axis in two halves (tile64.cuh): a grid axis over the
// output's rank halves, each block forming the tile's whole Psi and
// contracting it against its half of V (and of U for out_v).  Ranks above
// 512 (stripe_chunk_kernel) take it in chunks of 256 the same way, the
// chunk axis folded into the grid's x, each chunk's U and V staged in turn.
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

// Ranks 257 .. 512 in two halves (tile64.cuh): U's two halves (staged once),
// one half of a V tile, Psi^T.  217 KB at RQH = 8: one block an SM.
template <int RQH>
__host__ __device__ constexpr size_t stripe_wide_smem_bytes() {
  return sizeof(float) * (3 * kT64 * ld64<RQH>() + kT64 * kPsiTLd);
}

// Grid (stripes, column splits, 2 E): block z = 2 e + h writes the rank
// half h of out_u[e] (and of its out_v plane), ranks [h k0, ...) with
// k0 = 32 RQH.  Each of the two blocks of a stripe forms the whole Psi of a
// tile (U V^T over both halves: its only redundant work) and contracts it
// against its half of V (and of U).  Per column tile: V's other half is
// staged (under the previous tile's end), its patch summed; then V's own
// half, its patch, Psi^T, Psi V_h (and Psi^T U_h).  The scalars come from
// the same Psi in both blocks; the h = 0 block writes them.  The dual's
// row groups are single stripes here (no room for a cluster's receive
// buffers: kernels/huber_contract.py::dual_plan).
template <int RQH, typename TM, int MASK, bool WITH_DIAG, bool WITH_V>
__global__ void __launch_bounds__(kT64Threads, 1)
stripe_wide_kernel(const float* __restrict__ u, const float* __restrict__ v,
                   const TM* __restrict__ m, const void* __restrict__ w,
                   const float* __restrict__ lam, float* __restrict__ out_u,
                   float* __restrict__ diag_partial,
                   float* __restrict__ v_target, int E, int M, int N, int r,
                   int cols_per_split, int cluster) {
  constexpr int LD = ld64<RQH>();
  constexpr int K0 = wide_half(RQH);
  extern __shared__ float4 smem4[];
  float* Ua = reinterpret_cast<float*>(smem4);  // kT64 x LD, ranks < K0
  float* Ub = Ua + kT64 * LD;                   // kT64 x LD, ranks >= K0
  float* Vs = Ub + kT64 * LD;                   // kT64 x LD, one half
  float* PsT = Vs + kT64 * LD;                  // kT64 x kPsiTLd

  const int stripe = blockIdx.x, split = blockIdx.y;
  const int e = blockIdx.z >> 1, h = blockIdx.z & 1;
  const int i0 = stripe * kT64;
  const int col_begin = split * cols_per_split;
  const int col_end = min(N, col_begin + cols_per_split);
  const float* ue = u + static_cast<size_t>(e) * M * r;
  const float* ve = v + static_cast<size_t>(e) * N * r;
  const ClientPlanes<TM, MASK> planes(m, w, e, M, N);
  const float lam_e = lam[e];
  const float half_lam2 = 0.5f * lam_e * lam_e;
  // This block's rank half [hk, hk + hw) and the other one [ok, ok + ow).
  const int hk = h ? K0 : 0, hw = h ? r - K0 : K0;
  const int ok = h ? 0 : K0, ow = h ? K0 : r - K0;
  const float* u_own = h ? Ub : Ua;
  const float* u_other = h ? Ua : Ub;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ti = (warp >> 1) * 4 + (lane >> 3);
  const int tj = (warp & 1) * 8 + (lane & 7);
  const int cr = warp * 4 + (lane >> 3);
  const int ck = lane & 7;

  stage_window<RQH>(Ua, ue, i0, M, r, 0, K0);
  stage_window<RQH>(Ub, ue, i0, M, r, K0, r - K0);
  stage_window<RQH>(Vs, ve, col_begin, N, r, ok, ow);
  cp_async_commit();

  float acc[2][RQH][4];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int q = 0; q < RQH; ++q)
#pragma unroll
      for (int s = 0; s < 4; ++s) acc[c][q][s] = 0.f;
  float obj = 0.f, psi2 = 0.f;

  for (int j0 = col_begin; j0 < col_end; j0 += kT64) {
    float x[4][4], wt[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        planes.load(i0 + ti + 16 * a, j0 + tj + 16 * b, x[a][b], wt[a][b]);
    cp_async_wait_all();
    __syncthreads();  // V's other half of this tile (and U) staged
    float lo[4][4], lh[4][4];
    patch44<RQH>(u_other, Vs, ti, tj, (ow + 3) / 4, lo);
    __syncthreads();  // nobody reads V's other half any more
    stage_window<RQH>(Vs, ve, j0, N, r, hk, hw);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    patch44<RQH>(u_own, Vs, ti, tj, (hw + 3) / 4, lh);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float rw = apply_mask<MASK>(
            wt[a][b], x[a][b] - (lo[a][b] + lh[a][b]));
        const float psi = clip(rw, lam_e);
        if (WITH_DIAG) {
          const float ab = fabsf(rw);
          obj += (ab <= lam_e) ? 0.5f * rw * rw : lam_e * ab - half_lam2;
          psi2 = fmaf(psi, psi, psi2);
        }
        PsT[(tj + 16 * b) * kPsiTLd + ti + 16 * a] = psi;
      }
    __syncthreads();

    // acc[c][q] += sum_jj Psi[2 cr + c, jj] * V[jj, hk + 4 (ck + 8 q) ..]
    for (int jj = 0; jj < kT64; ++jj) {
      const float2 p =
          *reinterpret_cast<const float2*>(PsT + jj * kPsiTLd + 2 * cr);
      const float* vrow = Vs + jj * LD;
#pragma unroll
      for (int q = 0; q < RQH; ++q) {
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

    if constexpr (WITH_V) {
      // This stripe's share of out_v[e] for the tile's 64 columns, ranks
      // of half h, written to the stripe's own plane.
      float pv[2][RQH][4];
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int q = 0; q < RQH; ++q)
#pragma unroll
          for (int s = 0; s < 4; ++s) pv[c][q][s] = 0.f;
      const float* p0row = PsT + (2 * cr) * kPsiTLd;
      const float* p1row = p0row + kPsiTLd;
      for (int ii = 0; ii < kT64; ii += 2) {
        const float2 p0 = *reinterpret_cast<const float2*>(p0row + ii);
        const float2 p1 = *reinterpret_cast<const float2*>(p1row + ii);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float a0 = hh ? p0.y : p0.x;
          const float a1 = hh ? p1.y : p1.x;
          const float* urow = u_own + (ii + hh) * LD;
#pragma unroll
          for (int q = 0; q < RQH; ++q) {
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
      float* dst =
          v_target + (static_cast<size_t>(stripe) * E + e) * N * r + hk;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = j0 + 2 * cr + c;
        if (j >= N) continue;
#pragma unroll
        for (int q = 0; q < RQH; ++q)
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const int k = 4 * (ck + 8 * q) + s;
            if (k < hw) dst[static_cast<size_t>(j) * r + k] = pv[c][q][s];
          }
      }
    }
    __syncthreads();  // nobody reads this V half or Psi^T any more
    if (j0 + kT64 < col_end) {
      stage_window<RQH>(Vs, ve, j0 + kT64, N, r, ok, ow);
      cp_async_commit();
    }
  }

  // out_u itself with one split, else this split's partial plane.
  float* dst =
      out_u + (static_cast<size_t>(split) * E + e) * M * r + hk;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int i = i0 + 2 * cr + c;
    if (i >= M) continue;
#pragma unroll
    for (int q = 0; q < RQH; ++q)
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int k = 4 * (ck + 8 * q) + s;
        if (k < hw) dst[static_cast<size_t>(i) * r + k] = acc[c][q][s];
      }
  }

  if (WITH_DIAG && h == 0) {
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

// Ranks above 512 in chunks of 256 (tile64.cuh): one chunk of U and one of
// V at a time, Psi^T.  147 KB: one block an SM.
__host__ __device__ constexpr size_t stripe_chunk_smem_bytes() {
  return sizeof(float) * (2 * kT64 * ld64<kChunkRQ>() + kT64 * kPsiTLd);
}

// Grid (stripes x chunks, column splits, E): block x = C s + c writes the
// rank chunk c of out_u[e] (and of its out_v plane) for stripe s (C =
// rank_chunks(r)).  Per column tile each block forms the tile's whole Psi
// (U V^T over every chunk, in chunk order: chunked_low), stages V's (and
// for out_v U's) chunk c again unless it is the last one (still staged),
// and contracts.  The scalars come from the same Psi in every block; the
// c = 0 block writes them.  The dual's row groups are single stripes (as
// in stripe_wide_kernel).
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

// Number of 64-row stripes.  diag_partial holds 2 E stripes splits floats,
// u_partial splits E M r (when splits > 1), v_partial groups E N r (when
// groups > 1).
inline int stripes(int M) { return (M + kT64 - 1) / kT64; }

// The stripe kernel, then one launch of the fixed-order sums of its
// partials: out_u from u_partial (splits > 1), out_v from v_partial
// (WITH_V, groups > 1), obj and psi2 from diag_partial (WITH_DIAG).  The
// splits' column ranges are whole 64-column tiles, none empty.  WITH_V
// takes kernels/huber_contract.py::dual_plan's row groups: `groups`
// clusters of `cluster` stripes (1, 2, 4 or 8), together every stripe,
// none empty; the u flavours one stripe a block.
template <int RQ, typename TM, int MASK, bool WITH_DIAG, bool WITH_V>
cudaError_t launch_stripe(const float* u, const float* v, const TM* m,
                          const void* w, const float* lam, float* out_u,
                          float* out_v, float* obj, float* psi2,
                          float* diag_partial, float* u_partial,
                          float* v_partial, int E, int M, int N, int r,
                          int splits, int cols_per_split,
                          cudaStream_t stream, int cluster = 1,
                          int groups = 0) {
  const int tiles = stripes(M);
  if (!WITH_V) {
    cluster = 1;
    groups = tiles;
  }
  if (splits < 1 || cols_per_split % kT64 != 0 ||
      (splits - 1) * cols_per_split >= N ||
      static_cast<long long>(splits) * cols_per_split < N ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) ||
      groups < 1 || groups * cluster < tiles ||
      (groups - 1) * cluster >= tiles)
    return cudaErrorInvalidValue;
  // RQ > 8: two rank halves of RQ / 2 register groups; kChunked: chunks
  // of 256 (tile.cuh's by_rank); either way one stripe a row group.
  constexpr bool kChunks = RQ == kChunked;
  constexpr bool kWide = RQ > 8;
  if ((kWide || kChunks) && cluster != 1) return cudaErrorInvalidValue;
  auto kernel = stripe_chunk_kernel<TM, MASK, WITH_DIAG, WITH_V>;
  size_t smem = stripe_chunk_smem_bytes();
  if constexpr (kWide) {
    kernel = stripe_wide_kernel<RQ / 2, TM, MASK, WITH_DIAG, WITH_V>;
    smem = stripe_wide_smem_bytes<RQ / 2>();
  } else if constexpr (!kChunks) {
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
                  kWide ? 2 * E : E);
  if (cluster == 1) {
    kernel<<<grid, kT64Threads, smem, stream>>>(
        u, v, m, w, lam, u_dst, diag_partial, v_dst, E, M, N, r,
        cols_per_split, cluster);
  } else {
    cudaLaunchConfig_t config = {};
    config.gridDim = grid;
    config.blockDim = dim3(kT64Threads);
    config.dynamicSmemBytes = smem;
    config.stream = stream;
    cudaLaunchAttribute attr[2];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    attr[1].id = cudaLaunchAttributeClusterSchedulingPolicyPreference;
    attr[1].val.clusterSchedulingPolicyPreference =
        cudaClusterSchedulingPolicyLoadBalancing;
    config.attrs = attr;
    config.numAttrs = 2;
    err = cudaLaunchKernelEx(&config, kernel, u, v, m, w, lam, u_dst,
                             diag_partial, v_dst, E, M, N, r,
                             cols_per_split, cluster);
    if (err != cudaSuccess) return err;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // One launch of the fixed-order sums that this flavour needs.
  SumJobs jobs{};
  if (splits > 1)
    jobs.job[jobs.n++] = sum_over_splits(
        u_partial, out_u, static_cast<size_t>(E) * M * r, splits);
  if (WITH_V && groups > 1)
    jobs.job[jobs.n++] = sum_over_splits(
        v_partial, out_v, static_cast<size_t>(E) * N * r, groups);
  if (WITH_DIAG) {
    // diag_partial: (2, E, blocks) with blocks = tiles * splits a client.
    const size_t blocks = static_cast<size_t>(tiles) * splits;
    jobs.job[jobs.n++] = SumJob{diag_partial, obj, static_cast<size_t>(E),
                                blocks, 1, static_cast<int>(blocks)};
    jobs.job[jobs.n++] = SumJob{diag_partial + E * blocks, psi2,
                                static_cast<size_t>(E), blocks, 1,
                                static_cast<int>(blocks)};
  }
  if (jobs.n > 0) err = launch_sums(jobs, stream);
  return err;
}

}  // namespace repro
