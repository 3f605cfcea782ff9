// Causal or full softmax attention, forward only, with the online-softmax
// recurrence: the S_q x S_kv scores never reach device memory.
//
//   O[b, i, h] = sum_j softmax_j(scale * Q[b, i, h] . K[b, j, h]) V[b, j, h]
//
// replaces repro/kernels/flash_attention.py::flash_attention (:85, kernel
// _flash_kernel :37).  Layout as the reference's public function: Q, K, V and
// O are (B, S, H, d) row-major with the GQA heads already expanded; the
// kernel reads that strided layout in place (no (B*H, S, d) copy, no padding
// copies: ragged query rows and key columns are masked here).  Rows and
// columns are absolute from 0: with `causal`, row i sees keys j <= i, and key
// tiles wholly past the diagonal are skipped (the reference's block-
// triangular skip).  Masked scores are -1e30 as in the reference.
//
// One block per (query tile, b * h); a loop over key/value tiles takes the
// place of the TPU's sequential third grid axis.  The running max, the
// running sum and the output accumulator stay in registers, in fp32.
//
// bf16 (the serving path): 4 warps, 64 query rows (16 a warp), 64-key tiles.
// Q K^T and P V run on the tensor cores as mma.sync m16n8k16 bf16 x bf16 with
// fp32 accumulation; a bf16 x bf16 product is exact in fp32, so Q K^T is the
// reference's fp32 score up to summation order.  P is rounded to bf16 for
// P V (the row sum l uses the fp32 P): each weight carries a relative error
// of at most 2^-8, and O's rounding to bf16 at most 2^-8 of the row's
// largest |O|; hence the card tolerance of 1e-2 of that largest |O|, held
// one query row at a time against the fp32 plain version.  Tiles are staged with cp.async, the next K
// tile loading during the softmax and P V and the next V tile during Q K^T;
// fragments come from shared memory by ldmatrix (V transposed), rows padded
// by 8 elements so that the 8 row addresses of one ldmatrix phase fall in
// distinct banks.  Per block 3 x 64 x (d + 8) bf16 of shared memory (52 KB
// at d = 128).
//
// fp32 (no TF32): 128 threads, 32 query rows, 32-key tiles on the CUDA
// cores; each thread owns 2 rows: 4 score columns and d/8 output columns of
// each, so the row statistics never leave the thread's 8-lane group.
//
// What bounds it on an H100: at the serving shape (B=4, S=2048, H=32,
// d=128, causal) 4 B H d S(S+1)/2 = 1.4e11 FLOP against 268 MB of Q, K, V
// and O: 0.139 ms at the bf16 tensor-core peak against 0.080 ms of bytes,
// so operations.  mma.sync reaches a fraction of the wgmma peak; wgmma, TMA
// and warp specialisation are later work.
//
// No atomics: each output row is one thread group's fixed-order sums, so the
// same call gives the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace repro {
namespace {

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
constexpr int kWarps = 4;
constexpr int kMmaThreads = 32 * kWarps;
constexpr int kMmaBQ = 16 * kWarps;  // query rows per block
constexpr int kMmaBK = 64;           // keys per tile

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zeros when !valid (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a b for one m16n8k16 tile (a row-major 16 x 16, b column-major 16 x 8).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Stage rows [row0, row0 + ROWS) of one head (row stride `stride` elements,
// D contiguous elements each) into dst (ROWS x (D + 8)); zeros past nrows.
template <int D, int ROWS>
__device__ __forceinline__ void stage_async(bf16* dst, const bf16* src,
                                            int row0, int nrows,
                                            int64_t stride) {
  constexpr int LD = D + 8;
  constexpr int CHUNKS = D / 8;  // 16-byte pieces of a row
  for (int idx = threadIdx.x; idx < ROWS * CHUNKS; idx += kMmaThreads) {
    const int r = idx / CHUNKS;
    const int c = idx - r * CHUNKS;
    const int row = row0 + r;
    const bool ok = row < nrows;
    cp_async16(dst + r * LD + c * 8,
               ok ? src + static_cast<int64_t>(row) * stride + c * 8 : src,
               ok);
  }
}

// Grid (query tiles, B * H), kMmaThreads threads.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int H,
                 int Sq, int Skv, float scale_log2, int causal) {
  constexpr int LD = D + 8;
  constexpr int KSTEPS = D / 16;     // k-steps of Q K^T
  constexpr int SN = kMmaBK / 8;     // n-tiles of one score row block
  constexpr int ON = D / 8;          // n-tiles of one output row block
  extern __shared__ uint4 smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kMmaBQ * LD;
  bf16* Vs = Ks + kMmaBK * LD;

  const int q_tiles = gridDim.x;
  const int q0 = (q_tiles - 1 - blockIdx.x) * kMmaBQ;  // longest rows first
  const int b = blockIdx.y / H, h = blockIdx.y - b * H;
  const int64_t stride = static_cast<int64_t>(H) * D;
  const bf16* qg = q + static_cast<int64_t>(b) * Sq * stride + h * D;
  const bf16* kg = k + static_cast<int64_t>(b) * Skv * stride + h * D;
  const bf16* vg = v + static_cast<int64_t>(b) * Skv * stride + h * D;
  bf16* og = o + static_cast<int64_t>(b) * Sq * stride + h * D;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix matrix and row

  int kv_tiles = (Skv + kMmaBK - 1) / kMmaBK;
  if (causal) kv_tiles = min(kv_tiles, (q0 + kMmaBQ - 1) / kMmaBK + 1);

  // In flight at the top of every iteration: [K tile, V tile].
  stage_async<D, kMmaBQ>(Qs, qg, q0, Sq, stride);
  stage_async<D, kMmaBK>(Ks, kg, 0, Skv, stride);
  cp_async_commit();
  stage_async<D, kMmaBK>(Vs, vg, 0, Skv, stride);
  cp_async_commit();

  uint32_t qf[KSTEPS][4];
  float acc[ON][4];
#pragma unroll
  for (int n = 0; n < ON; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};  // rows g and g + 8 of this warp
  float l_run[2] = {0.f, 0.f};          // this thread's part of the row sums
  const int row_lo = q0 + warp * 16 + g;

  for (int kt = 0; kt < kv_tiles; ++kt) {
    const int k0 = kt * kMmaBK;
    cp_async_wait_one();  // K (and at kt = 0 Q) has landed
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        ldmatrix_x4(qf[kk], Qs + (warp * 16 + (mi & 1) * 8 + mr) * LD +
                                kk * 16 + (mi >> 1) * 8);
    }

    float s[SN][4];
#pragma unroll
    for (int n = 0; n < SN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
      for (int np = 0; np < SN / 2; ++np) {
        uint32_t kb[4];
        ldmatrix_x4(kb, Ks + (np * 16 + (mi >> 1) * 8 + mr) * LD + kk * 16 +
                            (mi & 1) * 8);
        mma_bf16(s[2 * np], qf[kk], kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qf[kk], kb[2], kb[3]);
      }
    __syncthreads();  // every warp is done with Ks
    if (kt + 1 < kv_tiles)
      stage_async<D, kMmaBK>(Ks, kg, k0 + kMmaBK, Skv, stride);
    cp_async_commit();

    // Scale to log2 units, mask, and fold the tile into the running stats.
    const bool edge =
        k0 + kMmaBK > Skv || (causal && k0 + kMmaBK - 1 > q0);
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int n = 0; n < SN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (edge) {
          const int col = k0 + n * 8 + 2 * t + (e & 1);
          const int row = row_lo + (e >> 1) * 8;
          if (col >= Skv || (causal && col > row)) x = kNegInf;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = exp2f(m_run[i] - mx[i]);
      m_run[i] = mx[i];
      l_run[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < SN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - mx[e >> 1]);
        s[n][e] = p;
        l_run[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < ON; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    cp_async_wait_one();  // V has landed
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kMmaBK / 16; ++kk) {
      // The score accumulators of n-tiles 2kk and 2kk + 1 are exactly the
      // A fragment of P's k-step kk.
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < ON / 2; ++np) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, Vs + (kk * 16 + (mi & 1) * 8 + mr) * LD +
                                  np * 16 + (mi >> 1) * 8);
        mma_bf16(acc[2 * np], pa, vb[0], vb[1]);
        mma_bf16(acc[2 * np + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with Vs
    if (kt + 1 < kv_tiles)
      stage_async<D, kMmaBK>(Vs, vg, k0 + kMmaBK, Skv, stride);
    cp_async_commit();
  }

  // Normalise, stage this warp's 16 rows in its own rows of Qs, and write
  // them out 16 bytes a thread.
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[i] = 1.f / fmaxf(l, 1e-30f);
  }
  bf16* stage = Qs + warp * 16 * LD;
#pragma unroll
  for (int n = 0; n < ON; ++n) {
    *reinterpret_cast<uint32_t*>(stage + g * LD + n * 8 + 2 * t) =
        pack_bf16(acc[n][0] * inv[0], acc[n][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * LD + n * 8 + 2 * t) =
        pack_bf16(acc[n][2] * inv[1], acc[n][3] * inv[1]);
  }
  __syncwarp();
  constexpr int CHUNKS = D / 8;
  for (int idx = lane; idx < 16 * CHUNKS; idx += 32) {
    const int r = idx / CHUNKS;
    const int c = idx - r * CHUNKS;
    const int row = q0 + warp * 16 + r;
    if (row < Sq)
      *reinterpret_cast<uint4*>(og + static_cast<int64_t>(row) * stride +
                                c * 8) =
          *reinterpret_cast<const uint4*>(stage + r * LD + c * 8);
  }
}

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores
// ---------------------------------------------------------------------------
constexpr int kF32Threads = 128;
constexpr int kF32BQ = 32;  // query rows per block: 16 row pairs
constexpr int kF32BK = 32;  // keys per tile

template <int D, int ROWS>
__device__ __forceinline__ void stage_f32(float* dst, const float* src,
                                          int row0, int nrows,
                                          int64_t stride) {
  constexpr int LD = D + 1;
  for (int idx = threadIdx.x; idx < ROWS * D; idx += kF32Threads) {
    const int r = idx / D;
    const int c = idx - r * D;
    const int row = row0 + r;
    dst[r * LD + c] =
        row < nrows ? src[static_cast<int64_t>(row) * stride + c] : 0.f;
  }
}

// Grid (query tiles, B * H), kF32Threads threads.  Thread (tr, tc) =
// (tid / 8, tid % 8) owns rows 2 tr and 2 tr + 1 of the tile, score columns
// tc + 8 c (c < 4) and output columns tc + 8 j (j < D / 8).
template <int D>
__global__ void __launch_bounds__(kF32Threads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int H,
                 int Sq, int Skv, float scale_log2, int causal) {
  constexpr int LD = D + 1;
  constexpr int PLD = kF32BK + 1;
  constexpr int OJ = D / 8;
  extern __shared__ float smem_f[];
  float* Qs = smem_f;
  float* Ks = Qs + kF32BQ * LD;
  float* Vs = Ks + kF32BK * LD;
  float* Ps = Vs + kF32BK * LD;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kF32BQ;
  const int b = blockIdx.y / H, h = blockIdx.y - b * H;
  const int64_t stride = static_cast<int64_t>(H) * D;
  const float* qg = q + static_cast<int64_t>(b) * Sq * stride + h * D;
  const float* kg = k + static_cast<int64_t>(b) * Skv * stride + h * D;
  const float* vg = v + static_cast<int64_t>(b) * Skv * stride + h * D;
  float* og = o + static_cast<int64_t>(b) * Sq * stride + h * D;
  const int tr = threadIdx.x / 8, tc = threadIdx.x % 8;

  int kv_tiles = (Skv + kF32BK - 1) / kF32BK;
  if (causal) kv_tiles = min(kv_tiles, (q0 + kF32BQ - 1) / kF32BK + 1);

  stage_f32<D, kF32BQ>(Qs, qg, q0, Sq, stride);
  float acc[2][OJ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < OJ; ++j) acc[i][j] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};

  for (int kt = 0; kt < kv_tiles; ++kt) {
    const int k0 = kt * kF32BK;
    __syncthreads();  // the previous tile's K and V are no longer read
    stage_f32<D, kF32BK>(Ks, kg, k0, Skv, stride);
    stage_f32<D, kF32BK>(Vs, vg, k0, Skv, stride);
    __syncthreads();

    float s[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
    const float* qa = Qs + (2 * tr) * LD;
    for (int d = 0; d < D; ++d) {
      const float a0 = qa[d], a1 = qa[LD + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float kv = Ks[(tc + 8 * c) * LD + d];
        s[0][c] = fmaf(a0, kv, s[0][c]);
        s[1][c] = fmaf(a1, kv, s[1][c]);
      }
    }
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + 2 * tr + i;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = k0 + tc + 8 * c;
        float x = s[i][c] * scale_log2;
        if (col >= Skv || (causal && col > row)) x = kNegInf;
        s[i][c] = x;
        mx[i] = fmaxf(mx[i], x);
      }
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 4));
      const float alpha = exp2f(m_run[i] - mx[i]);
      m_run[i] = mx[i];
      l_run[i] *= alpha;
#pragma unroll
      for (int j = 0; j < OJ; ++j) acc[i][j] *= alpha;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = exp2f(s[i][c] - mx[i]);
        l_run[i] += p;
        Ps[(2 * tr + i) * PLD + tc + 8 * c] = p;
      }
    }
    __syncwarp();  // this row pair's P is written by its own 8 lanes
    for (int kk = 0; kk < kF32BK; ++kk) {
      const float p0 = Ps[(2 * tr) * PLD + kk];
      const float p1 = Ps[(2 * tr + 1) * PLD + kk];
#pragma unroll
      for (int j = 0; j < OJ; ++j) {
        const float x = Vs[kk * LD + tc + 8 * j];
        acc[0][j] = fmaf(p0, x, acc[0][j]);
        acc[1][j] = fmaf(p1, x, acc[1][j]);
      }
    }
    __syncwarp();  // P is read before the next tile overwrites it
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l += __shfl_xor_sync(0xffffffffu, l, 4);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const int row = q0 + 2 * tr + i;
    if (row < Sq) {
#pragma unroll
      for (int j = 0; j < OJ; ++j)
        og[static_cast<int64_t>(row) * stride + tc + 8 * j] = acc[i][j] * inv;
    }
  }
}

// ---------------------------------------------------------------------------
template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int Sq, int Skv, int dtype, int causal,
                   float scale, cudaStream_t stream) {
  const float scale_log2 = scale * kLog2e;
  if (dtype == kBFloat16) {
    auto kernel = flash_mma_kernel<D>;
    const int smem = static_cast<int>(sizeof(bf16) * (kMmaBQ + 2 * kMmaBK) *
                                      (D + 8));
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((Sq + kMmaBQ - 1) / kMmaBQ, B * H);
    kernel<<<grid, kMmaThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), H, Sq, Skv,
        scale_log2, causal);
    return cudaGetLastError();
  }
  if (dtype == kFloat32) {
    auto kernel = flash_f32_kernel<D>;
    const int smem = static_cast<int>(
        sizeof(float) * ((kF32BQ + 2 * kF32BK) * (D + 1) +
                         kF32BQ * (kF32BK + 1)));
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((Sq + kF32BQ - 1) / kF32BQ, B * H);
    kernel<<<grid, kF32Threads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), H, Sq, Skv,
        scale_log2, causal);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro

// Returns cudaGetLastError() of the launch (0 on success).  q, o are
// (B, Sq, H, d) and k, v (B, Skv, H, d), contiguous, 16-byte aligned, all of
// one type: dtype 0 fp32, 1 bf16; d in {16, 32, 64, 128}.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int B, int H,
                                     int Sq, int Skv, int d, int dtype,
                                     int causal, float scale, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (d) {
    case 16: err = repro::launch<16>(q, k, v, o, B, H, Sq, Skv, dtype, causal, scale, s); break;
    case 32: err = repro::launch<32>(q, k, v, o, B, H, Sq, Skv, dtype, causal, scale, s); break;
    case 64: err = repro::launch<64>(q, k, v, o, B, H, Sq, Skv, dtype, causal, scale, s); break;
    case 128: err = repro::launch<128>(q, k, v, o, B, H, Sq, Skv, dtype, causal, scale, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
