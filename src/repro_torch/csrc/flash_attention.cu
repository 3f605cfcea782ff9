// Causal or full softmax attention, forward only, with the online-softmax
// recurrence: the S_q x S_kv scores never reach device memory.
//
//   O[b, i, h] = sum_j softmax_j(scale * Q[b, i, h] . K[b, j, h]) V[b, j, h]
//
// replaces repro/kernels/flash_attention.py::flash_attention (:85, kernel
// _flash_kernel :37).  Layout as the reference's public function: Q, K, V and
// O are (B, S, H, d) row-major with the GQA heads already expanded; the
// kernels read that strided layout in place (no (B*H, S, d) copy, no padding
// copies: ragged query rows and key columns are masked here).  Rows and
// columns are absolute from 0: with `causal`, row i sees keys j <= i, and key
// tiles wholly past the diagonal are skipped (the reference's block-
// triangular skip).  Masked scores are -1e30 as in the reference.  Blocks
// take the heaviest query tiles of a head first.
//
// What bounds it on an H100: at the serving shape (B=4, S=2048, H=32,
// d=128, causal) 4 B H d S(S+1)/2 = 1.4e11 FLOP against 268 MB of Q, K, V
// and O: 0.139 ms at the bf16 tensor-core peak against 0.080 ms of bytes,
// so the tensor cores.  Only wgmma reaches their peak on Hopper, and only if
// the loads and the softmax stay off their critical path.
//
// bf16 (the serving path), FlashAttention-3's shape.  A block owns a
// 128-row query tile of one (b, h) and has three warpgroups:
//   - a producer (one thread issues everything) that loads Q once and K and
//     V tiles of 128 keys into a ring of two stages by TMA, through 4-D
//     tensor maps over (d, H, S, B): rows past S arrive as zeros.  Each
//     stage has a full barrier (TMA bytes landed) and an empty barrier (the
//     consumers' 8 warps are done with it), K and V apart, so the next K
//     tile loads while this tile's softmax and P V run;
//   - two consumers of 64 query rows each.  Q K^T is wgmma m64n128k16 with
//     Q and K from shared memory (both K-major); the online softmax runs in
//     base 2 in the accumulator layout, in fp32 registers; P is rounded to
//     bf16 in registers and is the A operand of P V (wgmma m64n{d}k16), V
//     the B operand from shared memory, MN-major.  The consumers take turns
//     (two named barriers) to issue Q K^T, so that one's softmax runs while
//     the other's product holds the tensor cores.
// The softmax, not the products, is what the tensor cores wait for: the
// SM computes 16 exponentials a clock, so a block's 128 x 128 scores take
// 1024 clocks against the 2048 of its two products.  It costs one FFMA, one ex2 and one FADD an element (the scale
// folded into the exponent, masked scores set before it), with the row max
// and row sum in 4 independent chains a row.  The query tiles of one head
// run side by side, so its K and V are read from L2 after the first tile.
// The tiles land in the swizzle that fits a row of d bf16: 32 B at d=16,
// 64 B at d=32, 128 B at d=64, and d=128 as two 64-column atoms of 128 B;
// the wgmma descriptors use the same mode.  setmaxnreg gives the producer's
// registers to the consumers (24 / 240 a thread).  Shared memory: Q 128 x d,
// two K and two V stages of 128 x d (160 KB at d = 128).  A bf16 x bf16
// product is exact in fp32, so Q K^T is the reference's fp32 score up to
// summation order; P carries a relative error of at most 2^-8 a weight and
// O's rounding to bf16 at most 2^-8 of the row's largest |O| (the row sum
// l uses the fp32 P).
//
// fp32 (no TF32): 128 threads, 32 query rows, 32-key tiles on the CUDA
// cores; each thread owns 2 rows: 4 score columns and d/8 output columns of
// each, so the row statistics never leave the thread's 8-lane group.
//
// No atomics: each output row is one thread group's fixed-order sums, so the
// same call gives the same bits.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace repro {
namespace {

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

using bf16 = __nv_bfloat16;
using namespace hopper;

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: TMA ring, wgmma, warp-specialised
// ---------------------------------------------------------------------------
constexpr int kBQ = 128;       // query rows per block
constexpr int kBK = 128;       // keys per tile
constexpr int kStages = 2;     // K and V ring depth
constexpr int kConsumers = 2;  // consumer warpgroups, 64 rows each
constexpr int kWgThreads = 128;
constexpr int kFlashThreads = kWgThreads * (kConsumers + 1);
constexpr int kProducerRegs = 24, kConsumerRegs = 240;

// Shared-memory geometry of one head dim.  A tile of R rows is stored as
// kAtoms column atoms of R rows x kRowBytes each, in the TMA swizzle.
template <int D>
struct Bf16Tile {
  static constexpr int kRowBytes = D < 64 ? 2 * D : 128;
  static constexpr int kAtomCols = kRowBytes / 2;
  static constexpr int kAtoms = D / kAtomCols;
  static constexpr uint32_t kMode = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kKVBytes = kBK * D * 2;
  static constexpr int kBarriers = 1 + 4 * kStages;
  // + 1024: the swizzle atoms need 1024-byte alignment.
  static constexpr int kSmem =
      1024 + kQBytes + 2 * kStages * kKVBytes + 8 * kBarriers;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (D == 16) wgmma_rs_n16(o, a, b);
  if constexpr (D == 32) wgmma_rs_n32(o, a, b);
  if constexpr (D == 64) wgmma_rs_n64(o, a, b);
  if constexpr (D == 128) wgmma_rs_n128(o, a, b);
}

// Grid (query tiles, B * H), kFlashThreads threads.
template <int D>
__global__ void __launch_bounds__(kFlashThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   bf16* __restrict__ o, int H, int Sq, int Skv,
                   float scale_log2, int causal) {
  using T = Bf16Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* k_s = q_s + T::kQBytes;               // stage s at s * kKVBytes
  uint8_t* v_s = k_s + kStages * T::kKVBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + kStages * T::kKVBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;

  // The query tiles of one (b, h) run side by side (its K and V stay in
  // L2), the heaviest first.
  const int b = blockIdx.y / H, h = blockIdx.y - b * H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  int kv_tiles = (Skv + kBK - 1) / kBK;
  if (causal) kv_tiles = min(kv_tiles, (q0 + kBQ - 1) / kBK + 1);
  const int wg = threadIdx.x / kWgThreads;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, 4 * kConsumers);
      mbar_init(v_empty + s, 4 * kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer ---------------------------------------------------------
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumers * kWgThreads) {
      prefetch_tensor_map(&tm_q);
      prefetch_tensor_map(&tm_k);
      prefetch_tensor_map(&tm_v);
      mbar_arrive_expect_tx(q_full, T::kQBytes);
#pragma unroll
      for (int a = 0; a < T::kAtoms; ++a)
        tma_load_4d(q_s + a * kBQ * T::kRowBytes, &tm_q, q_full,
                    a * T::kAtomCols, h, q0, b);
      for (int kt = 0; kt < kv_tiles; ++kt) {
        const int s = kt % kStages;
        const uint32_t parity = ((kt / kStages) & 1) ^ 1;  // round 0 passes
        mbar_wait(k_empty + s, parity);
        mbar_arrive_expect_tx(k_full + s, T::kKVBytes);
#pragma unroll
        for (int a = 0; a < T::kAtoms; ++a)
          tma_load_4d(k_s + s * T::kKVBytes + a * kBK * T::kRowBytes, &tm_k,
                      k_full + s, a * T::kAtomCols, h, kt * kBK, b);
        mbar_wait(v_empty + s, parity);
        mbar_arrive_expect_tx(v_full + s, T::kKVBytes);
#pragma unroll
        for (int a = 0; a < T::kAtoms; ++a)
          tma_load_4d(v_s + s * T::kKVBytes + a * kBK * T::kRowBytes, &tm_v,
                      v_full + s, a * T::kAtomCols, h, kt * kBK, b);
      }
    }
  } else {
    // ---- consumers --------------------------------------------------------
    regs_alloc<kConsumerRegs>();
    constexpr int KSTEPS = D / 16;                  // k-steps of Q K^T
    constexpr int ATOM_STEPS = T::kAtomCols / 16;   // k-steps per atom
    constexpr uint32_t SBO = 8 * T::kRowBytes;      // next 8-row group
    const int tid = threadIdx.x % kWgThreads;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int wrow0 = q0 + wg * 64;                 // this warpgroup's rows
    const int row_lo = wrow0 + warp * 16 + g;       // and row_lo + 8
    const uint32_t q_addr = smem_u32(q_s) + wg * 64 * T::kRowBytes;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float sc[kBK / 2];                    // S, then P in fp32, of one tile
    uint32_t pa[kBK / 16][4];             // P in bf16: P V's A fragments
    float m_run[2] = {kNegInf, kNegInf};  // rows row_lo and row_lo + 8
    float l_run[2] = {0.f, 0.f};          // this thread's part of the sums
    float alpha[2];

    // Issue S = Q K^T of tile kt (64 x 128 per warpgroup, fp32).
    auto issue_qk = [&](int kt) {
      const int s = kt % kStages;
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) sc[i] = 0.f;
      mbar_wait(k_full + s, (kt / kStages) & 1);
      const uint32_t k_addr = smem_u32(k_s + s * T::kKVBytes);
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const int atom = kk / ATOM_STEPS, within = kk % ATOM_STEPS;
        const uint64_t da = smem_desc(
            q_addr + atom * kBQ * T::kRowBytes + within * 32, 16, SBO, T::kMode);
        const uint64_t db = smem_desc(
            k_addr + atom * kBK * T::kRowBytes + within * 32, 16, SBO, T::kMode);
        wgmma_ss_n128(sc, da, db, 1);
      }
      wgmma_commit();
    };
    // Issue O += P V of tile kt.
    auto issue_pv = [&](int kt) {
      const int s = kt % kStages;
      mbar_wait(v_full + s, (kt / kStages) & 1);
      const uint32_t v_addr = smem_u32(v_s + s * T::kKVBytes);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_pv<D>(acc, pa[kk],
                    smem_desc(v_addr + kk * 16 * T::kRowBytes,
                              kBK * T::kRowBytes, SBO, T::kMode));
      wgmma_commit();
    };
    auto release = [&](uint64_t* empty) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty);
    };
    // Fold S of tile kt into the running stats and overwrite it with
    // P = 2^(scale log2(e) S - m) in fp32, m the running max in log2 units
    // (masked scores are -1e30 before the scaling).  Accumulator element
    // 4 j + e: row row_lo + 8 (e >> 1), key k0 + 8 j + 2 t + (e & 1).  The
    // row max and row sum run as 4 chains a row, combined in a fixed order.
    auto softmax = [&](int kt) {
      const int k0 = kt * kBK;
      if (k0 + kBK > Skv || (causal && k0 + kBK - 1 > wrow0)) {
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + 8 * j + 2 * t + (e & 1);
            const int row = row_lo + (e >> 1) * 8;
            if (col >= Skv || (causal && col > row)) sc[4 * j + e] = kNegInf;
          }
      }
      float mc[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) mc[i][c] = kNegInf;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mc[e >> 1][j & 3] = fmaxf(mc[e >> 1][j & 3], sc[4 * j + e]);
      float m_new[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = fmaxf(fmaxf(mc[i][0], mc[i][1]), fmaxf(mc[i][2], mc[i][3]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        m_new[i] = fmaxf(m_run[i], mx * scale_log2);
        alpha[i] = exp2_approx(m_run[i] - m_new[i]);
        m_run[i] = m_new[i];
      }
      float ls[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) ls[i][c] = 0.f;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const float p =
              exp2_approx(fmaf(sc[4 * j + e], scale_log2, -m_new[i]));
          sc[4 * j + e] = p;
          ls[i][j & 3] += p;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i)
        l_run[i] = fmaf(l_run[i], alpha[i],
                        (ls[i][0] + ls[i][1]) + (ls[i][2] + ls[i][3]));
    };
    // Rescale O by alpha and round P to bf16: the A fragment of P V's
    // k-step kk is the elements of key chunks 2 kk and 2 kk + 1.
    auto rescale_and_pack = [&]() {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j + 0] *= alpha[0];
        acc[4 * j + 1] *= alpha[0];
        acc[4 * j + 2] *= alpha[1];
        acc[4 * j + 3] *= alpha[1];
      }
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int f = 0; f < 4; ++f)
          pa[kk][f] = pack_bf16(sc[8 * kk + 2 * f], sc[8 * kk + 2 * f + 1]);
    };

    // The two consumers take turns to issue Q K^T (named barriers 1 and 2,
    // consumer 0 first), so that one's softmax runs while the other's
    // product holds the tensor cores.  Each passes the turn once per tile
    // but consumer 1 not after its last, so every arrival is waited for.
    const int my_turn = 1 + wg, other_turn = 2 - wg;
    if (wg == 1) named_arrive(1, 2 * kWgThreads);
    mbar_wait(q_full, 0);
    for (int kt = 0; kt < kv_tiles; ++kt) {
      named_sync(my_turn, 2 * kWgThreads);
      issue_qk(kt);
      if (wg == 0 || kt + 1 < kv_tiles)
        named_arrive(other_turn, 2 * kWgThreads);
      wgmma_wait_all();
      fence_regs(sc);
      release(k_empty + kt % kStages);
      softmax(kt);
      rescale_and_pack();
      issue_pv(kt);
      wgmma_wait_all();
      fence_regs(acc);
      release(v_empty + kt % kStages);
    }

    // Normalise in fp32, round to bf16, store the rows below S_q.
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float l = l_run[i];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[i] = 1.f / fmaxf(l, 1e-30f);
    }
    const int64_t stride = static_cast<int64_t>(H) * D;
    bf16* og = o + static_cast<int64_t>(b) * Sq * stride + h * D + 2 * t;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row_lo + 8 * i;
      if (row >= Sq) continue;
      bf16* dst = og + row * stride;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + 8 * j) =
            pack_bf16(acc[4 * j + 2 * i] * inv[i], acc[4 * j + 2 * i + 1] * inv[i]);
    }
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
// Host side
// ---------------------------------------------------------------------------
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found once through the runtime
// (no link against libcuda); null if the driver does not have it.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A 4-D map over a (B, S, H, D) bf16 tensor, dims innermost first (D, H, S,
// B); one box is `rows` rows of one head and one column atom.
template <int D>
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int H,
              int rows) {
  using T = Bf16Tile<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {2ull * D, 2ull * D * H, 2ull * D * H * S};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(T::kAtomCols), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      T::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : T::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int Sq, int Skv, int dtype, int causal,
                   float scale, cudaStream_t stream) {
  const float scale_log2 = scale * kLog2e;
  if (dtype == kBFloat16) {
    CUtensorMap tq, tk, tv;
    if (!make_map<D>(&tq, q, B, Sq, H, kBQ) ||
        !make_map<D>(&tk, k, B, Skv, H, kBK) ||
        !make_map<D>(&tv, v, B, Skv, H, kBK))
      return cudaErrorInvalidValue;
    auto kernel = flash_wgmma_kernel<D>;
    constexpr int smem = Bf16Tile<D>::kSmem;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
    kernel<<<grid, kFlashThreads, smem, stream>>>(
        tq, tk, tv, static_cast<bf16*>(o), H, Sq, Skv, scale_log2, causal);
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

// Returns cudaGetLastError() of the launch (0 on success; an invalid value
// when a tensor map cannot be made).  q, o are (B, Sq, H, d) and k, v
// (B, Skv, H, d), contiguous, 16-byte aligned, all of one type: dtype 0
// fp32, 1 bf16; d in {16, 32, 64, 128}; B * H and the query tiles each at
// most 65535.
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
