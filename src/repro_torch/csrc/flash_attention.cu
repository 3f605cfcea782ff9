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
// fp32 on the tensor cores in 3xTF32: each operand is split into its TF32
// rounding (hi) and the TF32 rounding of the remainder (lo), and fp32
// accumulators take hi lo + lo hi + hi hi, within ~2^-21 of the fp32
// product (lo lo is left out).  The tensor cores' fp32 accumulation
// truncates, and one accumulator over a 2048-key row drifted past the 2e-5
// row bar; so hi hi and the cross terms have accumulators of their own,
// and each tile's P V starts from zero and joins O with one rounding.
// At the fp32 rows' shapes the CUDA cores' 67 TFLOP/s would bound it (4 d
// FLOP a kept score); three TF32 products at 495 TFLOP/s cost less than
// half that.  mma.sync m16n8k8 (it takes V row-major for P V, where
// wgmma's TF32 form wants both operands K-major): 128 threads, 64 query
// rows (16 a warp), 64-key tiles of K and V in a two-stage cp.async ring,
// Q split once into shared memory.  P stays in
// registers: the accumulator layout of Q K^T holds keys 2t, 2t + 1 of each
// 8, which P V takes as A columns t and t + 4, with V's rows read in the
// same order.  The online softmax runs in base 2 (exp2f), the row
// statistics within the 4 lanes of a row.  Where the query tiles alone
// leave the card idle (few (b, h) pairs, short queries), a thread-block
// cluster of 2-8 blocks splits the key tiles of one query tile
// (kernels/flash_attention.py::f32_split, a pure function of the shape and
// the SM count), and its blocks combine their (m, l, O) in distributed
// shared memory in rank order: still one launch.
//
// No atomics: each output row is one thread group's fixed-order sums (and
// the cluster's combination one fixed order), so the same call gives the
// same bits.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"
#include "tile64.cuh"

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
// fp32 on the tensor cores: 3xTF32 mma.sync, keys split over a cluster
// ---------------------------------------------------------------------------
constexpr int kF32Threads = 128;  // 4 warps, 16 query rows each
constexpr int kF32BQ = 64;        // query rows per block
constexpr int kF32BK = 64;        // keys per tile
constexpr int kMaxSplit = 8;      // blocks of a cluster (portable)

// Shared memory of one head dim: Q as TF32 high and low parts, and two
// stages of K and of V, each 64 rows of stride D + 4 floats (fragment
// loads free of bank conflicts: a row stride of 4 mod 32 banks).
template <int D>
struct F32Tile {
  static constexpr int kLd = D + 4;
  static constexpr int kTile = kF32BQ * kLd;  // floats of one 64-row tile
  static constexpr int kSmem = 6 * kTile * static_cast<int>(sizeof(float));
};

// Round to TF32 (10 mantissa bits), to nearest, ties away.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}
// x = hi + lo + O(2^-22 |x|): hi its TF32 rounding, lo the remainder's.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}
// d += a b, one m16n8k8 TF32 product with fp32 accumulation.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// Stage rows [row0, row0 + 64) of one head of K or V ((S, H, D) rows of
// stride H D) into dst (64 x kLd) by cp.async; zeros past nrows.
template <int D>
__device__ __forceinline__ void stage_kv_f32(float* dst, const float* src,
                                             int row0, int nrows,
                                             int64_t stride) {
  constexpr int kPieces = D / 4;
  for (int idx = threadIdx.x; idx < kF32BK * kPieces; idx += kF32Threads) {
    const int rr = idx / kPieces, c = (idx - rr * kPieces) * 4;
    const int row = row0 + rr;
    const bool ok = row < nrows;
    cp_async<16>(dst + rr * F32Tile<D>::kLd + c,
                 ok ? src + row * stride + c : src, ok);
  }
}

// Grid (query tiles x split, B * H), kF32Threads threads, clusters of
// `split` blocks along x.  Block (tile, c) takes the key tiles c, c +
// split, ... of its query tile; warp w owns query rows 16 w .. 16 w + 15,
// lane (g, t) = (lane / 4, lane % 4) rows g and g + 8 of them in the mma
// accumulator layout.  With split > 1 the cluster combines its blocks'
// (m, l, O) in distributed shared memory, in rank order.
template <int D>
__global__ void __launch_bounds__(kF32Threads, D == 128 ? 1 : 2)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int H,
                 int Sq, int Skv, float scale_log2, int causal, int split) {
  using T = F32Tile<D>;
  constexpr int LD = T::kLd;
  constexpr int NT = D / 8;  // 8-column tiles of O
  extern __shared__ float4 smem_f4[];
  uint32_t* Qhi = reinterpret_cast<uint32_t*>(smem_f4);
  uint32_t* Qlo = Qhi + T::kTile;
  float* Kst = reinterpret_cast<float*>(Qlo + T::kTile);  // 2 stages
  float* Vst = Kst + 2 * T::kTile;                         // 2 stages

  const int rank = blockIdx.x % split;
  const int q0 = (gridDim.x / split - 1 - blockIdx.x / split) * kF32BQ;
  const int b = blockIdx.y / H, h = blockIdx.y - b * H;
  const int64_t stride = static_cast<int64_t>(H) * D;
  const float* qg = q + static_cast<int64_t>(b) * Sq * stride + h * D;
  const float* kg = k + static_cast<int64_t>(b) * Skv * stride + h * D;
  const float* vg = v + static_cast<int64_t>(b) * Skv * stride + h * D;
  float* og = o + static_cast<int64_t>(b) * Sq * stride + h * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wrow0 = q0 + 16 * warp;  // this warp's first row
  const int row_lo = wrow0 + g;      // and row_lo + 8

  int kv_tiles = (Skv + kF32BK - 1) / kF32BK;
  if (causal) kv_tiles = min(kv_tiles, (q0 + kF32BQ - 1) / kF32BK + 1);
  const int mine = kv_tiles > rank ? (kv_tiles - rank + split - 1) / split : 0;

  if (mine > 0) {
    stage_kv_f32<D>(Kst, kg, rank * kF32BK, Skv, stride);
    stage_kv_f32<D>(Vst, vg, rank * kF32BK, Skv, stride);
    cp_async_commit();
  }
  // Q, split into TF32 parts once: zeros past S_q.
  for (int idx = threadIdx.x; idx < kF32BQ * D / 4; idx += kF32Threads) {
    const int rr = idx / (D / 4), c = (idx - rr * (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + rr < Sq)
      x = *reinterpret_cast<const float4*>(qg + (q0 + rr) * stride + c);
    uint4 hi, lo;
    split_tf32(x.x, hi.x, lo.x);
    split_tf32(x.y, hi.y, lo.y);
    split_tf32(x.z, hi.z, lo.z);
    split_tf32(x.w, hi.w, lo.w);
    *reinterpret_cast<uint4*>(Qhi + rr * LD + c) = hi;
    *reinterpret_cast<uint4*>(Qlo + rr * LD + c) = lo;
  }

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};  // rows row_lo, row_lo + 8
  float l_run[2] = {0.f, 0.f};          // this thread's part of the sums
  const uint32_t* qh = Qhi + (16 * warp + g) * LD;
  const uint32_t* ql = Qlo + (16 * warp + g) * LD;

  for (int i = 0; i < mine; ++i) {
    const int kt = rank + i * split, k0 = kt * kF32BK;
    const float* Ks = Kst + (i & 1) * T::kTile;
    const float* Vs = Vst + (i & 1) * T::kTile;
    // Tile i has landed and every warp is done with tile i - 1, whose
    // stage the next tile takes.
    cp_async_wait_all();
    __syncthreads();
    if (i + 1 < mine) {
      const int next = (kt + split) * kF32BK;
      stage_kv_f32<D>(Kst + ((i + 1) & 1) * T::kTile, kg, next, Skv, stride);
      stage_kv_f32<D>(Vst + ((i + 1) & 1) * T::kTile, vg, next, Skv, stride);
      cp_async_commit();
    }

    // S = Q K^T (16 x 64 a warp): element (j, e) is row row_lo + 8 (e / 2),
    // key k0 + 8 j + 2 t + e % 2.  The tensor cores add into an fp32
    // accumulator with truncation, so the large products (hi hi) and the
    // small cross terms go to accumulators of their own, added once with
    // rounding: each takes D / 8 truncated additions, not 3 D / 8.
    float sc[8][4], sx[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = sx[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const int c0 = 8 * kk + t;
      const uint32_t a_hi[4] = {qh[c0], qh[8 * LD + c0], qh[c0 + 4],
                                qh[8 * LD + c0 + 4]};
      const uint32_t a_lo[4] = {ql[c0], ql[8 * LD + c0], ql[c0 + 4],
                                ql[8 * LD + c0 + 4]};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float* krow = Ks + (8 * j + g) * LD + 8 * kk;
        uint32_t h0, l0, h1, l1;
        split_tf32(krow[t], h0, l0);
        split_tf32(krow[t + 4], h1, l1);
        mma_tf32(sx[j], a_lo, h0, h1);
        mma_tf32(sx[j], a_hi, l0, l1);
        mma_tf32(sc[j], a_hi, h0, h1);
      }
    }

    // Scale to base 2; mask keys past S_kv and, causal, past the row.
    const bool edge = k0 + kF32BK > Skv ||
                      (causal && k0 + kF32BK - 1 > wrow0);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = (sc[j][e] + sx[j][e]) * scale_log2;
        if (edge) {
          const int col = k0 + 8 * j + 2 * t + (e & 1);
          const int row = row_lo + 8 * (e >> 1);
          if (col >= Skv || (causal && col > row)) x = kNegInf;
        }
        sc[j][e] = x;
      }
    // Online softmax: the 4 lanes of a row hold its 64 scores.
    float alpha[2];
#pragma unroll
    for (int r2 = 0; r2 < 2; ++r2) {
      float mx = m_run[r2];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[j][2 * r2], sc[j][2 * r2 + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[r2] = exp2f(m_run[r2] - mx);
      m_run[r2] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p0 = exp2f(sc[j][2 * r2] - mx);
        const float p1 = exp2f(sc[j][2 * r2 + 1] - mx);
        sc[j][2 * r2] = p0;
        sc[j][2 * r2 + 1] = p1;
        sum += p0 + p1;
      }
      l_run[r2] = fmaf(l_run[r2], alpha[r2], sum);
    }

    // O = alpha O + P V.  P's accumulator layout holds keys 2 t, 2 t + 1 of
    // each 8; as the A operand they stand at columns t and t + 4, so V's
    // rows are read in the same order: B's rows t and t + 4 are keys 2 t,
    // 2 t + 1.  Each 8-column block of this tile's P V starts from zero
    // (8 truncated additions a term) and joins O with one rounding.
    uint32_t p_hi[8][4], p_lo[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      split_tf32(sc[kk][0], p_hi[kk][0], p_lo[kk][0]);
      split_tf32(sc[kk][2], p_hi[kk][1], p_lo[kk][1]);
      split_tf32(sc[kk][1], p_hi[kk][2], p_lo[kk][2]);
      split_tf32(sc[kk][3], p_hi[kk][3], p_lo[kk][3]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float c[4] = {0.f, 0.f, 0.f, 0.f}, cx[4] = {0.f, 0.f, 0.f, 0.f};
      const float* vcol = Vs + 2 * t * LD + 8 * j + g;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        uint32_t h0, l0, h1, l1;
        split_tf32(vcol[8 * kk * LD], h0, l0);
        split_tf32(vcol[(8 * kk + 1) * LD], h1, l1);
        mma_tf32(cx, p_lo[kk], h0, h1);
        mma_tf32(cx, p_hi[kk], l0, l1);
        mma_tf32(c, p_hi[kk], h0, h1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[j][e] = fmaf(acc[j][e], alpha[e >> 1], c[e] + cx[e]);
    }
  }

  float l_row[2];
#pragma unroll
  for (int r2 = 0; r2 < 2; ++r2) {
    float l = l_run[r2];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l_row[r2] = l;
  }
  if (split == 1) {
#pragma unroll
    for (int r2 = 0; r2 < 2; ++r2) {
      const int row = row_lo + 8 * r2;
      if (row >= Sq) continue;
      const float inv = 1.f / fmaxf(l_row[r2], 1e-30f);
      float* dst = og + row * stride + 2 * t;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j) =
            make_float2(acc[j][2 * r2] * inv, acc[j][2 * r2 + 1] * inv);
    }
    return;
  }

  // The cluster's blocks each hold (m, l, O) of all 64 rows over their key
  // tiles; block c finishes rows c * 64 / split onwards from all of them.
  float* Ob = reinterpret_cast<float*>(Qhi);  // 64 x LD, unnormalised O
  float* mb = reinterpret_cast<float*>(Qlo);  // row maxima
  float* lb = mb + kF32BQ;                    // row sums
  __syncthreads();  // every warp is done with Q
#pragma unroll
  for (int r2 = 0; r2 < 2; ++r2) {
    const int rr = 16 * warp + g + 8 * r2;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      *reinterpret_cast<float2*>(Ob + rr * LD + 8 * j + 2 * t) =
          make_float2(acc[j][2 * r2], acc[j][2 * r2 + 1]);
    if (t == 0) {
      mb[rr] = m_run[r2];
      lb[rr] = l_row[r2];
    }
  }
  cluster_sync();
  const int rows = kF32BQ / split;
  for (int idx = threadIdx.x; idx < rows * D; idx += kF32Threads) {
    const int rr = rank * rows + idx / D, c = idx % D;
    float mx = kNegInf;
    for (int src = 0; src < split; ++src)
      mx = fmaxf(mx, ld_cluster(cluster_addr(mb + rr, src)));
    float l = 0.f, out = 0.f;
    for (int src = 0; src < split; ++src) {
      const float wgt = exp2f(ld_cluster(cluster_addr(mb + rr, src)) - mx);
      l = fmaf(wgt, ld_cluster(cluster_addr(lb + rr, src)), l);
      out = fmaf(wgt, ld_cluster(cluster_addr(Ob + rr * LD + c, src)), out);
    }
    if (q0 + rr < Sq) og[(q0 + rr) * stride + c] = out / fmaxf(l, 1e-30f);
  }
  cluster_sync();  // no block leaves while another reads its memory
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------
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

// cudaFuncSetAttribute(kernel, max dynamic shared memory, bytes) once per
// kernel and device: `done` is the caller's flag table (one per kernel).
// A launch with too much shared memory is refused, not run, so a device
// whose flag is set has the attribute.
constexpr int kMaxDevices = 64;
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool (&done)[kMaxDevices]) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && done[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && device < kMaxDevices) done[device] = true;
  return err;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int Sq, int Skv, int dtype, int causal,
                   float scale, int split, cudaStream_t stream) {
  const float scale_log2 = scale * kLog2e;
  if (dtype == kBFloat16) {
    if (split != 1) return cudaErrorInvalidValue;
    CUtensorMap tq, tk, tv;
    if (!make_map<D>(&tq, q, B, Sq, H, kBQ) ||
        !make_map<D>(&tk, k, B, Skv, H, kBK) ||
        !make_map<D>(&tv, v, B, Skv, H, kBK))
      return cudaErrorInvalidValue;
    auto kernel = flash_wgmma_kernel<D>;
    constexpr int smem = Bf16Tile<D>::kSmem;
    static bool done[kMaxDevices] = {};
    cudaError_t err = allow_smem(kernel, smem, done);
    if (err != cudaSuccess) return err;
    const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
    kernel<<<grid, kFlashThreads, smem, stream>>>(
        tq, tk, tv, static_cast<bf16*>(o), H, Sq, Skv, scale_log2, causal);
    return cudaGetLastError();
  }
  if (dtype == kFloat32) {
    if (split < 1 || split > kMaxSplit || (split & (split - 1)) != 0)
      return cudaErrorInvalidValue;
    auto kernel = flash_f32_kernel<D>;
    constexpr int smem = F32Tile<D>::kSmem;
    static bool done[kMaxDevices] = {};
    cudaError_t err = allow_smem(kernel, smem, done);
    if (err != cudaSuccess) return err;
    const dim3 grid((Sq + kF32BQ - 1) / kF32BQ * split, B * H);
    const float* qf = static_cast<const float*>(q);
    const float* kf = static_cast<const float*>(k);
    const float* vf = static_cast<const float*>(v);
    float* of = static_cast<float*>(o);
    if (split == 1) {
      kernel<<<grid, kF32Threads, smem, stream>>>(qf, kf, vf, of, H, Sq, Skv,
                                                  scale_log2, causal, split);
      return cudaGetLastError();
    }
    cudaLaunchConfig_t config = {};
    config.gridDim = grid;
    config.blockDim = dim3(kF32Threads);
    config.dynamicSmemBytes = smem;
    config.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = split;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.attrs = attr;
    config.numAttrs = 1;
    err = cudaLaunchKernelEx(&config, kernel, qf, kf, vf, of, H, Sq, Skv,
                             scale_log2, causal, split);
    if (err != cudaSuccess) return err;
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
// most 65535.  split: the fp32 kernel's blocks a query tile (1, 2, 4 or 8,
// kernels/flash_attention.py::f32_split); 1 for bf16.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int B, int H,
                                     int Sq, int Skv, int d, int dtype,
                                     int causal, float scale, int split,
                                     void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (d) {
    case 16: err = repro::launch<16>(q, k, v, o, B, H, Sq, Skv, dtype, causal, scale, split, s); break;
    case 32: err = repro::launch<32>(q, k, v, o, B, H, Sq, Skv, dtype, causal, scale, split, s); break;
    case 64: err = repro::launch<64>(q, k, v, o, B, H, Sq, Skv, dtype, causal, scale, split, s); break;
    case 128: err = repro::launch<128>(q, k, v, o, B, H, Sq, Skv, dtype, causal, scale, split, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
