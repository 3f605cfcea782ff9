// Low-rank-residual soft threshold of DCF-PCA, batched over a leading client
// axis E, fp32 on the CUDA cores.
//
//   residual_shrink  S[e] = W[e] * sign(R) * max(|R| - lam[e], 0),
//                    R = M[e] - U[e] V[e]^T   (W = 1 without a mask)
//       replaces repro/kernels/shrinkage.py::_shrink_kernel (:41) and
//       _shrink_masked_kernel (:57).
//   residual_shrink_psi  the same S and, from the same residual in
//                    registers, Psi[e] = W[e] * R - S[e] (R - S unmasked)
//       replaces _shrink_psi_kernel (:48) and _shrink_psi_masked_kernel
//       (:66), with the reference's formulas (not clip(R), which equals
//       them only up to rounding).  WITH_PSI is a template flag on the one
//       tile, so S is the shrink's S bit for bit.
//
// M is fp32 or bf16 (upcast on load); W is absent, a dense fp32 plane or a
// bit-packed one, read as it is (the reference unpacks a packed plane
// first; here its bits cost 1/8 byte an entry instead of 4).
//
// What bounds it on an H100: it depends on r.  Each output entry costs 2r
// FLOP of U V^T against 6-16 bytes (read M and W, write S; Psi adds 4):
// ~37 FLOP/byte at r = 150, right of the fp32 ridge (~20 FLOP/byte), so
// the FMAs bound it there; at r = 64 ~11 with fp32 M and a dense mask (the
// bytes bound it) and ~21 with bf16 M and a packed mask (near the ridge).
// Two kernels, by rank (kernels/shrinkage.py::shrink_plan picks the route).
// Up to r = 256 (shrink_kernel) the design is tile64.cuh's, shared with the
// contractions: one block computes one 64 x 64 output tile from 64-row
// slices of U and V staged by cp.async, each of its 256 threads a 4 x 4
// patch of U V^T read as float4 along the rank axis (8 shared loads for 64
// FMAs per 4 ranks).  A thread's M (and W) entries load before the staging
// wait, so their latency hides under it.  Two blocks share an SM up to r =
// 192, so one block's staging runs under the other's FMAs.  Above 256
// (shrink_stream_kernel, below) one block computes a 128 x 64 tile in 8 x 8
// patches, the rank axis streaming by TMA through a two-stage ring of
// 32-rank slabs.  In both the rank sum runs in one fixed order whatever the
// mask, so an all-ones mask gives the bits of none and a packed mask those
// of the dense plane it packs; a warp's loads of M and stores of S and Psi
// cover 4 rows x 8 adjacent columns (whole 32-byte sectors); the residual
// lives only in registers, and M, W, S (and Psi) each cross device memory
// once.
#include "hopper.cuh"
#include "tile.cuh"
#include "tile64.cuh"

namespace repro {
namespace {

// The epilogue of one entry: S = W sign(R) max(|R| - lam, 0) (and Psi =
// W R - S) for R = x - low, stored at `at` of the client's plane.  A NaN
// residual gives a NaN S (max_nan), as the plain versions' sign and clamp
// do; R = 0 gives +0.
template <int MASK, bool WITH_PSI>
__device__ __forceinline__ void shrink_one(float x, float wt, float low,
                                           float lam_e, float* s_e,
                                           float* psi_e, size_t at) {
  const float res = x - low;
  const float mag = max_nan(fabsf(res) - lam_e, 0.f);
  const float out = res < 0.f ? -mag : (res == 0.f ? 0.f : mag);
  const float s_ij = apply_mask<MASK>(wt, out);
  s_e[at] = s_ij;
  if constexpr (WITH_PSI) psi_e[at] = apply_mask<MASK>(wt, res) - s_ij;
}

// The epilogue of one thread's 4 x 4 patch (rows i0 + ti + 16 a, columns
// j0 + tj + 16 b), inside the plane.
template <int MASK, bool WITH_PSI>
__device__ __forceinline__ void shrink_store(const float x[4][4],
                                             const float wt[4][4],
                                             const float low[4][4],
                                             float lam_e, float* s_e,
                                             float* psi_e, int i0, int j0,
                                             int ti, int tj, int M, int N) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ti + 16 * a;
    if (i >= M) continue;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = j0 + tj + 16 * b;
      if (j >= N) continue;
      shrink_one<MASK, WITH_PSI>(x[a][b], wt[a][b], low[a][b], lam_e, s_e,
                                 psi_e, static_cast<size_t>(i) * N + j);
    }
  }
}

template <int RQ>
__host__ __device__ constexpr size_t shrink_smem_bytes() {
  return sizeof(float) * 2 * kT64 * ld64<RQ>();
}

// Grid (n tiles, m tiles, E).
template <int RQ, typename TM, int MASK, bool WITH_PSI>
__global__ void __launch_bounds__(
    kT64Threads, two_blocks_fit(shrink_smem_bytes<RQ>()) ? 2 : 1)
shrink_kernel(const float* __restrict__ u, const float* __restrict__ v,
              const TM* __restrict__ m, const void* __restrict__ w,
              const float* __restrict__ lam, float* __restrict__ s,
              float* __restrict__ psi, int M, int N, int r) {
  constexpr int LD = ld64<RQ>();
  extern __shared__ float4 smem4[];
  float* Us = reinterpret_cast<float*>(smem4);  // kT64 x LD
  float* Vs = Us + kT64 * LD;                   // kT64 x LD

  const int e = blockIdx.z;
  const int i0 = blockIdx.y * kT64;
  const int j0 = blockIdx.x * kT64;
  const ClientPlanes<TM, MASK> planes(m, w, e, M, N);
  const float lam_e = lam[e];

  stage_async<RQ>(Us, u + static_cast<size_t>(e) * M * r, i0, M, r);
  stage_async<RQ>(Vs, v + static_cast<size_t>(e) * N * r, j0, N, r);
  cp_async_commit();

  // Patch rows ti + 16 a, columns tj + 16 b; a warp is 4 x 8 threads.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ti = (warp >> 1) * 4 + (lane >> 3);
  const int tj = (warp & 1) * 8 + (lane & 7);
  float x[4][4], wt[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      planes.load(i0 + ti + 16 * a, j0 + tj + 16 * b, x[a][b], wt[a][b]);
  cp_async_wait_all();
  __syncthreads();

  // The rank loop unrolled by 2 (3-4% at r = 150 on an H100; the
  // contractions, which share it, keep theirs).
  float low[4][4];
  patch44<RQ, 2>(Us, Vs, ti, tj, (r + 3) / 4, low);
  shrink_store<MASK, WITH_PSI>(
      x, wt, low, lam_e, s + static_cast<size_t>(e) * M * N,
      WITH_PSI ? psi + static_cast<size_t>(e) * M * N : nullptr, i0, j0, ti,
      tj, M, N);
}

// ---------------------------------------------------------------------------
// Ranks above 256: shrink_stream_kernel.
//
// One block of 128 threads computes one 128 x 64 output tile, each thread
// an 8 x 8 patch of U V^T (rows ti + 16 a, columns tj + 8 b): a 4-rank step
// reads 8 float4 of U and 8 of V from shared memory for 256 FMAs, so the
// shared-load pipe (an LDS.128 costs about 2 SM cycles on an H100) needs
// about half the FMAs' issue time, where the 4 x 4 patch above needs all of
// it.  Two blocks share an SM (254 registers a thread).  The
// rank axis streams through a ring of kStages slabs of kSlab ranks (the
// tile's U rows and V rows, the last slab zero-padded): slab k + kStages -
// 1 lands while slab k is summed, and one loop takes any rank.  A slab is
// staged by TMA (one thread issues two tensor-map copies, completing on
// the stage's mbarrier; no thread spends instructions on the copy) where
// r % 4 == 0 and U and V are 16-byte aligned, else by cp.async in the
// widest pieces they allow.  Its rows are 128 bytes, each 16-byte group g
// of row i stored at g ^ (i % 8) (TMA's 128-byte swizzle), so a warp's
// float4 loads of 4 or 8 adjacent rows hit distinct banks.  Every entry's
// rank sum runs k = 0 .. r - 1 in order from zero, whatever the mask, the
// psi flag and the staging.  M (and W) are read only after the rank loop,
// and a warp's loads of M and stores of S (and Psi) cover 4 rows x 8
// adjacent columns: whole 32-byte sectors.
constexpr int kStreamRows = 128;    // rows of one output tile
constexpr int kStreamCols = 64;     // columns of one output tile
constexpr int kStreamThreads = 128; // 16 ti x 8 tj, a warp 4 ti x 8 tj
constexpr int kStreamBlocks = 2;    // blocks resident on an SM
constexpr int kSlab = 32;           // ranks a staged slab: 128-byte rows
constexpr int kStages = 2;          // slabs in the ring
constexpr int kSlabUBytes = kStreamRows * kSlab * 4;
constexpr int kSlabBytes = (kStreamRows + kStreamCols) * kSlab * 4;
// The ring (1024-byte aligned, as the swizzle needs) and its mbarriers.
constexpr size_t kStreamSmem = 1024 + kStages * kSlabBytes + 8 * kStages;
static_assert(kStreamRows == 16 * 8 && kStreamCols == 8 * 8 &&
                  kStreamThreads == 16 * 8,
              "16 x 8 threads of 8 x 8 patches cover the tile");
static_assert(kSlab == 32 && kSlabUBytes % 1024 == 0 &&
                  kSlabBytes % 1024 == 0,
              "128-byte rows in 1024-byte swizzle atoms");

// Float offset of rank k of row i in a staged slab.
__device__ __forceinline__ int slab_at(int i, int k) {
  return i * kSlab + ((((k >> 2) ^ i) & 7) << 2) + (k & 3);
}

// Stage rows [row0, row0 + ROWS) of ranks [k0, k0 + kw) of a (nrows, r)
// row-major factor into dst by cp.async in pieces of BYTES (r and k0
// multiples of BYTES / 4), zeros past nrows and past kw.
template <int ROWS, int BYTES>
__device__ __forceinline__ void stage_slab_pieces(float* dst,
                                                  const float* src, int row0,
                                                  int nrows, int r, int k0,
                                                  int kw) {
  constexpr int W = BYTES / 4;
  constexpr int RP = kSlab / W;  // pieces a row
  for (int idx = threadIdx.x; idx < ROWS * RP; idx += kStreamThreads) {
    const int ii = idx / RP;
    const int k = (idx - ii * RP) * W;
    const int row = row0 + ii;
    const bool ok = row < nrows && k < kw;
    cp_async<BYTES>(dst + slab_at(ii, k),
                    ok ? src + static_cast<size_t>(row) * r + k0 + k : src,
                    ok);
  }
}

// The widest pieces that the rank and the factor's address allow (k0 is a
// multiple of kSlab, so those of the whole rows).
template <int ROWS>
__device__ __forceinline__ void stage_slab(float* dst, const float* src,
                                           int row0, int nrows, int r,
                                           int k0, int kw) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(src);
  if (r % 4 == 0 && at % 16 == 0)
    stage_slab_pieces<ROWS, 16>(dst, src, row0, nrows, r, k0, kw);
  else if (r % 2 == 0 && at % 8 == 0)
    stage_slab_pieces<ROWS, 8>(dst, src, row0, nrows, r, k0, kw);
  else
    stage_slab_pieces<ROWS, 4>(dst, src, row0, nrows, r, k0, kw);
}

// Adds ranks 4 kq .. 4 kq + 3 of a staged slab to this thread's patch:
// rows ti + 16 a of the U slab against rows tj + 8 b of the V slab, for
// the column groups b < PB (the others lie past the plane).
template <int PB>
__device__ __forceinline__ void patch_step(const float* Us, const float* Vs,
                                           int ti, int tj, int kq,
                                           float low[8][8]) {
  float4 ua[8], vb[PB];
#pragma unroll
  for (int a = 0; a < 8; ++a)
    ua[a] = *reinterpret_cast<const float4*>(Us + slab_at(ti + 16 * a,
                                                          4 * kq));
#pragma unroll
  for (int b = 0; b < PB; ++b)
    vb[b] = *reinterpret_cast<const float4*>(
        Vs + slab_at(tj + 8 * b, 4 * kq));
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < PB; ++b) {
      float l = low[a][b];
      l = fmaf(ua[a].x, vb[b].x, l);
      l = fmaf(ua[a].y, vb[b].y, l);
      l = fmaf(ua[a].z, vb[b].z, l);
      l = fmaf(ua[a].w, vb[b].w, l);
      low[a][b] = l;
    }
}

// Grid (n tiles of kStreamCols, m tiles of kStreamRows, E).  tm_u and tm_v
// are the (r, M, E) and (r, N, E) tensor maps of u and v (boxes of kSlab x
// kStreamRows and kSlab x kStreamCols, 128-byte swizzle) when tma is set,
// unread otherwise.
template <typename TM, int MASK, bool WITH_PSI>
__global__ void __launch_bounds__(kStreamThreads, kStreamBlocks)
shrink_stream_kernel(const __grid_constant__ CUtensorMap tm_u,
                     const __grid_constant__ CUtensorMap tm_v, int tma,
                     const float* __restrict__ u,
                     const float* __restrict__ v, const TM* __restrict__ m,
                     const void* __restrict__ w,
                     const float* __restrict__ lam, float* __restrict__ s,
                     float* __restrict__ psi, int M, int N, int r) {
  extern __shared__ uint8_t smem_raw[];
  float* ring = reinterpret_cast<float*>(
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(ring) + kStages * kSlabBytes);

  const int e = blockIdx.z;
  const int i0 = blockIdx.y * kStreamRows;
  const int j0 = blockIdx.x * kStreamCols;
  const float* ue = u + static_cast<size_t>(e) * M * r;
  const float* ve = v + static_cast<size_t>(e) * N * r;
  const int slabs = (r + kSlab - 1) / kSlab;
  if (tma && threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) hopper::mbar_init(full + st, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  // Slab k into ring stage k % kStages: U rows first, then V rows.
  auto stage = [&](int k) {
    float* us = ring + (k % kStages) * (kSlabBytes / 4);
    if (tma) {
      if (threadIdx.x == 0) {
        uint64_t* bar = full + k % kStages;
        hopper::mbar_arrive_expect_tx(bar, kSlabBytes);
        hopper::tma_load_3d(us, &tm_u, bar, k * kSlab, i0, e);
        hopper::tma_load_3d(us + kSlabUBytes / 4, &tm_v, bar, k * kSlab, j0,
                            e);
      }
    } else {
      const int kw = min(kSlab, r - k * kSlab);
      stage_slab<kStreamRows>(us, ue, i0, M, r, k * kSlab, kw);
      stage_slab<kStreamCols>(us + kSlabUBytes / 4, ve, j0, N, r, k * kSlab,
                              kw);
    }
  };
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < slabs) stage(k);
    cp_async_commit();  // one group a slab, empty ones too
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ti = warp * 4 + (lane >> 3);  // 0 .. 15
  const int tj = lane & 7;                // 0 .. 7
  float low[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) low[a][b] = 0.f;

  // The rank loop over the column groups b < PB.
  auto rank_loop = [&](auto pb) {
    constexpr int PB = decltype(pb)::value;
    for (int k = 0; k < slabs; ++k) {
      // Slab k landed: this thread's copies, or the stage's TMA bytes.
      if (tma)
        hopper::mbar_wait(full + k % kStages, (k / kStages) & 1);
      else
        cp_async_wait<kStages - 2>();
      // Everyone's copies of slab k landed, and nobody reads slab k - 1's
      // stage any more: slab k + kStages - 1 goes there.
      __syncthreads();
      if (k + kStages - 1 < slabs) stage(k + kStages - 1);
      cp_async_commit();
      const float* us = ring + (k % kStages) * (kSlabBytes / 4);
      const float* vs = us + kSlabUBytes / 4;
      const int kw = r - k * kSlab;
      if (kw >= kSlab) {
#pragma unroll
        for (int kq = 0; kq < kSlab / 4; ++kq)
          patch_step<PB>(us, vs, ti, tj, kq, low);
      } else {  // the last slab's 4-rank groups only
        for (int kq = 0; kq < (kw + 3) / 4; ++kq)
          patch_step<PB>(us, vs, ti, tj, kq, low);
      }
    }
  };
  // A tile with at most two column groups inside the plane (n_i = 400: 16
  // columns of the seventh tile) sums only those two: the same FMAs in the
  // same order for every stored entry, at a quarter of the tile's work.
  if (N - j0 <= 16)
    rank_loop(Int<2>{});
  else
    rank_loop(Int<8>{});

  const ClientPlanes<TM, MASK> planes(m, w, e, M, N);
  const float lam_e = lam[e];
  float* s_e = s + static_cast<size_t>(e) * M * N;
  float* psi_e = WITH_PSI ? psi + static_cast<size_t>(e) * M * N : nullptr;
  float x[8][8], wt[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b)
      planes.load(i0 + ti + 16 * a, j0 + tj + 8 * b, x[a][b], wt[a][b]);
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int i = i0 + ti + 16 * a;
    if (i >= M) continue;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int j = j0 + tj + 8 * b;
      if (j >= N) continue;
      shrink_one<MASK, WITH_PSI>(x[a][b], wt[a][b], low[a][b], lam_e, s_e,
                                 psi_e, static_cast<size_t>(i) * N + j);
    }
  }
}

// The (r, rows, E) tensor map of a (E, rows, r) fp32 factor with boxes of
// kSlab ranks x box_rows rows of one client, 128-byte swizzle, zeros out
// of bounds; false where the driver refuses it.
inline bool factor_map(CUtensorMap* map, const float* ptr, int E, int rows,
                       int r, int box_rows) {
  const hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(r),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(E)};
  const cuuint64_t strides[2] = {4ull * r, 4ull * r * rows};
  const cuuint32_t box[3] = {kSlab, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                const_cast<float*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The routes of the C entries (kernels/shrinkage.py::shrink_plan).
enum ShrinkRoute : int { kBaseRoute = 0, kStreamRoute = 1 };

template <int RQ, typename TM, int MASK, bool WITH_PSI>
cudaError_t launch_shrink(const float* u, const float* v, const TM* m,
                          const void* w, const float* lam, float* s,
                          float* psi, int E, int M, int N, int r,
                          cudaStream_t stream) {
  constexpr size_t smem = shrink_smem_bytes<RQ>();
  auto kernel = shrink_kernel<RQ, TM, MASK, WITH_PSI>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kT64 - 1) / kT64, (M + kT64 - 1) / kT64, E);
  kernel<<<grid, kT64Threads, smem, stream>>>(u, v, m, w, lam, s, psi, M, N,
                                              r);
  return cudaGetLastError();
}

template <typename TM, int MASK, bool WITH_PSI>
cudaError_t launch_shrink_stream(const float* u, const float* v, const TM* m,
                                 const void* w, const float* lam, float* s,
                                 float* psi, int E, int M, int N, int r,
                                 cudaStream_t stream) {
  auto kernel = shrink_stream_kernel<TM, MASK, WITH_PSI>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kStreamSmem));
  if (err != cudaSuccess) return err;
  // TMA where the maps' strides (r floats) and bases are 16-byte aligned.
  CUtensorMap tm_u = {}, tm_v = {};
  const bool tma = r % 4 == 0 && reinterpret_cast<uintptr_t>(u) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
                   factor_map(&tm_u, u, E, M, r, kStreamRows) &&
                   factor_map(&tm_v, v, E, N, r, kStreamCols);
  const dim3 grid((N + kStreamCols - 1) / kStreamCols,
                  (M + kStreamRows - 1) / kStreamRows, E);
  kernel<<<grid, kStreamThreads, kStreamSmem, stream>>>(
      tm_u, tm_v, tma ? 1 : 0, u, v, m, w, lam, s, psi, M, N, r);
  return cudaGetLastError();
}

// route kBaseRoute: shrink_kernel, r <= 256; kStreamRoute:
// shrink_stream_kernel, any r.
template <bool WITH_PSI>
int shrink_entry(const float* u, const float* v, const void* m, const void* w,
                 const float* lam, float* s, float* psi, int E, int M, int N,
                 int r, int dtype, int mask, int route, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (route == kStreamRoute && r >= 1)
    return dispatch_planes(dtype, mask, [&](auto tm, auto mk) {
      using TM = typename decltype(tm)::type;
      return launch_shrink_stream<TM, decltype(mk)::value, WITH_PSI>(
          u, v, static_cast<const TM*>(m), w, lam, s, psi, E, M, N, r, st);
    });
  if (route != kBaseRoute) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(r, dtype, mask, [&](auto rq, auto tm, auto mk) {
    using TM = typename decltype(tm)::type;
    constexpr int RQ = decltype(rq)::value;
    if constexpr (RQ == kChunked)  // r > 256 takes the stream route
      return cudaErrorInvalidValue;
    else
      return launch_shrink<RQ, TM, decltype(mk)::value, WITH_PSI>(
          u, v, static_cast<const TM*>(m), w, lam, s, psi, E, M, N, r, st);
  });
}

}  // namespace
}  // namespace repro

// Both entries return cudaGetLastError() of the launch (0 on success).  m is
// fp32 or bf16 (dtype code), w null, dense or bit-packed (mask code 0, 1 or
// 2, tile.cuh); route 0 launches shrink_kernel (r <= 256), 1
// shrink_stream_kernel (kernels/shrinkage.py::shrink_plan).
extern "C" int repro_residual_shrink(const float* u, const float* v,
                                     const void* m, const void* w,
                                     const float* lam, float* s, int E, int M,
                                     int N, int r, int dtype, int mask,
                                     int route, void* stream) {
  return repro::shrink_entry<false>(u, v, m, w, lam, s, nullptr, E, M, N, r,
                                    dtype, mask, route, stream);
}

extern "C" int repro_residual_shrink_psi(const float* u, const float* v,
                                         const void* m, const void* w,
                                         const float* lam, float* s,
                                         float* psi, int E, int M, int N,
                                         int r, int dtype, int mask,
                                         int route, void* stream) {
  return repro::shrink_entry<true>(u, v, m, w, lam, s, psi, E, M, N, r, dtype,
                                   mask, route, stream);
}

// Blocks of shrink_stream_kernel (M type, mask mode and psi flag by code)
// resident at once on one SM of the current device
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -1 on an error.
extern "C" int repro_shrink_stream_resident(int dtype, int mask, int psi) {
  int blocks = -1;
  repro::dispatch_planes(dtype, mask, [&](auto tm, auto mk) {
    using TM = typename decltype(tm)::type;
    constexpr int MASK = decltype(mk)::value;
    auto kernel = repro::shrink_stream_kernel<TM, MASK, false>;
    if (psi) kernel = repro::shrink_stream_kernel<TM, MASK, true>;
    const int smem = static_cast<int>(repro::kStreamSmem);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kernel, repro::kStreamThreads, smem);
    if (err != cudaSuccess) blocks = -1;
    return err;
  });
  return blocks;
}
