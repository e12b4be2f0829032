// Stratified nearest-center assignment from raw rows for Hopper (sm_90a):
// the hand-written CUDA family that replaces two of the four Pallas TPU
// kernels of msm_we_tpu/ops/pallas_kernels.py.
//
//   msm_transform_assign_child  <- _transform_assign_child_kernel :473 (H1)
//   msm_transform_assign        <- _transform_assign_kernel       :271 (H2)
//
// H3 (_kernel, msm_assign_flux) and H4 (_assign_kernel, msm_pair_assign)
// take feature rows and have their own bin-grouped kernels in
// assign_flux.cu and pair_assign.cu, which score bitwise as this family
// does.
//
// What it computes, per row (a WE segment's parent or child frame): the
// features g = x P of the raw row; the first minimum of c2 - 2 g.c over
// the valid centers of the row's WE bin (c2 = |c|^2; the entry points fold
// the PCA centering into c2adj = |c|^2 + 2 (mu P).c); the basis/target
// overrides in flux order (basis wins); and, for two row sets, the segment
// weight scattered into the (S, S) flux matrix. H1 can also emit g, or
// emit g alone (idx null: no scoring, no ids). The hot step's
// features-only transform now has a kernel of its own
// (transform_features.cu: both raw sets a launch, TMA-fed, the same fmaf
// order); idx == null here remains for F above that kernel's 32 features.
//
// What bounds it on an H100 (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores), at 102,400 rows a set, raw 900 -> F features, K = 250:
//  * at F = 30: bytes. The raw rows are 369 MB a set (737 MB for H2's two
//    sets), 0.110 / 0.221 ms; the transform's 4 N D F = 5.5 / 11.1 GFLOP
//    take 0.083 / 0.165 ms, close behind.
//  * at F = 300: operations, 55 / 111 GFLOP of transform, 0.83 / 1.65 ms,
//    against the same bytes.
//
// Design. A block owns a tile of BM rows (BM = 128, or 64/32/16 where a
// wide F would not fit 130 KB of shared memory): BM rows of one set, or,
// for two sets, the parent and child rows of BM/2 segments, so that each
// segment's two ids meet in one thread for the flux. Transform, scoring and
// the bank's staging then run once a tile for both sets.
//  * Transform (H1/H2): features in chunks of 32 columns; for each, the
//    raw rows stream through shared memory in BM x 32 chunks of D, filled
//    by cp.async in a ring of kStages stages (16-byte cp.async.cg, L1
//    bypassed, neighbouring threads on neighbouring 16-byte words of one
//    row; a 4-byte path for D % 4 != 0 or an unaligned base), so chunk d+1
//    is in flight while chunk d is multiplied. P is staged beside it in
//    32 x 32 chunks (4-byte cp.async: any F, L2-resident). Staging P per
//    chunk keeps a BM = 128 block at 62 KB of shared memory and at most
//    168 registers a thread, three blocks an SM; all of P (900 x 32 x 4 B
//    = 115 KB) would allow one. Two stages measured faster than three or
//    four on the H100 at D = 900, F = 30: the third block an SM hides more
//    latency than a deeper ring.
//  * A register micro-tile: each of the 128 threads accumulates BM/16 rows
//    x 4 features, so every P value read from shared memory feeds BM/16
//    FMAs and every raw value 4. The ragged D and N edges are zero-filled.
//  * The finished g tile (BM x F, padded to a multiple of 32 plus 4
//    columns against bank conflicts) stays in shared memory: it is emitted
//    from there, and scoring reads it. No row has to fit in registers, so
//    any F works as long as a 16-row tile and one 32-center bank tile fit
//    in shared memory (F up to about 1,100); wider rows are refused with
//    cudaErrorInvalidValue.
//  * Scoring streams the bank through shared memory in tiles of up to KS
//    centers at full width and scores the g tile against each 32-center
//    sub-tile as a small product: each thread holds a register tile of
//    BM/32 rows x 8 centers (1 x 4 at BM = 16), so one float4 of a row
//    feeds 32 FMAs and one of a center BM/8. A thread multiplies its whole
//    register tile when one of its rows shares a bin with one of its
//    centers (a warp, when one of its lanes does), and the bin mask
//    applies to the score. The (score, id) minima of the threads that
//    share a row are combined lexicographically with warp shuffles.
//  * Exact f32: plain fmaf, no TF32, no tensor cores. Each (row, feature)
//    of g is one fmaf chain from 0.f over d ascending, and each (row,
//    center) dot one chain from 0.f over f ascending (zero pads add exact
//    zeros), whatever the tiling: so the results do not depend on BM.
//    Scores are __fsub_rn(c2, __fmul_rn(2, dot)); ties go to the
//    lower center index (strict < upward, lexicographic across threads).
//  * The flux epilogue is one atomicAdd per row with nonzero weight into
//    the (S, S) matrix, f64 natively on sm_90 (or f32, following the dtype
//    of w). The summation order is unspecified, so only dyadic weights
//    compare bitwise.
//  * A row whose bin matches no valid center keeps id 0 (the Pallas
//    min-of-iota convention); such rows carry weight 0 by contract.
//
// Plain C interface for ctypes. Every entry point launches on the given
// stream, does not synchronise, allocates nothing, and returns the first
// CUDA error of the launch (cudaGetLastError()), so a refused launch is
// reported.

#include <cuda_runtime.h>
#include <stdint.h>
#include <climits>
#include <cmath>

#include "assign_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kFeatTile = 32;    // feature columns per transform pass / score chunk
constexpr int kDepth = 32;       // raw columns (d) per pipeline stage
constexpr int kStages = 2;       // cp.async ring depth
constexpr int kRowStride = kDepth + 4;  // staged raw row, floats (bank spread)
constexpr int kCenterTile = 32;  // centers scored per register sub-tile
constexpr int kBankTileBytes = 32768;  // least bank tile in shared memory
constexpr int kColGroups = kFeatTile / 4;        // 8 threads along features
constexpr int kRowGroups = kThreads / kColGroups;  // 16 along rows
constexpr size_t kTileBytes = 130 * 1024;  // preferred shared memory of a block

struct RowSet {
  const float* x;          // (n, D) raw rows
  const int32_t* bin;      // (n,) remapped WE bin; -1 matches no center
  const uint8_t* basis;    // (n,) or null
  const uint8_t* target;   // (n,) or null
  int32_t* idx;            // (n,) output ids, or null: features only
  float* feats;            // (n, F) emitted features (raw x P), or null
};

struct Bank {
  const float* centers;    // (K, F) compact bank: row index == global id
  const float* c2;         // (K,) |c|^2, or c2adj for the transform entries
  const int32_t* cbin;     // (K,) owning WE bin
  const uint8_t* valid;    // (K,)
  int K;
};

// Shapes shared by every row of a launch
struct Dims {
  int n, D, F;
  int Fp;  // F rounded up to kFeatTile
  int GS;  // g tile row stride, floats: Fp + 4 (odd in float4 units)
  int KS;  // bank centers staged per tile, a multiple of kCenterTile
};

// The rows of a block's tile: rows r < half are rows row0 + r of set 0,
// the others rows row0 + r - half of set 1 (a single-set launch has
// half = BM and set 0 == set 1)
struct Tile {
  const float* x0;
  const float* x1;
  const int32_t* bin0;
  const int32_t* bin1;
  int row0, half;
};

// Set (0 or 1) and row of tile row r
__device__ __forceinline__ int tile_row(const Tile& t, int r, int& row) {
  const int s = r >= t.half;
  row = t.row0 + r - s * t.half;
  return s;
}

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// One pipeline stage: the tile's raw rows x columns d0..d0+kDepth-1 and P
// rows d0.. x feature columns f0..f0+kFeatTile-1; out of range reads
// zero-fill.
template <int BM>
__device__ __forceinline__ void load_stage(float* xs, float* ps, const Tile& t,
                                           const float* __restrict__ proj,
                                           const Dims& dm, int d0, int f0,
                                           bool vec) {
  const int tid = threadIdx.x;
  if (vec) {  // 16-byte words: 8 threads cover one row's 128 bytes
#pragma unroll
    for (int m = 0; m < BM * (kDepth / 4) / kThreads; ++m) {
      const int e = tid + m * kThreads;
      const int r = e / (kDepth / 4), q = e % (kDepth / 4);
      int row;
      const float* raw = tile_row(t, r, row) ? t.x1 : t.x0;
      const int d = d0 + 4 * q;
      const bool ok = row < dm.n && d < dm.D;  // D % 4 == 0: whole words
      cp_async16(xs + r * kRowStride + 4 * q,
                 ok ? raw + size_t(row) * dm.D + d : raw, ok);
    }
  } else {  // 4-byte words: a warp covers one row's 32 columns
#pragma unroll 4
    for (int m = 0; m < BM * kDepth / kThreads; ++m) {
      const int e = tid + m * kThreads;
      const int r = e / kDepth, c = e % kDepth;
      int row;
      const float* raw = tile_row(t, r, row) ? t.x1 : t.x0;
      const int d = d0 + c;
      const bool ok = row < dm.n && d < dm.D;
      cp_async4(xs + r * kRowStride + c, ok ? raw + size_t(row) * dm.D + d : raw, ok);
    }
  }
#pragma unroll
  for (int m = 0; m < kDepth * kFeatTile / kThreads; ++m) {
    const int e = tid + m * kThreads;
    const int d = d0 + e / kFeatTile, f = f0 + e % kFeatTile;
    const bool ok = d < dm.D && f < dm.F;
    cp_async4(ps + e, ok ? proj + size_t(d) * dm.F + f : proj, ok);
  }
}

// g tile (BM x Fp in gs) = the tile's raw rows x P, columns past F zero.
// Every thread of the block must call this (it synchronises).
template <int BM>
__device__ void transform_tile(const Tile& t, const float* __restrict__ proj,
                               const Dims& dm, float* gs, float* us) {
  constexpr int TM = BM / kRowGroups;  // rows per thread: ty, ty + 16, ...
  float* xs = us;                                   // kStages x BM x kRowStride
  float* ps = us + kStages * BM * kRowStride;       // kStages x kDepth x kFeatTile
  const int tx = threadIdx.x % kColGroups, ty = threadIdx.x / kColGroups;
  const bool vec = dm.D % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(t.x0) | reinterpret_cast<uintptr_t>(t.x1)) & 15) == 0;
  const int nk = (dm.D + kDepth - 1) / kDepth;
  for (int f0 = 0; f0 < dm.Fp; f0 += kFeatTile) {
    float acc[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    __syncthreads();  // the previous pass's stages are free
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nk)
        load_stage<BM>(xs + s * BM * kRowStride, ps + s * kDepth * kFeatTile,
                       t, proj, dm, s * kDepth, f0, vec);
      cp_async_commit();
    }
    for (int c = 0; c < nk; ++c) {
      cp_async_wait<kStages - 2>();  // chunk c has landed (this thread's part)
      __syncthreads();               // ... everyone's; chunk c - 1 is consumed
      const int nxt = c + kStages - 1;
      if (nxt < nk) {
        const int slot = nxt % kStages;
        load_stage<BM>(xs + slot * BM * kRowStride, ps + slot * kDepth * kFeatTile,
                       t, proj, dm, nxt * kDepth, f0, vec);
      }
      cp_async_commit();
      const float* x = xs + (c % kStages) * BM * kRowStride;
      const float* p = ps + (c % kStages) * kDepth * kFeatTile;
#pragma unroll
      for (int d = 0; d < kDepth; d += 4) {
        float4 xv[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i)
          xv[i] = *reinterpret_cast<const float4*>(x + (ty + kRowGroups * i) * kRowStride + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 pv = *reinterpret_cast<const float4*>(p + (d + j) * kFeatTile + 4 * tx);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float xval = j == 0 ? xv[i].x : j == 1 ? xv[i].y : j == 2 ? xv[i].z : xv[i].w;
            acc[i][0] = fmaf(xval, pv.x, acc[i][0]);
            acc[i][1] = fmaf(xval, pv.y, acc[i][1]);
            acc[i][2] = fmaf(xval, pv.z, acc[i][2]);
            acc[i][3] = fmaf(xval, pv.w, acc[i][3]);
          }
        }
      }
    }
    cp_async_wait<0>();
#pragma unroll
    for (int i = 0; i < TM; ++i)
      *reinterpret_cast<float4*>(gs + (ty + kRowGroups * i) * dm.GS + f0 + 4 * tx) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
  __syncthreads();  // the g tile is complete
}

// First minimum of c2 - 2 g.c over the valid centers of each row's bin for
// the BM rows of the g tile (rows past n hold a bin no center has), into
// sid[r] for tile row r. The block works as a small product: each thread
// holds TMS rows x TNS centers of a 32-center sub-tile, so a shared-memory
// float4 of a row feeds TNS x 4 FMAs and one of a center TMS x 4. Every
// thread of the block must call this (it synchronises).
template <int BM>
__device__ void score_rows(const float* gs, const Dims& dm, const Tile& t,
                           const Bank bank, float* us, int* sid) {
  constexpr int TMS = BM >= 32 ? BM / 32 : 1;    // rows per thread
  constexpr int RGS = BM / TMS;                  // row groups: 32 (16 at BM 16)
  constexpr int CGS = kThreads / RGS;            // center groups: 4 (8)
  constexpr int TNS = kCenterTile / CGS;         // centers per thread: 8 (4)
  constexpr int kWarps = kThreads / 32;
  const int tid = threadIdx.x, cx = tid % CGS, ry = tid / CGS;
  const int lane = tid % 32, warp = tid / 32;
  const int CS = dm.Fp + 4;                            // center row stride
  float* cs = us;                                      // KS x CS
  float* c2s = cs + size_t(dm.KS) * CS;                // KS
  int* cbs = reinterpret_cast<int*>(c2s + dm.KS);      // KS
  int rbin[TMS];
  float best[TMS];
  int best_k[TMS];
#pragma unroll
  for (int i = 0; i < TMS; ++i) {
    int row;
    const int32_t* bins = tile_row(t, ry + RGS * i, row) ? t.bin1 : t.bin0;
    rbin[i] = row < dm.n ? bins[row] : INT_MIN + 1;
    best[i] = INFINITY;
    best_k[i] = -1;
  }
  const int nfc = dm.Fp / kFeatTile;  // 32-feature chunks of a center
  for (int k0 = 0; k0 < bank.K; k0 += dm.KS) {
    const int kt = min(dm.KS, bank.K - k0);
    __syncthreads();  // the previous tile (or the stages) fully consumed
    // cp.async, all in flight at once: a warp stages one 32-feature chunk
    // of a center a step, a feature a lane
    for (int e = warp; e < dm.KS * nfc; e += kWarps) {
      const int k = e / nfc, f = (e % nfc) * kFeatTile + lane;
      const bool ok = k < kt && f < dm.F;
      cp_async4(cs + k * CS + f, ok ? bank.centers + size_t(k0 + k) * dm.F + f
                                    : bank.centers, ok);
    }
    cp_async_commit();
    for (int k = tid; k < dm.KS; k += kThreads) {
      const bool ok = k < kt && bank.valid[k0 + k] != 0;
      c2s[k] = ok ? bank.c2[k0 + k] : 0.f;
      // Invalid or past-the-end centers carry a bin no row can hold
      cbs[k] = ok ? bank.cbin[k0 + k] : INT_MIN;
    }
    cp_async_wait<0>();
    __syncthreads();
    for (int s0 = 0; s0 < kt; s0 += kCenterTile) {
      // The thread's centers are s0 + cx + CGS j: ascending in j, and
      // neighbouring threads read neighbouring centers (no bank conflicts)
      bool need = false;
#pragma unroll
      for (int j = 0; j < TNS; ++j)
#pragma unroll
        for (int i = 0; i < TMS; ++i) need |= cbs[s0 + cx + CGS * j] == rbin[i];
      if (!need) continue;  // a warp runs the sub-tile if one of its lanes needs it
      float acc[TMS][TNS];
#pragma unroll
      for (int i = 0; i < TMS; ++i)
#pragma unroll
        for (int j = 0; j < TNS; ++j) acc[i][j] = 0.f;
#pragma unroll 2
      for (int f = 0; f < dm.Fp; f += 4) {
        float4 gv[TMS];
#pragma unroll
        for (int i = 0; i < TMS; ++i)
          gv[i] = *reinterpret_cast<const float4*>(gs + (ry + RGS * i) * dm.GS + f);
#pragma unroll
        for (int j = 0; j < TNS; ++j) {
          const float4 cv = *reinterpret_cast<const float4*>(cs + (s0 + cx + CGS * j) * CS + f);
#pragma unroll
          for (int i = 0; i < TMS; ++i) {
            acc[i][j] = fmaf(gv[i].x, cv.x, acc[i][j]);
            acc[i][j] = fmaf(gv[i].y, cv.y, acc[i][j]);
            acc[i][j] = fmaf(gv[i].z, cv.z, acc[i][j]);
            acc[i][j] = fmaf(gv[i].w, cv.w, acc[i][j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < TNS; ++j) {
        const int k = s0 + cx + CGS * j;
        const int cb = cbs[k];
        const float c2v = c2s[k];
#pragma unroll
        for (int i = 0; i < TMS; ++i) {
          if (cb != rbin[i]) continue;
          const float sc = __fsub_rn(c2v, __fmul_rn(2.0f, acc[i][j]));
          if (sc < best[i]) {
            best[i] = sc;
            best_k[i] = k0 + k;
          }
        }
      }
    }
  }
  // The CGS neighbouring lanes of a row group combine their minima
#pragma unroll
  for (int i = 0; i < TMS; ++i) {
#pragma unroll
    for (int off = CGS / 2; off > 0; off /= 2) {
      const float sc = __shfl_xor_sync(0xffffffffu, best[i], off);
      const int k = __shfl_xor_sync(0xffffffffu, best_k[i], off);
      if (k >= 0 && better(sc, k, best[i], best_k[i])) {
        best[i] = sc;
        best_k[i] = k;
      }
    }
    if (cx == 0) sid[ry + RGS * i] = best_k[i] < 0 ? 0 : best_k[i];
  }
  __syncthreads();
}

// parent.x == null: one row set (the `child` slot), no parent, no flux.
// child.idx == null: features only (no scoring).
template <int BM, typename WT>
__global__ void __launch_bounds__(kThreads, 3)
stratified_assign_kernel(RowSet parent, RowSet child, const float* proj,
                         Bank bank, const WT* w, WT* fm, Dims dm, int n_states,
                         int overrides) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int sid[BM];
  float* gs = smem;                 // BM x GS
  float* us = smem + BM * dm.GS;    // stages, or the bank tile
  const bool pair = parent.x != nullptr;
  const bool assign = child.idx != nullptr;
  Tile t;
  t.half = pair ? BM / 2 : BM;
  t.row0 = blockIdx.x * t.half;
  t.x0 = pair ? parent.x : child.x;
  t.x1 = child.x;
  t.bin0 = pair ? parent.bin : child.bin;
  t.bin1 = child.bin;
  transform_tile<BM>(t, proj, dm, gs, us);
  if (child.feats != nullptr) {  // one set: the block's rows are contiguous
    const int rows = min(BM, dm.n - t.row0);
    float* out = child.feats + size_t(t.row0) * dm.F;
    for (int e = threadIdx.x; e < rows * dm.F; e += kThreads)
      out[e] = gs[(e / dm.F) * dm.GS + e % dm.F];
  }
  if (!assign) return;
  score_rows<BM>(gs, dm, t, bank, us, sid);
  const int r = threadIdx.x, row = t.row0 + r;
  if (r >= t.half || row >= dm.n) return;

  int p = pair ? sid[r] : 0, c = sid[pair ? t.half + r : r];
  const int basis_id = n_states - 2, target_id = n_states - 1;
  const bool bp = pair && flag(parent.basis, row);
  const bool tp = pair && flag(parent.target, row);
  const bool bc = flag(child.basis, row);
  const bool tc = flag(child.target, row);
  if (overrides == kFluxOrder) {  // end-in-target, start-in-target, then basis
    if (tc) c = target_id;
    if (tp) p = target_id;
    if (bp) p = basis_id;
    if (bc) c = basis_id;
  } else if (overrides == kPredictOrder) {  // target checked last: target wins
    if (bp) p = basis_id;
    if (bc) c = basis_id;
    if (tp) p = target_id;
    if (tc) c = target_id;
  }
  if (pair) parent.idx[row] = p;
  child.idx[row] = c;
  if (fm != nullptr && pair) {
    const WT wv = w[row];
    if (wv != WT(0) && p >= 0 && p < n_states && c >= 0 && c < n_states)
      atomicAdd(fm + size_t(p) * n_states + c, wv);
  }
}

// Dynamic shared memory of a BM-row tile: the g tile, then the larger of
// the transform stages and the least bank tile. Sets dm.KS to the centers
// that region holds (at most K rounded up to a sub-tile).
size_t tile_bytes(int BM, int K, Dims& dm) {
  const size_t g = size_t(BM) * dm.GS * sizeof(float);
  const size_t stages =
      size_t(kStages) * (BM * kRowStride + kDepth * kFeatTile) * sizeof(float);
  const size_t per_center = size_t(dm.Fp + 4) * sizeof(float) + sizeof(float) + sizeof(int);
  size_t u = stages > size_t(kBankTileBytes) ? stages : size_t(kBankTileBytes);
  if (u < kCenterTile * per_center) u = kCenterTile * per_center;
  int ks = int(u / per_center) / kCenterTile * kCenterTile;
  const int k_need = round_up(K, kCenterTile);
  dm.KS = ks < k_need ? ks : k_need;
  return g + u;
}

template <int BM, typename WT>
cudaError_t launch_bm(const RowSet& parent, const RowSet& child,
                      const float* proj, const Bank& bank, const WT* w, WT* fm,
                      const Dims& dm, size_t smem, int n_states, int overrides,
                      cudaStream_t stream) {
  auto kernel = stratified_assign_kernel<BM, WT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int half = parent.x != nullptr ? BM / 2 : BM;  // rows of a set a block
  const int blocks = (dm.n + half - 1) / half;
  kernel<<<blocks, kThreads, smem, stream>>>(parent, child, proj, bank, w, fm,
                                             dm, n_states, overrides);
  return cudaGetLastError();
}

template <typename WT>
int launch(const RowSet& parent, const RowSet& child, const float* proj,
           const Bank& bank, const WT* w, WT* fm, int n, int D, int F,
           int n_states, int overrides, void* stream) {
  if (n <= 0 || bank.K <= 0 || F <= 0 || D <= 0)
    return int(cudaErrorInvalidValue);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return int(err);
  const size_t limit = size_t(optin) - kThreads * sizeof(int);  // static sid
  Dims dm;
  dm.n = n;
  dm.D = D;
  dm.F = F;
  dm.Fp = round_up(F, kFeatTile);
  dm.GS = dm.Fp + 4;
  // The largest tile within kTileBytes, else the largest that fits at all.
  // At F = 300 that is BM = 64, one block an SM, which measured faster on
  // the H100 than BM = 32 at two: each staged P and center value feeds
  // twice the rows.
  const int bms[4] = {128, 64, 32, 16};
  int bm = 0;
  size_t smem = 0;
  for (int pass = 0; pass < 2 && bm == 0; ++pass) {
    for (int b : bms) {
      Dims t = dm;
      const size_t bytes = tile_bytes(b, bank.K, t);
      if (bytes <= (pass == 0 ? kTileBytes : limit)) {
        bm = b;
        smem = bytes;
        dm = t;
        break;
      }
    }
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bm) {
    case 128:
      err = launch_bm<128, WT>(parent, child, proj, bank, w, fm, dm, smem, n_states, overrides, st);
      break;
    case 64:
      err = launch_bm<64, WT>(parent, child, proj, bank, w, fm, dm, smem, n_states, overrides, st);
      break;
    case 32:
      err = launch_bm<32, WT>(parent, child, proj, bank, w, fm, dm, smem, n_states, overrides, st);
      break;
    case 16:
      err = launch_bm<16, WT>(parent, child, proj, bank, w, fm, dm, smem, n_states, overrides, st);
      break;
    default:  // not even a 16-row tile fits: rows too wide
      err = cudaErrorInvalidValue;
  }
  return int(err);
}

Bank make_bank(const float* centers, const float* c2, const int32_t* cbin,
               const uint8_t* valid, int K) {
  Bank b;
  b.centers = centers;
  b.c2 = c2;
  b.cbin = cbin;
  b.valid = valid;
  b.K = K;
  return b;
}

RowSet make_rows(const float* x, const int32_t* bin, const uint8_t* basis,
                 const uint8_t* target, int32_t* idx, float* feats) {
  RowSet r;
  r.x = x;
  r.bin = bin;
  r.basis = basis;
  r.target = target;
  r.idx = idx;
  r.feats = feats;
  return r;
}

}  // namespace

extern "C" {

// H1: child rows only. raw (n, D) x proj (D, F) -> masked nearest center,
// target then basis override (basis wins); feats (n, F) = raw x proj when
// non-null. idx null: features only (feats required), no scoring.
int msm_transform_assign_child(const float* raw, const int32_t* bins,
                               const uint8_t* basis, const uint8_t* target,
                               const float* proj, const float* centers,
                               const float* c2adj, const int32_t* cbin,
                               const uint8_t* valid, int n, int D, int F,
                               int K, int n_states, int32_t* idx, float* feats,
                               void* stream) {
  if (idx == nullptr && feats == nullptr) return int(cudaErrorInvalidValue);
  const RowSet none = make_rows(nullptr, nullptr, nullptr, nullptr, nullptr,
                                nullptr);
  const RowSet child = make_rows(raw, bins, basis, target, idx, feats);
  return launch<float>(none, child, proj,
                       make_bank(centers, c2adj, cbin, valid, K),
                       nullptr, nullptr, n, D, F, n_states,
                       (basis || target) ? kFluxOrder : kNone, stream);
}

// H2: parent and child rows, transform, flux-order overrides (target_p may
// be null), and, when fm is non-null, the (S, S) flux of w (f32 or f64).
int msm_transform_assign(const float* raw_p, const float* raw_c,
                         const int32_t* pbins, const int32_t* cbins,
                         const uint8_t* basis_p, const uint8_t* basis_c,
                         const uint8_t* target_p, const uint8_t* target_c,
                         const void* w, int w_is_f64, const float* proj,
                         const float* centers, const float* c2adj,
                         const int32_t* cbin, const uint8_t* valid, int n,
                         int D, int F, int K, int n_states, int32_t* pidx,
                         int32_t* cidx, void* fm, void* stream) {
  const RowSet parent = make_rows(raw_p, pbins, basis_p, target_p, pidx,
                                  nullptr);
  const RowSet child = make_rows(raw_c, cbins, basis_c, target_c, cidx,
                                 nullptr);
  const Bank bank = make_bank(centers, c2adj, cbin, valid, K);
  if (w_is_f64)
    return launch<double>(parent, child, proj, bank,
                          static_cast<const double*>(w),
                          static_cast<double*>(fm), n, D, F, n_states,
                          kFluxOrder, stream);
  return launch<float>(parent, child, proj, bank,
                       static_cast<const float*>(w),
                       static_cast<float*>(fm), n, D, F, n_states,
                       kFluxOrder, stream);
}

}  // extern "C"
