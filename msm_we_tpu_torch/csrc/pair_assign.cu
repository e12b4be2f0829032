// H4 for Hopper (sm_90a): nearest valid same-bin center ids for one or two
// feature row sets, with the override epilogue. Replaces the Pallas kernel
// msm_we_tpu/ops/pallas_kernels.py::_assign_kernel (:150), called through
// _assign_call (:203). Wrapper: ops/stratified_assign.py::pair_assign.
//
// What it computes, per row of the parent set (rows 0..n_parent-1 of the
// plan) or the child set (the rest): the first minimum of |c|^2 - 2 x.c
// over the valid centers of the row's WE bin, id 0 where the bin has none
// (bin -1 included), then the basis/target overrides in flux order (basis
// wins) or predict order (target wins), each side from its own flags.
// Optionally (no overrides) it also stores each row's winning score, +inf
// where the bin has no valid center: the model axis of parallel/sharded.py
// combines the (score, id) minima of the bank's shards.
//
// What bounds it on an H100: bytes. At 2 x 102,400 rows of 30 f32 features
// and 25 same-bin centers a row, it must read 24.6 MB of features plus
// bins and masks and write 0.8 MB of ids, about 26.5 MB, or 7.9 us at
// 3.35 TB/s; the 0.31 GFLOP of same-bin products take 4.6 us at 67 TFLOP/s
// (f32 without tensor cores).
//
// Design. The rows are grouped before the launch (``_bin_tiles``: the
// plan kernels below around one stable torch.sort of the row groups): the
// rows sorted stably by their bin's first center in the bin-sorted bank,
// and a table of tiles, each at most kTileRows rows of one bin and the
// range of that bin's centers. A tile with no centers holds rows whose bin
// has no valid center: they get id 0. So
//  * a block scores its rows against its bin's centers only: the work is
//    O(rows x centers per bin), not O(rows x K) as in H1/H2 of
//    stratified_assign.cu, where every block scans the whole bank;
//  * every warp's rows share a bin, so no lane idles on another bin's
//    centers;
//  * features stream through shared memory in chunks of kFeatChunk, so no
//    row has to fit in registers and any feature width works, with no
//    padding to 32/64/128. Each thread keeps a 4 x 4 register tile of
//    (row, center) dot products across the chunks, fed by one float4 of
//    rows and one of centers per feature.
// Scores are bitwise those of stratified_assign.cu and assign_flux.cu: one
// fmaf chain per (row, center) over f = 0..F-1 ascending from 0.f, carried
// across chunks, then __fsub_rn(c2, __fmul_rn(2.f, dot)) with the wrapper's
// c2. The (score, id) minimum is lexicographic within a thread and across
// the 8 threads that share a row (warp shuffles), so ties go to the lower
// original center id. No atomics and no timing-dependent order: results
// repeat bitwise.
// Exact f32 only: no TF32, no tensor cores.
//
// The grid is an upper bound on the tiles; blocks past the last tile exit.
// Plain C interface for ctypes: launches on the given stream, does not
// synchronise, allocates nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>
#include <cmath>

#include "assign_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTileRows = 64;      // = TILE_ROWS in ops/stratified_assign.py
constexpr int kCenterChunk = 32;   // centers staged per pass
constexpr int kFeatChunk = 32;     // features staged per pass
constexpr int kRowGroups = 16;     // threads along rows
constexpr int kCenterGroups = kThreads / kRowGroups;       // 8, along centers
constexpr int kRowsPerThread = kTileRows / kRowGroups;     // 4
constexpr int kCentersPerThread = kCenterChunk / kCenterGroups;  // 4
constexpr int kWarps = kThreads / 32;
static_assert(kCenterGroups == 8, "the shuffle reduction spans 8 lanes");
static_assert(kFeatChunk == 32, "rows and centers are staged a feature a lane");
static_assert(kRowsPerThread == 4 && kCentersPerThread == 4, "float4 reads");

// ------------------------------------------------------------------ plan
// The launch plan of ``_bin_tiles_plain`` (ops/stratified_assign.py) on the
// device, equal to it element for element: centers sorted stably by bin
// (invalid ones last), each row's group (the sorted position of its bin's
// first valid center, or K: no center), then, after a stable sort of the
// groups, the tile table. Integer work only, no atomics.

constexpr long long kNoBin = 1LL << 40;  // key of an invalid center
constexpr int kPlanThreads = 256;
constexpr int kScanThreads = 1024;

__device__ __forceinline__ long long center_key(const int32_t* cbin,
                                                const uint8_t* valid, int i) {
  return valid[i] ? static_cast<long long>(cbin[i]) : kNoBin;
}

// Stable sort of the center keys by counting each key's rank
__global__ void __launch_bounds__(kPlanThreads)
plan_centers_kernel(const int32_t* __restrict__ cbin,
                    const uint8_t* __restrict__ valid, int K,
                    int32_t* __restrict__ cperm, long long* __restrict__ ckey) {
  __shared__ long long ks[kPlanThreads];
  const int i = blockIdx.x * kPlanThreads + threadIdx.x;
  const long long key = i < K ? center_key(cbin, valid, i) : 0;
  int rank = 0;
  for (int j0 = 0; j0 < K; j0 += kPlanThreads) {
    __syncthreads();
    const int j = j0 + threadIdx.x;
    ks[threadIdx.x] = j < K ? center_key(cbin, valid, j) : 0;
    __syncthreads();
    const int jn = min(kPlanThreads, K - j0);
    for (int jj = 0; jj < jn; ++jj) {
      const long long kj = ks[jj];
      rank += kj < key || (kj == key && j0 + jj < i);
    }
  }
  if (i < K) {
    cperm[rank] = i;
    ckey[rank] = key;
  }
}

// Each row's group: the sorted position of its bin's first valid center,
// or K when the bin has none (bin -1 included, unless a center has it)
__global__ void __launch_bounds__(kPlanThreads)
plan_rows_kernel(const int32_t* __restrict__ pbins,
                 const int32_t* __restrict__ cbins, int n_parent, int R,
                 const long long* __restrict__ ckey, int K,
                 int32_t* __restrict__ rkey) {
  const int r = blockIdx.x * kPlanThreads + threadIdx.x;
  if (r >= R) return;
  const long long b = r < n_parent ? pbins[r] : cbins[r - n_parent];
  const int lo = search<false>(ckey, K, b);
  rkey[r] = (lo < K && ckey[lo] == b) ? lo : K;
}

// The tile table from the stably sorted groups, in three passes: each
// group's first sorted row (gstart, K + 2 entries, the last R), an
// inclusive scan of the groups' tile counts in one block (gtend, K + 1),
// then each tile (first row, rows, first center, centers); tiles past the
// last are 0.
__global__ void __launch_bounds__(kPlanThreads)
plan_groups_kernel(const int32_t* __restrict__ rkey_s, int R, int G,
                   int32_t* __restrict__ gstart) {
  const int g = blockIdx.x * kPlanThreads + threadIdx.x;
  if (g <= G) gstart[g] = g < G ? search<false>(rkey_s, R, g) : R;
}

__global__ void __launch_bounds__(kScanThreads)
plan_scan_kernel(const int32_t* __restrict__ gstart, int G,
                 int32_t* __restrict__ gtend) {
  __shared__ int buf[kScanThreads];
  __shared__ int carry;
  const int tid = threadIdx.x;
  if (tid == 0) carry = 0;
  for (int g0 = 0; g0 < G; g0 += kScanThreads) {
    const int g = g0 + tid;
    __syncthreads();  // carry updated, buf of the previous chunk consumed
    buf[tid] = g < G ? (gstart[g + 1] - gstart[g] + kTileRows - 1) / kTileRows : 0;
    __syncthreads();
    for (int off = 1; off < kScanThreads; off <<= 1) {
      const int v = tid >= off ? buf[tid - off] : 0;
      __syncthreads();
      buf[tid] += v;
      __syncthreads();
    }
    if (g < G) gtend[g] = carry + buf[tid];
    __syncthreads();
    if (tid == kScanThreads - 1) carry += buf[tid];
  }
}

__global__ void __launch_bounds__(kPlanThreads)
plan_tiles_kernel(const int32_t* __restrict__ gstart,
                  const int32_t* __restrict__ gtend,
                  const long long* __restrict__ ckey, int K,
                  int4* __restrict__ tiles, int n_grid) {
  const int t = blockIdx.x * kPlanThreads + threadIdx.x;
  if (t >= n_grid) return;
  const int G = K + 1;
  const int g = search<true>(gtend, G, t);  // first group ending past t
  int4 v = make_int4(0, 0, 0, 0);
  if (g < G) {
    const int j = t - (g > 0 ? gtend[g - 1] : 0);  // tile number in g
    v.x = gstart[g] + j * kTileRows;
    v.y = min(kTileRows, gstart[g + 1] - v.x);
    v.z = g;
    v.w = g < K ? search<true>(ckey, K, ckey[g]) - g : 0;
  }
  tiles[t] = v;
}

// ------------------------------------------------------------------ assign
__global__ void __launch_bounds__(kThreads)
pair_assign_kernel(Sides sides, int n_parent, const long long* __restrict__ order,
                   const int4* __restrict__ tiles,
                   const int32_t* __restrict__ cperm,
                   const float* __restrict__ centers,
                   const float* __restrict__ c2, int F, int n_states,
                   int overrides, float* __restrict__ pscore,
                   float* __restrict__ cscore) {
  // Feature-major, rows padded to 16 bytes: a thread reads its 4 rows and
  // its 4 centers of one feature as one float4 each
  __shared__ __align__(16) float xs[kFeatChunk][kTileRows + 4];
  __shared__ __align__(16) float cs[kFeatChunk][kCenterChunk + 4];
  __shared__ int src[kTileRows];      // plan row of each tile row, or -1
  __shared__ int cid[kCenterChunk];   // original id of each staged center
  __shared__ float c2s[kCenterChunk];

  const int4 tile = tiles[blockIdx.x];  // first row, rows, first center, centers
  if (tile.y == 0) return;              // past the last tile (whole block)
  const int tid = threadIdx.x;
  const int cx = tid % kCenterGroups, ry = tid / kCenterGroups;
  const int lane = tid % 32, warp = tid / 32;
  for (int r = tid; r < kTileRows; r += kThreads)
    src[r] = r < tile.y ? static_cast<int>(order[tile.x + r]) : -1;
  __syncthreads();

  float best[kRowsPerThread];
  int best_k[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    best[i] = INFINITY;
    best_k[i] = -1;
  }
  // One feature chunk: the rows are staged once for all center chunks
  const bool rows_once = F <= kFeatChunk;
  for (int cb = 0; cb < tile.w; cb += kCenterChunk) {
    const int kn = min(kCenterChunk, tile.w - cb);
    float acc[kRowsPerThread][kCentersPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kCentersPerThread; ++j) acc[i][j] = 0.f;
    for (int f0 = 0; f0 < F; f0 += kFeatChunk) {
      const int fn = min(kFeatChunk, F - f0);
      __syncthreads();  // the previous chunk fully consumed
      // Each warp stages rows warp, warp + 4, ... and centers likewise,
      // one feature a lane: fixed trip counts, so every load of a stage is
      // in flight before the first store
      if (!rows_once || cb == 0) {
        float v[kTileRows / kWarps];
#pragma unroll
        for (int q = 0; q < kTileRows / kWarps; ++q) {
          const int s = src[warp + kWarps * q];
          v[q] = 0.f;
          if (s >= 0 && lane < fn) {
            const float* x = s < n_parent ? sides.x[0] : sides.x[1];
            v[q] = x[size_t(s < n_parent ? s : s - n_parent) * F + f0 + lane];
          }
        }
#pragma unroll
        for (int q = 0; q < kTileRows / kWarps; ++q) xs[lane][warp + kWarps * q] = v[q];
      }
      {
        float v[kCenterChunk / kWarps];
#pragma unroll
        for (int q = 0; q < kCenterChunk / kWarps; ++q) {
          const int k = warp + kWarps * q;
          v[q] = k < kn && lane < fn
              ? centers[size_t(cperm[tile.z + cb + k]) * F + f0 + lane] : 0.f;
        }
#pragma unroll
        for (int q = 0; q < kCenterChunk / kWarps; ++q) cs[lane][warp + kWarps * q] = v[q];
      }
      if (f0 == 0) {
        for (int k = tid; k < kCenterChunk; k += kThreads) {
          const int id = k < kn ? cperm[tile.z + cb + k] : -1;
          cid[k] = id;
          c2s[k] = id >= 0 ? c2[id] : 0.f;
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int f = 0; f < fn; ++f) {
        const float4 x4 = *reinterpret_cast<const float4*>(&xs[f][ry * kRowsPerThread]);
        const float4 c4 = *reinterpret_cast<const float4*>(&cs[f][cx * kCentersPerThread]);
        const float xv[kRowsPerThread] = {x4.x, x4.y, x4.z, x4.w};
        const float cv[kCentersPerThread] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
          for (int j = 0; j < kCentersPerThread; ++j)
            acc[i][j] = fmaf(xv[i], cv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kCentersPerThread; ++j) {
      const int k = cx * kCentersPerThread + j;
      if (k >= kn) continue;
      const int id = cid[k];
      const float c2v = c2s[k];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float s = __fsub_rn(c2v, __fmul_rn(2.0f, acc[i][j]));
        if (better(s, id, best[i], best_k[i])) {
          best[i] = s;
          best_k[i] = id;
        }
      }
    }
  }

  // The 8 lanes of a row group (consecutive lanes) combine their minima
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
#pragma unroll
    for (int off = kCenterGroups / 2; off > 0; off /= 2) {
      const float s = __shfl_xor_sync(0xffffffffu, best[i], off);
      const int k = __shfl_xor_sync(0xffffffffu, best_k[i], off);
      if (k >= 0 && better(s, k, best[i], best_k[i])) {
        best[i] = s;
        best_k[i] = k;
      }
    }
  }
  if (cx != 0) return;

  const int basis_id = n_states - 2, target_id = n_states - 1;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = ry * kRowsPerThread + i;
    const int s = r < tile.y ? src[r] : -1;
    if (s < 0) continue;
    const bool parent = s < n_parent;
    const int row = parent ? s : s - n_parent;
    int id = best_k[i] < 0 ? 0 : best_k[i];
    const bool b = flag(parent ? sides.basis[0] : sides.basis[1], row);
    const bool t = flag(parent ? sides.target[0] : sides.target[1], row);
    if (overrides == kFluxOrder) {  // target, then basis: basis wins
      if (t) id = target_id;
      if (b) id = basis_id;
    } else if (overrides == kPredictOrder) {  // basis, then target
      if (b) id = basis_id;
      if (t) id = target_id;
    }
    (parent ? sides.idx[0] : sides.idx[1])[row] = id;
    float* score = parent ? pscore : cscore;
    if (score != nullptr) score[row] = best[i];  // +inf: no valid center
  }
}

}  // namespace

extern "C" {

// The H4 plan, first half, and all of H3's: cperm/ckey (K) and each row's
// group rkey (R, parent rows then child rows; pbins null: the child set
// alone).
int msm_pair_plan_keys(const int32_t* pbins, const int32_t* cbins, int n,
                       const int32_t* cbin, const uint8_t* valid, int K,
                       int32_t* cperm, long long* ckey, int32_t* rkey,
                       void* stream) {
  if (n <= 0 || K <= 0) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_parent = pbins != nullptr ? n : 0, R = n_parent + n;
  plan_centers_kernel<<<(K + kPlanThreads - 1) / kPlanThreads, kPlanThreads, 0, st>>>(
      cbin, valid, K, cperm, ckey);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  plan_rows_kernel<<<(R + kPlanThreads - 1) / kPlanThreads, kPlanThreads, 0, st>>>(
      pbins, cbins, n_parent, R, ckey, K, rkey);
  return int(cudaGetLastError());
}

// The H4 plan, second half: the tile table (n_grid x 4) from the stably
// sorted groups rkey_s (R); gstart (K + 2) and gtend (K + 1) are scratch.
int msm_pair_plan_tiles(const int32_t* rkey_s, int R, const long long* ckey,
                        int K, int32_t* gstart, int32_t* gtend,
                        int32_t* tiles, int n_grid, void* stream) {
  if (R <= 0 || K <= 0 || n_grid <= 0) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = K + 1;
  plan_groups_kernel<<<G / kPlanThreads + 1, kPlanThreads, 0, st>>>(
      rkey_s, R, G, gstart);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  plan_scan_kernel<<<1, kScanThreads, 0, st>>>(gstart, G, gtend);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  plan_tiles_kernel<<<(n_grid + kPlanThreads - 1) / kPlanThreads, kPlanThreads, 0, st>>>(
      gstart, gtend, ckey, K, reinterpret_cast<int4*>(tiles), n_grid);
  return int(cudaGetLastError());
}

// H4: nearest valid same-bin center ids for parent and child feature rows
// (fp null: the child set alone), with an optional override epilogue
// (overrides: 0 none, 1 flux order, 2 predict order; masks may be null).
// order (R, int64), tiles (n_tiles x 4) and cperm are the plan: rows of
// the plan are the parent rows, then the child rows. pscore/cscore (may be
// null) receive each row's winning score, +inf where its bin has no valid
// center.
int msm_pair_assign(const float* fp, const float* fc, const uint8_t* basis_p,
                    const uint8_t* basis_c, const uint8_t* target_p,
                    const uint8_t* target_c, const long long* order,
                    const int32_t* tiles, int n_tiles, const int32_t* cperm,
                    const float* centers, const float* c2, int n, int F,
                    int n_states, int overrides, int32_t* pidx,
                    int32_t* cidx, float* pscore, float* cscore,
                    void* stream) {
  if (n <= 0 || F <= 0 || n_tiles <= 0) return int(cudaErrorInvalidValue);
  Sides sides;
  sides.x[0] = fp;
  sides.x[1] = fc;
  sides.basis[0] = basis_p;
  sides.basis[1] = basis_c;
  sides.target[0] = target_p;
  sides.target[1] = target_c;
  sides.idx[0] = pidx;
  sides.idx[1] = cidx;
  pair_assign_kernel<<<n_tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      sides, fp != nullptr ? n : 0, order, reinterpret_cast<const int4*>(tiles),
      cperm, centers, c2, F, n_states, overrides, pscore, cscore);
  return int(cudaGetLastError());
}

}  // extern "C"
