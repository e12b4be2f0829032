// H3 for Hopper (sm_90a): both feature sets of N segments assigned to their
// nearest valid same-bin center, the flux-order overrides, and the (S, S)
// flux of the segment weights. Replaces the Pallas kernel
// msm_we_tpu/ops/pallas_kernels.py::_kernel (:71), called through
// _fused_call (:248). Wrapper: ops/stratified_assign.py::assign_flux.
//
// What it computes, per segment: for the parent row and the child row, the
// first minimum of |c|^2 - 2 x.c over the valid centers of the row's WE bin,
// id 0 where the bin has none (bin -1 included); then end-in-target,
// start-in-target (target_p, may be null), basis, so basis wins; then the
// segment's weight added at (parent id, child id) of the flux, in the dtype
// of w (f32 or f64).
//
// What bounds it on an H100: bytes. At 102,400 segments of 30 f32 features
// a row and 25 same-bin centers a row, it must read 24.6 MB of features
// plus bins, masks and weights and write 0.8 MB of ids, about 27 MB, or
// 8 us at 3.35 TB/s; the 0.31 GFLOP of same-bin products take 4.6 us at
// 67 TFLOP/s (f32 without tensor cores).
//
// Design. The plan is H4's first half (msm_pair_plan_keys, pair_assign.cu):
// the bank sorted stably by bin (cperm; ckey, invalid centers last) and
// each plan row's group rkey (parent rows, then child rows), the sorted
// position of its bin's first valid center, K when the bin has none. A
// group's centers are cperm[g .. g + ncent). No sort of the rows and no
// host synchronisation: the grouping happens inside the block.
//  * A block of 256 threads owns kSegs = 512 consecutive segments, so it
//    holds their parent and child rows (1,024 in all) and each segment's
//    two ids meet in one thread for the flux: one atomicAdd per segment with nonzero weight
//    (f64 natively on sm_90). The summation order of the atomics is
//    unspecified, so only dyadic weights compare bitwise.
//  * The block sorts its rows by (group, row) in shared memory, a bitonic
//    sort of 64-bit keys: rows of one group form a run. A run is cut into
//    tasks of at most kTaskRows rows, and each warp takes the tasks that
//    start in its 32-row stretches of the sorted rows. Rows of group K get
//    id 0 and are not scored. So a row is scored only against its own
//    bin's centers: the work follows the same-bin pairs, not 2 N K.
//  * A task is scored by one warp. Its centers come 32 at a time and its
//    rows and centers go through the warp's own shared memory by cp.async
//    (16-, 8- or 4-byte copies as F and alignment allow), 32 features at a
//    time for wide rows, so any F works and the block's shared memory does
//    not depend on F; each dot stays in a register across the chunks. A
//    task of more than 16 rows gives each lane a 4 x 8 register tile of
//    (row, center) dots, as H4 does, so a float4 read from shared memory
//    feeds 8 or 4 fmaf chains. A shorter task (wide banks: about 4 rows a
//    bin in a block) gives each row 32 / R lanes (R = max(4, the rows
//    rounded up to a power of two)), each with its share of the centers,
//    so a run of a few rows costs about its rows, not 32.
//  * The loops that stage and score read the ids and c2 of the chunk and
//    the task's rows from small per-warp arrays in shared memory, so no
//    loop of a data-dependent trip count holds a shuffle. A task's group
//    size and its first 32 ids come in one round of loads.
//  * Warps synchronise only with __syncwarp while scoring; the block meets
//    after the sort and before the flux.
// Scores are bitwise those of pair_assign.cu (H4) and stratified_assign.cu:
// each (row, center) dot is one fmaf chain over f = 0..F-1 ascending from
// 0.f, carried across chunks, the score __fsub_rn(c2, __fmul_rn(2.f, dot))
// with the wrapper's c2, and the (score, id) minimum is lexicographic
// within a lane and across the warp's lanes (shuffles), so ties go to the
// lower center id. Exact f32 only: no TF32, no tensor cores.
//
// Plain C interface for ctypes: launches on the given stream, does not
// synchronise, allocates nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>
#include <cmath>

#include "assign_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSegs = 512;            // = SEGMENTS_PER_BLOCK in ops/stratified_assign.py
constexpr int kRows = 2 * kSegs;      // parent rows, then child rows
constexpr int kTaskRows = 32;         // = TASK_ROWS in ops/stratified_assign.py
constexpr int kChunk = 32;            // features staged per pass
constexpr int kCenters = 32;          // centers staged per pass
constexpr int kBlocksPerSM = 2;       // launch bounds
constexpr int kStride = kChunk + 4;   // staged row, floats: 16-byte rows, float4 reads
// A warp's centers and rows, then the chunk's ids and c2 and the task's rows
constexpr int kWarpFloats = (kCenters + kTaskRows) * kStride + 3 * 32;
constexpr size_t kSmemBytes = kRows * (sizeof(unsigned long long) + sizeof(int)) +
                              size_t(kWarps) * kWarpFloats * sizeof(float);
constexpr unsigned kFull = 0xffffffffu;
static_assert((kRows & (kRows - 1)) == 0, "the bitonic sort needs a power of two");
static_assert(kRows % (2 * kThreads) == 0, "whole compare-exchange passes");
static_assert(kRows <= (1 << 16), "a row takes the low 16 bits of its key");
static_assert(kTaskRows == 32 && kChunk == 32 && kCenters == 32,
              "a lane a row, a feature, a center");

// Stages centers j0 .. j0 + nj - 1 of the current chunk (their ids in wid;
// past kn: zeros) and the task's first nx rows (their block rows in wrow),
// features f0 .. f0 + fn - 1 (zeros past fn), all copies in flight at once:
// vw features a lane (4: F % 4 == 0 and 16-byte aligned bases; 2: F even
// and 8-byte aligned; else 1), so one copy covers vw rows. The ids come
// from shared memory, so no loop here holds a shuffle.
__device__ __forceinline__ void stage(float* cs, float* xs, const int* wid, const int* wrow,
                                      int j0, int nj, int kn, int nx, const Sides& sides,
                                      int seg0, const float* __restrict__ centers,
                                      int F, int f0, int fn, int vw) {
  const int lane = threadIdx.x % 32;
  __syncwarp();  // the previous pass has read cs and xs; wid and wrow are written
  const int lpr = 32 / vw;  // lanes a row
  const int h = lane / lpr, fl = vw * (lane % lpr);
  const bool fok = fl < fn;  // fn is a multiple of vw
  for (int u = h; u < nj; u += vw) {
    const int j = j0 + u;
    const bool ok = j < kn && fok;
    const float* src = ok ? centers + size_t(wid[j]) * F + f0 + fl : centers;
    if (vw == 4) cp_async16(cs + j * kStride + fl, src, ok);
    else if (vw == 2) cp_async8(cs + j * kStride + fl, src, ok);
    else cp_async4(cs + j * kStride + fl, src, ok);
  }
  for (int i = h; i < nx; i += vw) {
    const int r = wrow[i];
    const float* x = r < kSegs ? sides.x[0] + size_t(seg0 + r) * F
                               : sides.x[1] + size_t(seg0 + r - kSegs) * F;
    const float* src = x + (fok ? f0 + fl : 0);
    if (vw == 4) cp_async16(xs + i * kStride + fl, src, fok);
    else if (vw == 2) cp_async8(xs + i * kStride + fl, src, fok);
    else cp_async4(xs + i * kStride + fl, src, fok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();
}

// acc[t] += row . center t of this lane's pass over fn staged features:
// one fmaf chain per (row, center), f ascending
template <int NT>
__device__ __forceinline__ void dot_pass(const float* xr, const float* cr, int step,
                                         int fn, float* acc) {
  int f = 0;
#pragma unroll 1
  for (; f + 4 <= fn; f += 4) {
    const float4 x4 = *reinterpret_cast<const float4*>(xr + f);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const float4 c4 = *reinterpret_cast<const float4*>(cr + t * step + f);
      acc[t] = fmaf(x4.x, c4.x, acc[t]);
      acc[t] = fmaf(x4.y, c4.y, acc[t]);
      acc[t] = fmaf(x4.z, c4.z, acc[t]);
      acc[t] = fmaf(x4.w, c4.w, acc[t]);
    }
  }
#pragma unroll 1
  for (; f < fn; ++f) {
    const float xv = xr[f];
#pragma unroll
    for (int t = 0; t < NT; ++t) acc[t] = fmaf(xv, cr[t * step + f], acc[t]);
  }
}

constexpr int kMaxNT = 16;  // centers a lane scores in one pass of score_task

// A task of 17 to 32 rows (R = 32): lane l holds rows l / 4 + 8 i (i < 4)
// and centers l % 4 + 4 t (t < 8) of each 32-center chunk, a 4 x 8 register
// tile as in H4's kernel, so each float4 read from shared memory feeds 8 or
// 4 fmaf chains. The 4 lanes of a row combine their minima at the end.
__device__ void score_long(const Sides& sides, int seg0, int nr, int c0, int nc,
                           int first_ids, const int32_t* __restrict__ cperm,
                           const float* __restrict__ centers,
                           const float* __restrict__ c2, int F, int vw, float* cs,
                           float* xs, int* wid, float* wc2, const int* wrow, int* sid) {
  const int lane = threadIdx.x % 32, rg = lane >> 2, cq = lane & 3;
  const bool one_f = F <= kChunk;
  float best[4];
  int best_k[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    best[i] = INFINITY;
    best_k[i] = -1;
  }
  for (int cb = 0; cb < nc; cb += kCenters) {
    const int kn = min(kCenters, nc - cb);
    const int cid = lane >= kn ? -1 : cb == 0 ? first_ids : cperm[c0 + cb + lane];
    const float c2l = cid >= 0 ? c2[cid] : 0.f;  // read by the scores only
    __syncwarp();  // the previous chunk's scores have read wid and wc2
    wid[lane] = cid;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int t = 0; t < 8; ++t) acc[i][t] = 0.f;
    for (int f0 = 0; f0 < F; f0 += kChunk) {
      const int fn = min(kChunk, F - f0);
      // Up to 32 features: the rows once, with the first chunk
      stage(cs, xs, wid, wrow, 0, kn, kn, one_f && cb > 0 ? 0 : nr, sides, seg0, centers,
            F, f0, fn, vw);
      int f = 0;
#pragma unroll 1
      for (; f + 4 <= fn; f += 4) {
        float4 x[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          x[i] = *reinterpret_cast<const float4*>(xs + (rg + 8 * i) * kStride + f);
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const float4 c4 = *reinterpret_cast<const float4*>(cs + (cq + 4 * t) * kStride + f);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][t] = fmaf(x[i].x, c4.x, acc[i][t]);
            acc[i][t] = fmaf(x[i].y, c4.y, acc[i][t]);
            acc[i][t] = fmaf(x[i].z, c4.z, acc[i][t]);
            acc[i][t] = fmaf(x[i].w, c4.w, acc[i][t]);
          }
        }
      }
#pragma unroll 1
      for (; f < fn; ++f) {
        float x[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) x[i] = xs[(rg + 8 * i) * kStride + f];
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const float cv = cs[(cq + 4 * t) * kStride + f];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][t] = fmaf(x[i], cv, acc[i][t]);
        }
      }
    }
    wc2[lane] = c2l;
    __syncwarp();
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int j = cq + 4 * t;
      if (j < kn) {
        const int id = wid[j];
        const float c2v = wc2[j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float s = __fsub_rn(c2v, __fmul_rn(2.0f, acc[i][t]));
          if (better(s, id, best[i], best_k[i])) {
            best[i] = s;
            best_k[i] = id;
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      const float s = __shfl_xor_sync(kFull, best[i], off);
      const int k = __shfl_xor_sync(kFull, best_k[i], off);
      if (k >= 0 && better(s, k, best[i], best_k[i])) {
        best[i] = s;
        best_k[i] = k;
      }
    }
    const int row = rg + 8 * i;
    if (cq == 0 && row < nr) sid[wrow[row]] = best_k[i] < 0 ? 0 : best_k[i];
  }
}

// Scores the nr (<= 32) rows at sorted positions q.. of group c0 against
// its centers cperm[c0 ..] (the entries of the sorted ckey equal to
// ckey[c0]); writes each row's id into sid. One warp; cs, xs, wid, wc2
// and wrow are its own. More than 16 rows go to score_long. Otherwise,
// with R the least power of two >= max(nr, 4), lane l scores row l / CG
// (CG = 32 / R) against the chunk's centers l % CG, l % CG + CG, ..., NT
// of them a pass (NT = 16 for CG = 2, else 4), and the CG lanes of a row
// combine their minima.
__device__ void score_task(const Sides& sides, int seg0, const unsigned long long* keys,
                           int q, int nr, int c0, const long long* __restrict__ ckey,
                           int K, const int32_t* __restrict__ cperm,
                           const float* __restrict__ centers,
                           const float* __restrict__ c2, int F, int vw, float* cs,
                           float* xs, int* wid, float* wc2, int* wrow, int* sid) {
  const int lane = threadIdx.x % 32;
  // The group's size and first 32 ids in one round of loads, then 32
  // keys at a time while every lane still sees the group's bin
  const long long kv = c0 + lane < K ? ckey[c0 + lane] : INT64_MIN;  // no bin's key
  const int first_ids = c0 + lane < K ? cperm[c0 + lane] : -1;
  const long long bin = __shfl_sync(kFull, kv, 0);
  unsigned same = __ballot_sync(kFull, kv == bin);  // a prefix of the lanes
  int nc = __popc(same);
  for (int c = c0 + 32; same == kFull; c += 32) {
    same = __ballot_sync(kFull, c + lane < K && ckey[c + lane] == bin);
    nc += __popc(same);
  }
  __syncwarp();  // the previous task has read wrow
  wrow[lane] = lane < nr ? int(keys[q + lane] & 0xffffu) : 0;
  if (nr > 16) {
    score_long(sides, seg0, nr, c0, nc, first_ids, cperm, centers, c2, F, vw, cs, xs, wid,
               wc2, wrow, sid);
    return;
  }
  const int lr = nr <= 4 ? 2 : 32 - __clz(nr - 1);  // log2 R
  const int CG = 32 >> lr, NT = CG <= 2 ? 16 : 4, CC = CG * NT;  // CC divides 32
  const int r = lane >> (5 - lr), cg = lane & (CG - 1);
  // Up to 32 features: the rows once, and each chunk's centers once
  const bool one_f = F <= kChunk;
  const float* xr = xs + r * kStride;
  float best = INFINITY;
  int best_k = -1;
  for (int cb = 0; cb < nc; cb += kCenters) {
    const int kn = min(kCenters, nc - cb);
    // Center cb + lane of the chunk: its id and c2 for every lane
    const int cid = lane >= kn ? -1 : cb == 0 ? first_ids : cperm[c0 + cb + lane];
    const float c2l = cid >= 0 ? c2[cid] : 0.f;  // read by the scores only
    __syncwarp();  // the previous chunk's scores have read wid and wc2
    wid[lane] = cid;
    for (int pb = 0; pb < kn; pb += CC) {
      float acc[kMaxNT];
#pragma unroll
      for (int t = 0; t < kMaxNT; ++t) acc[t] = 0.f;
      for (int f0 = 0; f0 < F; f0 += kChunk) {
        const int fn = min(kChunk, F - f0);
        if (!one_f)
          stage(cs, xs, wid, wrow, pb, min(CC, kn - pb), kn, nr, sides, seg0, centers, F,
                f0, fn, vw);
        else if (pb == 0)
          stage(cs, xs, wid, wrow, 0, kn, kn, cb == 0 ? nr : 0, sides, seg0, centers, F,
                f0, fn, vw);
        // This lane's centers of the pass: chunk entries pb + cg + CG t
        const float* cr = cs + (pb + cg) * kStride;
        if (NT == 16) dot_pass<16>(xr, cr, CG * kStride, fn, acc);
        else dot_pass<4>(xr, cr, CG * kStride, fn, acc);
      }
      if (pb == 0) {
        wc2[lane] = c2l;
        __syncwarp();
      }
#pragma unroll
      for (int t = 0; t < kMaxNT; ++t) {
        const int j = pb + cg + CG * t;
        if (t < NT && j < kn) {
          const int id = wid[j];
          const float s = __fsub_rn(wc2[j], __fmul_rn(2.0f, acc[t]));
          if (better(s, id, best, best_k)) {
            best = s;
            best_k = id;
          }
        }
      }
    }
  }
  // The CG lanes of a row combine their minima
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    const float s = __shfl_xor_sync(kFull, best, off);
    const int k = __shfl_xor_sync(kFull, best_k, off);
    if (off < CG && k >= 0 && better(s, k, best, best_k)) {
      best = s;
      best_k = k;
    }
  }
  if (cg == 0 && r < nr) sid[wrow[r]] = best_k < 0 ? 0 : best_k;
}

template <typename WT>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
assign_flux_kernel(Sides sides, const WT* __restrict__ w, WT* fm,
                   const int32_t* __restrict__ rkey,
                   const int32_t* __restrict__ cperm,
                   const long long* __restrict__ ckey,
                   const float* __restrict__ centers,
                   const float* __restrict__ c2, int n, int F, int K,
                   int n_states) {
  extern __shared__ __align__(16) unsigned char smem[];
  // (group << 16) | row: row r < kSegs is segment seg0 + r's parent row,
  // the others its child rows; group K: no center, K + 1: past the end
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);
  int* sid = reinterpret_cast<int*>(keys + kRows);  // each row's id
  float* wsm = reinterpret_cast<float*>(sid + kRows);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int seg0 = blockIdx.x * kSegs;
  for (int r = tid; r < kRows; r += kThreads) {
    const int side = r >= kSegs;
    const int seg = seg0 + r - side * kSegs;
    const long long g = seg < n ? rkey[side * n + seg] : K + 1;
    keys[r] = (static_cast<unsigned long long>(g) << 16) | unsigned(r);
  }
  __syncthreads();
  for (int k = 2; k <= kRows; k <<= 1) {
    for (int j = k >> 1, lj = __ffs(j) - 1; j > 0; j >>= 1, --lj) {
      for (int t = tid; t < kRows / 2; t += kThreads) {
        const int i = ((t >> lj) << (lj + 1)) | (t & (j - 1));  // bit j clear
        const unsigned long long a = keys[i], b = keys[i + j];
        if ((a > b) == ((i & k) == 0)) {
          keys[i] = b;
          keys[i + j] = a;
        }
      }
      __syncthreads();
    }
  }

  // Features a copy: the widest that F and the bases' alignment allow
  const uintptr_t bases = reinterpret_cast<uintptr_t>(centers) |
                          reinterpret_cast<uintptr_t>(sides.x[0]) |
                          reinterpret_cast<uintptr_t>(sides.x[1]);
  const int vw = F % 4 == 0 && bases % 16 == 0 ? 4 : F % 2 == 0 && bases % 8 == 0 ? 2 : 1;
  float* cs = wsm + warp * kWarpFloats;
  float* xs = cs + kCenters * kStride;
  int* wid = reinterpret_cast<int*>(xs + kTaskRows * kStride);
  float* wc2 = reinterpret_cast<float*>(wid + 32);
  int* wrow = wid + 64;
  // The tasks of the warp: those that start in its 32-row stretches p0 =
  // (warp + kWarps h) * 32 of the sorted rows; a task starts every
  // kTaskRows rows of a run. Rows of group K get id 0 here.
  for (int p0 = warp * 32; p0 < kRows; p0 += kThreads) {
    const int p = p0 + lane;
    const unsigned long long key = keys[p];
    const int g = int(key >> 16);
    bool start = false;
    if (g == K) {
      sid[key & 0xffffu] = 0;
    } else if (g < K) {
      const int first = search<false>(keys, kRows, static_cast<unsigned long long>(g) << 16);
      start = (p - first) % kTaskRows == 0;
    }
    for (unsigned m = __ballot_sync(kFull, start); m != 0; m &= m - 1) {
      const int q = p0 + __ffs(m) - 1;
      const int gq = int(keys[q] >> 16);
      const int end = search<false>(keys, kRows, static_cast<unsigned long long>(gq + 1) << 16);
      score_task(sides, seg0, keys, q, min(kTaskRows, end - q), gq, ckey, K, cperm, centers,
                 c2, F, vw, cs, xs, wid, wc2, wrow, sid);
    }
  }
  __syncthreads();

  const int basis_id = n_states - 2, target_id = n_states - 1;
  for (int t = tid; t < kSegs && seg0 + t < n; t += kThreads) {
    const int row = seg0 + t;
    int p = sid[t], c = sid[kSegs + t];
    // end-in-target, start-in-target, then basis: basis wins
    if (flag(sides.target[1], row)) c = target_id;
    if (flag(sides.target[0], row)) p = target_id;
    if (flag(sides.basis[0], row)) p = basis_id;
    if (flag(sides.basis[1], row)) c = basis_id;
    sides.idx[0][row] = p;
    sides.idx[1][row] = c;
    const WT wv = w[row];
    if (wv != WT(0) && p >= 0 && p < n_states && c >= 0 && c < n_states)
      atomicAdd(fm + size_t(p) * n_states + c, wv);
  }
}

template <typename WT>
cudaError_t launch(const Sides& sides, const void* w, void* fm,
                   const int32_t* rkey, const int32_t* cperm,
                   const long long* ckey, const float* centers,
                   const float* c2, int n, int F, int K, int n_states,
                   cudaStream_t st) {
  auto kernel = assign_flux_kernel<WT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kSmemBytes));
  if (err != cudaSuccess) return err;
  const long long blocks = (static_cast<long long>(n) + kSegs - 1) / kSegs;
  kernel<<<unsigned(blocks), kThreads, kSmemBytes, st>>>(
      sides, static_cast<const WT*>(w), static_cast<WT*>(fm), rkey, cperm,
      ckey, centers, c2, n, F, K, n_states);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// H3: parent and child feature rows (n, F), flux-order overrides (target_p
// may be null) and the (S, S) flux of w (f32, or f64 when w_is_f64) into
// fm, which the caller zeroes. rkey (2n), cperm and ckey (K) are the plan
// of msm_pair_plan_keys.
int msm_assign_flux(const float* fp, const float* fc, const uint8_t* basis_p,
                    const uint8_t* basis_c, const uint8_t* target_p,
                    const uint8_t* target_c, const void* w, int w_is_f64,
                    const int32_t* rkey, const int32_t* cperm,
                    const long long* ckey, const float* centers,
                    const float* c2, int n, int F, int K, int n_states,
                    int32_t* pidx, int32_t* cidx, void* fm, void* stream) {
  if (n <= 0 || F <= 0 || K <= 0) return int(cudaErrorInvalidValue);
  Sides sides;
  sides.x[0] = fp;
  sides.x[1] = fc;
  sides.basis[0] = basis_p;
  sides.basis[1] = basis_c;
  sides.target[0] = target_p;
  sides.target[1] = target_c;
  sides.idx[0] = pidx;
  sides.idx[1] = cidx;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      w_is_f64 ? launch<double>(sides, w, fm, rkey, cperm, ckey, centers, c2, n, F, K, n_states, st)
               : launch<float>(sides, w, fm, rkey, cperm, ckey, centers, c2, n, F, K, n_states, st);
  return int(err);
}

}  // extern "C"
