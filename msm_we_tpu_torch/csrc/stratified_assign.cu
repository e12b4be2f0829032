// Stratified nearest-center assignment for Hopper (sm_90a): the hand-written
// CUDA family that replaces three of the four Pallas TPU kernels of
// msm_we_tpu/ops/pallas_kernels.py.
//
//   msm_transform_assign_child  <- _transform_assign_child_kernel (H1)
//   msm_transform_assign        <- _transform_assign_kernel       (H2)
//   msm_assign_flux             <- _kernel                        (H3)
//
// H4 (_assign_kernel, msm_pair_assign) has its own bin-grouped kernel in
// pair_assign.cu, which scores bitwise as this family does.
//
// One templated kernel serves all three. Per row (a WE segment's parent or
// child frame): optionally project raw coordinates to features (g = x P),
// score every valid center of the row's WE bin as |c|^2 - 2 g.c (the
// production score of ops/kmeans.py::masked_scores; the transform entry
// points fold the PCA centering into c2adj = |c|^2 + 2 (mu P).c), keep the
// first minimum, apply the basis/target overrides in flux order (basis
// wins) or predict order (target wins), and optionally scatter the
// segment weight into the (S, S) flux matrix.
//
// Design, and what bounds each entry point on an H100:
//  * One thread owns one row; a block owns kThreads rows. The row's
//    features live in registers, padded with zeros to FP (32/64/128) so
//    every loop is unrolled; zero pads add exact zeros to every dot.
//  * H1/H2 are bound by the raw-coordinate reads (102,400 x 900 f32 per
//    row set, 737 MB for both sets of a hot step). Each thread streams its
//    own raw row with 16-byte loads, four in flight per step; a warp's 32
//    rows share the 128-byte lines across consecutive loads, so L1 serves
//    all but the first touch and each byte comes from device memory once.
//    Only P is staged, in 16 KB passes, broadcast from shared memory as
//    float4 so one shared load feeds four FFMAs. The small shared footprint
//    (16 KB P pass, 16 KB bank tile) leaves L1 room for the rows in flight
//    and lets registers, not shared memory, bound residency.
//  * H3 is bound by the N x K x F multiply-adds. The center bank
//    streams through shared memory in tiles of KT centers (32 KB), so any
//    K fits (3,200 centers x 30 features is 375 KB, more than one block's
//    shared memory). Each row keeps a running (min, id) across tiles.
//    Centers outside the row's bin are skipped, so a warp whose rows share
//    a bin does F FMAs per same-bin center only.
//  * The flux epilogue is one atomicAdd per row into the (S, S) matrix,
//    f64 natively on sm_90 (or f32, following the dtype of w). Rows with
//    zero weight skip the atomic. Contention is bounded by S^2 cells; the
//    summation order is unspecified, so only dyadic weights compare bitwise.
//  * Dot products are sequential FFMA chains in exact f32: no TF32, no
//    tensor cores. Ties go to the lower center index: k is scanned upward
//    and a candidate replaces the running minimum only on strict <.
//  * A row whose bin matches no valid center keeps id 0 (the Pallas
//    min-of-iota convention); such rows carry weight 0 by contract.
//
// Plain C interface for ctypes. Every entry point launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() so that a refused launch is reported.

#include <cuda_runtime.h>
#include <stdint.h>
#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 128;           // rows per block, one per thread
constexpr int kProjTileBytes = 16384;   // P rows staged per transform pass
// Center tile in shared memory: features in (H3), or after a transform
// (H1/H2), where a smaller tile keeps L1 free for the raw rows
constexpr int kBankTileBytes = 32768;
constexpr int kTransformBankTileBytes = 16384;

enum Overrides { kNone = 0, kFluxOrder = 1, kPredictOrder = 2 };

struct RowSet {
  const float* x;          // (n, F) features, or (n, D) raw when transforming
  const int32_t* bin;      // (n,) remapped WE bin; -1 matches no center
  const uint8_t* basis;    // (n,) or null
  const uint8_t* target;   // (n,) or null
  int32_t* idx;            // (n,) output ids
  float* feats;            // (n, F) emitted features (raw x P), or null
};

struct Bank {
  const float* centers;    // (K, F) compact bank: row index == global id
  const float* c2;         // (K,) |c|^2, or c2adj for the transform entries
  const int32_t* cbin;     // (K,) owning WE bin
  const uint8_t* valid;    // (K,)
  int K;
};

template <int FP, bool TRANSFORM>
__host__ __device__ constexpr int bank_tile() {
  return (TRANSFORM ? kTransformBankTileBytes : kBankTileBytes) / (4 * FP);
}

template <int FP>
__host__ __device__ constexpr int proj_tile() { return kProjTileBytes / (4 * FP); }

template <int FP, bool TRANSFORM>
constexpr size_t bank_smem() {
  return size_t(bank_tile<FP, TRANSFORM>()) * (FP * sizeof(float) + sizeof(float) + sizeof(int));
}

// g += x * P[d, :] for one raw value x and one staged P row.
template <int FP>
__device__ __forceinline__ void fma_row(float (&g)[FP], float x,
                                        const float* prow) {
  const float4* p4 = reinterpret_cast<const float4*>(prow);
#pragma unroll
  for (int q = 0; q < FP / 4; ++q) {
    const float4 pv = p4[q];
    g[4 * q + 0] = fmaf(x, pv.x, g[4 * q + 0]);
    g[4 * q + 1] = fmaf(x, pv.y, g[4 * q + 1]);
    g[4 * q + 2] = fmaf(x, pv.z, g[4 * q + 2]);
    g[4 * q + 3] = fmaf(x, pv.w, g[4 * q + 3]);
  }
}

template <int FP>
__device__ __forceinline__ void fma4(float (&g)[FP], float4 x,
                                     const float* prow) {
  fma_row<FP>(g, x.x, prow);
  fma_row<FP>(g, x.y, prow + FP);
  fma_row<FP>(g, x.z, prow + 2 * FP);
  fma_row<FP>(g, x.w, prow + 3 * FP);
}

// g = x P for this thread's raw row (zeros past n; columns past F are
// zero). d runs upward in one FMA chain per feature, so the result does not
// depend on the tiling. Every thread of the block must call this (it
// synchronises).
template <int FP>
__device__ void transform_rows(const float* __restrict__ raw,
                               const float* __restrict__ proj, int n, int D,
                               int F, int row, float (&g)[FP], float* smem) {
  constexpr int PT = proj_tile<FP>();
#pragma unroll
  for (int f = 0; f < FP; ++f) g[f] = 0.f;
  const bool live = row < n;
  const float* xr = raw + size_t(live ? row : 0) * D;
  // 16-byte loads need 16-byte aligned rows
  const bool vec = D % 4 == 0 && (reinterpret_cast<uintptr_t>(raw) & 15) == 0;
  for (int d0 = 0; d0 < D; d0 += PT) {
    const int dn = min(PT, D - d0);
    __syncthreads();  // the previous pass (or bank tile) is fully consumed
    for (int e = threadIdx.x; e < PT * FP; e += blockDim.x) {
      const int r = e / FP, c = e % FP;
      smem[e] = (r < dn && c < F) ? proj[size_t(d0 + r) * F + c] : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    if (vec) {  // dn is a multiple of 4 here (D and PT are)
      const float4* x4 = reinterpret_cast<const float4*>(xr + d0);
      int d = 0;
      for (; d + 16 <= dn; d += 16) {
        const float4 a = __ldg(x4 + d / 4), b = __ldg(x4 + d / 4 + 1);
        const float4 c = __ldg(x4 + d / 4 + 2), e = __ldg(x4 + d / 4 + 3);
        fma4<FP>(g, a, smem + d * FP);
        fma4<FP>(g, b, smem + (d + 4) * FP);
        fma4<FP>(g, c, smem + (d + 8) * FP);
        fma4<FP>(g, e, smem + (d + 12) * FP);
      }
      for (; d < dn; d += 4) fma4<FP>(g, __ldg(x4 + d / 4), smem + d * FP);
    } else {
      for (int d = 0; d < dn; ++d) fma_row<FP>(g, __ldg(xr + d0 + d), smem + d * FP);
    }
  }
}

template <int FP>
__device__ void load_row(const float* __restrict__ x, int n, int F, int row,
                         float (&g)[FP]) {
#pragma unroll
  for (int f = 0; f < FP; ++f)
    g[f] = (row < n && f < F) ? x[size_t(row) * F + f] : 0.f;
}

// First minimum of |c|^2 - 2 g.c over the valid centers of `bin`, with the
// bank streamed through shared memory in tiles. Every thread of the block
// must call this (it synchronises).
template <int FP, bool TRANSFORM>
__device__ int nearest_center(const float (&g)[FP], int bin, const Bank bank,
                              int F, float* smem) {
  constexpr int KT = bank_tile<FP, TRANSFORM>();
  float* cs = smem;                                   // KT x FP
  float* c2s = cs + KT * FP;                          // KT
  int* cbs = reinterpret_cast<int*>(c2s + KT);        // KT
  float best = INFINITY;
  int best_k = 0;
  for (int k0 = 0; k0 < bank.K; k0 += KT) {
    const int kt = min(KT, bank.K - k0);
    __syncthreads();  // previous tile (or transform slab) fully consumed
    for (int e = threadIdx.x; e < KT * FP; e += blockDim.x) {
      const int k = e / FP, f = e % FP;
      cs[e] = (k < kt && f < F) ? bank.centers[size_t(k0 + k) * F + f] : 0.f;
    }
    for (int k = threadIdx.x; k < KT; k += blockDim.x) {
      const bool ok = k < kt && bank.valid[k0 + k] != 0;
      c2s[k] = ok ? bank.c2[k0 + k] : 0.f;
      // Invalid or past-the-end centers carry a bin no row can hold
      cbs[k] = ok ? bank.cbin[k0 + k] : INT_MIN;
    }
    __syncthreads();
    for (int k = 0; k < kt; ++k) {
      if (cbs[k] != bin) continue;
      const float4* c4 = reinterpret_cast<const float4*>(cs + k * FP);
      float dot = 0.f;
#pragma unroll
      for (int q = 0; q < FP / 4; ++q) {
        const float4 cv = c4[q];
        dot = fmaf(g[4 * q + 0], cv.x, dot);
        dot = fmaf(g[4 * q + 1], cv.y, dot);
        dot = fmaf(g[4 * q + 2], cv.z, dot);
        dot = fmaf(g[4 * q + 3], cv.w, dot);
      }
      const float s = __fsub_rn(c2s[k], __fmul_rn(2.0f, dot));
      if (s < best) {
        best = s;
        best_k = k0 + k;
      }
    }
  }
  return best_k;
}

__device__ __forceinline__ bool flag(const uint8_t* m, int row) {
  return m != nullptr && m[row] != 0;
}

template <typename WT>
__device__ __forceinline__ void flux_add(WT* fm, size_t cell, WT w) {
  atomicAdd(fm + cell, w);
}

// parent.x == null: one row set (the `child` slot), no parent, no flux.
template <int FP, bool TRANSFORM, typename WT>
__global__ void __launch_bounds__(kThreads)
stratified_assign_kernel(RowSet parent, RowSet child, const float* proj,
                         Bank bank, const WT* w, WT* fm, int n, int D, int F,
                         int n_states, int overrides) {
  extern __shared__ __align__(16) float smem[];
  const int row0 = blockIdx.x * kThreads;
  const int row = row0 + threadIdx.x;
  const bool live = row < n;
  const bool pair = parent.x != nullptr;

  int ids[2] = {0, 0};
  for (int s = pair ? 0 : 1; s < 2; ++s) {
    const float* x = s == 0 ? parent.x : child.x;
    float* feats = s == 0 ? parent.feats : child.feats;
    float g[FP];
    if (TRANSFORM) {
      transform_rows<FP>(x, proj, n, D, F, row, g, smem);
      if (feats != nullptr && live) {
#pragma unroll
        for (int f = 0; f < FP; ++f)
          if (f < F) feats[size_t(row) * F + f] = g[f];
      }
    } else {
      load_row<FP>(x, n, F, row, g);
    }
    const int bin = live ? (s == 0 ? parent.bin : child.bin)[row] : INT_MIN + 1;
    ids[s] = nearest_center<FP, TRANSFORM>(g, bin, bank, F, smem);
  }
  if (!live) return;

  int p = ids[0], c = ids[1];
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
      flux_add<WT>(fm, size_t(p) * n_states + c, wv);
  }
}

template <int FP, bool TRANSFORM, typename WT>
cudaError_t launch_fp(const RowSet& parent, const RowSet& child,
                      const float* proj, const Bank& bank, const WT* w, WT* fm,
                      int n, int D, int F, int n_states, int overrides,
                      cudaStream_t stream) {
  constexpr size_t proj_bytes = TRANSFORM ? size_t(kProjTileBytes) : 0;
  constexpr size_t smem = proj_bytes > bank_smem<FP, TRANSFORM>()
                              ? proj_bytes : bank_smem<FP, TRANSFORM>();
  const int blocks = (n + kThreads - 1) / kThreads;
  stratified_assign_kernel<FP, TRANSFORM, WT>
      <<<blocks, kThreads, smem, stream>>>(parent, child, proj, bank, w, fm, n,
                                           D, F, n_states, overrides);
  return cudaGetLastError();
}

template <bool TRANSFORM, typename WT>
int launch(const RowSet& parent, const RowSet& child, const float* proj,
           const Bank& bank, const WT* w, WT* fm, int n, int D, int F,
           int n_states, int overrides, void* stream) {
  if (n <= 0 || bank.K <= 0 || F <= 0) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (F <= 32)
    err = launch_fp<32, TRANSFORM, WT>(parent, child, proj, bank, w, fm, n, D,
                                       F, n_states, overrides, st);
  else if (F <= 64)
    err = launch_fp<64, TRANSFORM, WT>(parent, child, proj, bank, w, fm, n, D,
                                       F, n_states, overrides, st);
  else if (F <= 128)
    err = launch_fp<128, TRANSFORM, WT>(parent, child, proj, bank, w, fm, n, D,
                                        F, n_states, overrides, st);
  else
    err = cudaErrorInvalidValue;
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
// non-null.
int msm_transform_assign_child(const float* raw, const int32_t* bins,
                               const uint8_t* basis, const uint8_t* target,
                               const float* proj, const float* centers,
                               const float* c2adj, const int32_t* cbin,
                               const uint8_t* valid, int n, int D, int F,
                               int K, int n_states, int32_t* idx, float* feats,
                               void* stream) {
  const RowSet none = make_rows(nullptr, nullptr, nullptr, nullptr, nullptr,
                                nullptr);
  const RowSet child = make_rows(raw, bins, basis, target, idx, feats);
  return launch<true, float>(none, child, proj,
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
    return launch<true, double>(parent, child, proj, bank,
                                static_cast<const double*>(w),
                                static_cast<double*>(fm), n, D, F, n_states,
                                kFluxOrder, stream);
  return launch<true, float>(parent, child, proj, bank,
                             static_cast<const float*>(w),
                             static_cast<float*>(fm), n, D, F, n_states,
                             kFluxOrder, stream);
}

// H3: features in; parent and child assignment, flux-order overrides
// (target_p may be null) and the (S, S) flux of w (f32 or f64).
int msm_assign_flux(const float* fp, const float* fc, const int32_t* pbins,
                    const int32_t* cbins, const uint8_t* basis_p,
                    const uint8_t* basis_c, const uint8_t* target_p,
                    const uint8_t* target_c, const void* w, int w_is_f64,
                    const float* centers, const float* c2,
                    const int32_t* cbin, const uint8_t* valid, int n, int F,
                    int K, int n_states, int32_t* pidx, int32_t* cidx,
                    void* fm, void* stream) {
  const RowSet parent = make_rows(fp, pbins, basis_p, target_p, pidx, nullptr);
  const RowSet child = make_rows(fc, cbins, basis_c, target_c, cidx, nullptr);
  const Bank bank = make_bank(centers, c2, cbin, valid, K);
  if (w_is_f64)
    return launch<false, double>(parent, child, nullptr, bank,
                                 static_cast<const double*>(w),
                                 static_cast<double*>(fm), n, 0, F, n_states,
                                 kFluxOrder, stream);
  return launch<false, float>(parent, child, nullptr, bank,
                              static_cast<const float*>(w),
                              static_cast<float*>(fm), n, 0, F, n_states,
                              kFluxOrder, stream);
}

}  // extern "C"
