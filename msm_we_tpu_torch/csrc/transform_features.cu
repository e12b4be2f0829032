// The features-only transform g = x P of one or two raw row sets, for
// Hopper (sm_90a): the hot step's transform when no scoring follows in the
// same kernel (the two_transform step's bin-grouped route and the dedup
// tier, entry.py).
//
//   msm_transform_features  <- no Pallas kernel of its own: the transform
//                              half of _transform_assign_child_kernel :473
//                              (H1, msm_we_tpu/ops/pallas_kernels.py)
//
// H1 (stratified_assign.cu) keeps its tile for scoring: the g tile and the
// bank in shared memory, rows and P staged by cp.async a 32-column chunk at
// a time behind a __syncthreads. A transform that only streams wants the
// opposite, so it is a kernel of its own; the two share only the order of
// the arithmetic.
//
// What bounds it on an H100 (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores), at 102,400 rows a set, raw 900 -> 30 features: bytes. A set's raw
// rows are 369 MB, 0.110 ms (both sets 0.220 ms); its 2 N D F = 5.5 GFLOP
// take 0.083 ms, close behind. Two more limits shape the design: shared
// memory returns 32 words a clock to an SM's 128 FMA lanes, so a lane must
// do at least 4 FMAs a word it loads; and each TMA instruction costs the
// producer, so a stage must come in a few large boxes.
//
// Design.
//  * Persistent: about one block an SM over both sets in one launch. The
//    rows are cut into units of 16 rows of one set; each block takes an
//    even, contiguous share of the units of both sets, so there is no
//    second launch and no wave tail.
//  * Rounds: the block walks its share in rounds of at most 26 contiguous
//    units, the units spread evenly over the rounds and a round's units
//    evenly over the 4 consumer warps (one an SM sub-partition, at most 7
//    units each). A round is read in stages of 32 raw columns.
//  * A producer warp feeds a ring of 4 stages (52 KB of rows and 4 KB of P
//    each), guarded by full and empty mbarriers. One thread issues, a
//    stage, TMA boxes of 256, 128, ... 16 rows x 128 bytes covering the
//    round's units (a tensor map a set and box height; the ragged D and N
//    edges read as zeros; the 128-byte swizzle keeps the consumers' column
//    reads free of bank conflicts) and one bulk copy of the stage's
//    columns of P, packed before the launch by pack_proj_kernel as float4s
//    of 4 consecutive d (zero padded). Rows TMA cannot address (D % 4 !=
//    0, or a base off 16 bytes) are staged by the producer warp's 32 lanes
//    with 4-byte cp.async into the same layout.
//  * Consumer warps never synchronise with each other inside the D loop
//    and issue no copies: a warp waits on a stage's full barrier,
//    multiplies, and releases it with one arrive. Lane (fg, rg) holds rows
//    rg, 16 + rg, ... of the warp's TM <= 7 units x TN features f = 2j +
//    fg: per 4 columns, TM + TN float4 reads from shared memory feed
//    4 TM TN FMAs (F = 30 tiles exactly as 2 x 15).
//  * Exact f32: plain fmaf, no TF32, no tensor cores, no split of the d
//    sum. Each g[row, f] is one fmaf chain from 0.f over d ascending, as
//    in H1, so g is bitwise H1's (zero pads add exact zeros: the chain
//    starts at +0 and cannot reach -0).
//
// Plain C interface for ctypes. The entry point launches its two kernels
// on the given stream, does not synchronise, allocates nothing (the caller
// passes the packed P's buffer), and returns the first CUDA error of the
// launches, so a refused launch is reported.

#include <cuda.h>  // CUtensorMap and its enums (libcuda's types only)
#include <cuda_runtime.h>
#include <stdint.h>
#include <cstring>

#include "assign_common.cuh"

namespace {

constexpr int kConsumers = 4;                     // consumer warps, one a sub-partition
constexpr int kThreads = 32 * (kConsumers + 1);   // and the producer warp
constexpr int kUnitRows = 16;                     // rows of a unit
constexpr int kWarpUnits = 7;                     // units a consumer warp holds
constexpr int kDepth = 32;                        // raw columns a stage
constexpr int kRowBytes = kDepth * 4;             // 128 bytes: the swizzle's width
constexpr int kUnitBytes = kUnitRows * kRowBytes;  // 2 KB, two swizzle atoms
// Units a round at most: 26 leaves room for a ring of 4 stages; rounds
// of 32 units with 3 stages measured ~6% slower on the H100
constexpr int kRoundUnits = 26;
static_assert(kRoundUnits <= kConsumers * kWarpUnits, "a warp holds its share");
constexpr int kRowsBytes = kRoundUnits * kUnitBytes;
constexpr int kMaxTN = 16;
constexpr int kProjBytes = kDepth * 2 * kMaxTN * 4;  // 4 KB
constexpr int kStageBytes = kRowsBytes + kProjBytes;
constexpr int kStages = 4;
constexpr int kAlign = 1024;
constexpr int kBoxes = 5;  // box heights: 16, 32, 64, 128, 256 rows
static_assert(kStageBytes % kAlign == 0, "stages keep the swizzle atoms aligned");

struct Params {
  const float* x[2];  // (n[s], D) raw rows of set 0 and set 1
  float* g[2];        // (n[s], F) features out
  int n[2];
  int units0;         // units of set 0, ceil(n[0] / 16)
  int units;          // units of both sets
  const float* proj;  // (D, F)
  const float* pq;    // P packed by pack_proj_kernel
  int D, F;
  int nk;             // stages a round: ceil(D / 32)
  int tma;            // 1: TMA boxes; 0: the producer warp's cp.async
};

// The tensor maps of a launch: each set's rows in boxes of 16 << b rows,
// one row's kDepth columns wide
struct Maps {
  CUtensorMap box[kBoxes][2];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of `bar` with this parity has completed. A wait of
// more than ~2^35 cycles (~17 s) traps: a launch error, not a hung card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > (1ll << 35)) __trap();
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// The box at (column c0, row c1) of `map` into shared memory at dst; its
// bytes complete `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// Set and first row of unit u
__device__ __forceinline__ int unit_set(const Params& p, int u, int& row0) {
  const int s = u >= p.units0;
  row0 = (u - s * p.units0) * kUnitRows;
  return s;
}

// The block's share [ub, ue) of both sets' units is walked in rounds of at
// most kRoundUnits contiguous units, spread evenly over the rounds; a
// round's units are split evenly over the warps, so that every SM
// sub-partition gets as many rows
struct Share {
  int ub, ue;
  __device__ int rounds() const { return (ue - ub + kRoundUnits - 1) / kRoundUnits; }
  // Units [first, first + n) of round r of `rounds`; returns n
  __device__ int round(int r, int rounds, int& first) const {
    const int n = ue - ub;
    first = ub + n * r / rounds;
    return ub + n * (r + 1) / rounds - first;
  }
};

// Warp w's units of a round of n: [off, off + returned count)
__device__ __forceinline__ int warp_units(int n, int w, int& off) {
  off = n * w / kConsumers;
  return n * (w + 1) / kConsumers - off;
}

// `bytes` contiguous bytes from global memory into shared memory at dst
// (both 16-byte aligned); they complete `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// P (D, F) packed for the stages: pq[(dq * 2 TN + f) * 4 + q] holds P[4 dq
// + q, f], zero past D and F, so that a stage's columns are one
// contiguous block of float4s of 4 consecutive d
template <int TN>
__global__ void pack_proj_kernel(const float* __restrict__ proj, int D, int F,
                                 float* __restrict__ pq, int total) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int q = e & 3, f = (e >> 2) % (2 * TN), dq = (e >> 2) / (2 * TN);
  const int d = 4 * dq + q;
  pq[e] = d < D && f < F ? proj[size_t(d) * F + f] : 0.f;
}

// Rows [row0, row0 + 16 m) of set s into dst by boxes of 256, 128, 64,
// 32 and 16 rows
__device__ __forceinline__ void load_run(const Maps* maps, uint32_t dst, int s,
                                         int row0, int m, uint32_t bar, int d0) {
#pragma unroll
  for (int b = kBoxes - 1; b >= 0; --b) {
    while (m >= (1 << b)) {
      tma_load(dst, &maps->box[b][s], bar, d0, row0);
      dst += kUnitBytes << b;
      row0 += kUnitRows << b;
      m -= 1 << b;
    }
  }
}

// The producer warp: for each round and stage, P's columns (one bulk
// copy) and the round's rows (TMA boxes), all issued by lane 0 and
// completing the stage's full barrier; rows TMA cannot address are staged
// by the warp's cp.async, and the warp arrives once they have landed
template <int TN>
__device__ void produce(const Maps* maps, const Params& p, unsigned char* ring,
                        uint32_t full, uint32_t empty, const Share& sh) {
  const int lane = threadIdx.x % 32;
  if (p.tma && lane != 0) return;
  constexpr uint32_t kProj = kDepth * 2 * TN * 4;  // P's bytes a stage
  int stage = 0;
  uint32_t phase = 0;
  uint32_t pending = 0;  // the full barrier still owed the warp's arrive
  const int rounds = sh.rounds();
  for (int r = 0; r < rounds; ++r) {
    int first;
    const int n = sh.round(r, rounds, first);
    for (int k = 0; k < p.nk; ++k) {
      mbar_wait(empty + 8 * stage, phase ^ 1);  // a fresh barrier passes
      unsigned char* dst = ring + stage * kStageBytes;
      const uint32_t bar = full + 8 * stage;
      const int d0 = k * kDepth;
      if (lane == 0) {
        mbar_arrive_expect_tx(bar, kProj + (p.tma ? n * kUnitBytes : 0));
        bulk_load(smem_u32(dst + kRowsBytes), p.pq + size_t(k) * kDepth * 2 * TN, kProj,
                  bar);
        if (p.tma) {  // the round's units of set 0, then those of set 1
          int row0;
          const int s = unit_set(p, first, row0);
          const int m0 = s == 0 ? min(n, p.units0 - first) : n;
          load_run(maps, smem_u32(dst), s, row0, m0, bar, d0);
          if (m0 < n) load_run(maps, smem_u32(dst + m0 * kUnitBytes), 1, 0, n - m0, bar, d0);
        }
      }
      if (!p.tma) {  // a lane a column, into the layout a swizzled box has
        const int d = d0 + lane;
        for (int i = 0; i < n; ++i) {
          int row0;
          const int s = unit_set(p, first + i, row0);
          const float* x = s ? p.x[1] : p.x[0];
          const int rows = s ? p.n[1] : p.n[0];
          float* unit = reinterpret_cast<float*>(dst + i * kUnitBytes);
#pragma unroll 4
          for (int rr = 0; rr < kUnitRows; ++rr) {
            const int row = row0 + rr;
            const bool ok = row < rows && d < p.D;
            cp_async4(unit + rr * kDepth + (lane ^ ((rr & 7) << 2)),
                      ok ? x + size_t(row) * p.D + d : x, ok);
          }
        }
        // The previous stage's copies have landed: one arrive for the warp
        cp_async_commit();
        if (pending != 0) {
          cp_async_wait<1>();
          __syncwarp();
          if (lane == 0) mbar_arrive(pending);
        }
        pending = bar;
      }
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
  if (pending != 0) {
    cp_async_wait<0>();
    __syncwarp();
    if (lane == 0) mbar_arrive(pending);
  }
}

// One stage: TM units of the warp (lane rows rg, 16 + rg, ...) x TN
// features, the stage's kDepth columns in order. xs: the lane's row in the
// warp's first unit; pk: the stage's P for the lane's feature half; sw: the
// swizzle of the lane's rows.
template <int TN, int TM>
__device__ __forceinline__ void multiply(float (&acc)[kWarpUnits][TN],
                                         const float* xs, const float4* pk, int sw) {
#pragma unroll 1
  for (int c = 0; c < kDepth / 4; ++c) {
    float4 xv[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)  // 16-byte chunk c of a row sits at c ^ sw
      xv[i] = *reinterpret_cast<const float4*>(xs + i * kUnitRows * kDepth + ((c ^ sw) << 2));
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const float4 pv = pk[c * 2 * TN + 2 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        acc[i][j] = fmaf(xv[i].x, pv.x, acc[i][j]);
        acc[i][j] = fmaf(xv[i].y, pv.y, acc[i][j]);
        acc[i][j] = fmaf(xv[i].z, pv.z, acc[i][j]);
        acc[i][j] = fmaf(xv[i].w, pv.w, acc[i][j]);
      }
    }
  }
}

template <int TN>
__device__ __forceinline__ void store(const Params& p, const float (&acc)[TN], int u,
                                      int rg, int fg) {
  int row0;
  const int s = unit_set(p, u, row0);
  const int row = row0 + rg;
  if (row >= (s ? p.n[1] : p.n[0])) return;
  float* out = (s ? p.g[1] : p.g[0]) + size_t(row) * p.F;
#pragma unroll
  for (int j = 0; j < TN; ++j)
    if (2 * j + fg < p.F) out[2 * j + fg] = acc[j];
}

template <int TN>
__device__ void consume(const Params& p, const unsigned char* ring, uint32_t full,
                        uint32_t empty, const Share& sh) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int fg = lane >> 4, rg = lane & 15;
  const int sw = rg & 7;  // units are whole swizzle atoms: row rg's swizzle
  int stage = 0;
  uint32_t phase = 0;
  const int rounds = sh.rounds();
  for (int r = 0; r < rounds; ++r) {
    int first, off;
    const int mine = warp_units(sh.round(r, rounds, first), warp, off);
    float acc[kWarpUnits][TN];
#pragma unroll
    for (int i = 0; i < kWarpUnits; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    for (int k = 0; k < p.nk; ++k) {
      mbar_wait(full + 8 * stage, phase);
      const unsigned char* st = ring + stage * kStageBytes;
      const float* xs = reinterpret_cast<const float*>(st + off * kUnitBytes) + rg * kDepth;
      const float4* pk = reinterpret_cast<const float4*>(st + kRowsBytes) + fg;
      switch (mine) {
        case 7: multiply<TN, 7>(acc, xs, pk, sw); break;
        case 6: multiply<TN, 6>(acc, xs, pk, sw); break;
        case 5: multiply<TN, 5>(acc, xs, pk, sw); break;
        case 4: multiply<TN, 4>(acc, xs, pk, sw); break;
        case 3: multiply<TN, 3>(acc, xs, pk, sw); break;
        case 2: multiply<TN, 2>(acc, xs, pk, sw); break;
        case 1: multiply<TN, 1>(acc, xs, pk, sw); break;
        default: break;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * stage);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
#pragma unroll
    for (int i = 0; i < kWarpUnits; ++i)
      if (i < mine) store<TN>(p, acc[i], first + off + i, rg, fg);
  }
}

template <int TN>
__global__ void __launch_bounds__(kThreads, 1)
transform_features_kernel(const __grid_constant__ Maps maps, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* ring = smem_raw + (((raw + kAlign - 1) & ~uint32_t(kAlign - 1)) - raw);
  const uint32_t full = smem_u32(ring + kStages * kStageBytes);
  const uint32_t empty = full + 8 * kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      // Lane 0's expect_tx; without TMA also the warp's arrive once its
      // copies have landed
      mbar_init(full + 8 * s, p.tma ? 1 : 2);
      mbar_init(empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // The block's even share of both sets' units
  Share sh;
  sh.ub = int(int64_t(p.units) * blockIdx.x / gridDim.x);
  sh.ue = int(int64_t(p.units) * (blockIdx.x + 1) / gridDim.x);
  if (threadIdx.x / 32 == kConsumers)
    produce<TN>(&maps, p, ring, full, empty, sh);
  else
    consume<TN>(p, ring, full, empty, sh);
}

// Shared memory of a launch: alignment slack, the ring, its barriers
constexpr size_t kSharedBytes =
    kAlign + size_t(kStages) * kStageBytes + 2 * kStages * sizeof(uint64_t);

// The instantiated tile widths: features a lane half holds
constexpr int kTNs[5] = {4, 8, 12, 15, 16};

int tile_width(int F) {
  for (int tn : kTNs)
    if (2 * tn >= F) return tn;
  return 0;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime (no
// link to libcuda)
cudaError_t encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                              cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess) return err;
    if (q != cudaDriverEntryPointSuccess || f == nullptr) return cudaErrorNotSupported;
    cached = reinterpret_cast<EncodeTiled>(f);
  }
  *fn = cached;
  return cudaSuccess;
}

// Rows a tensor map can address: 16-byte aligned base and row stride
bool tma_rows(const float* x, int D) {
  return D % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
}

// (n, D) rows in boxes of `rows` rows x kDepth columns, swizzled as wide
// as a box row, zeros outside; L2 fetches 256 bytes a row
cudaError_t row_map(CUtensorMap* map, const float* x, int n, int D, int rows) {
  EncodeTiled encode;
  const cudaError_t err = encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {cuuint64_t(D), cuuint64_t(n)};
  const cuuint64_t strides[1] = {cuuint64_t(D) * sizeof(float)};
  const cuuint32_t box[2] = {kDepth, cuuint32_t(rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(x),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int TN>
cudaError_t launch_tn(const Maps& maps, const Params& p, int grid, cudaStream_t stream) {
  const int total = p.nk * kDepth * 2 * TN;
  pack_proj_kernel<TN><<<(total + 255) / 256, 256, 0, stream>>>(
      p.proj, p.D, p.F, const_cast<float*>(p.pq), total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kernel = transform_features_kernel<TN>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(kSharedBytes));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, kSharedBytes, stream>>>(maps, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// g0 = raw0 P (n0 rows) and, with raw1 non-null, g1 = raw1 P (n1 rows), in
// one launch after P's packing into pq (ceil(D / 32) x 32 x 2 TN floats).
// Refuses (cudaErrorInvalidValue) an F above 2 x 16: the caller routes
// those through H1's features-only launch.
int msm_transform_features(const float* raw0, const float* raw1, int n0, int n1,
                           const float* proj, int D, int F, float* g0, float* g1,
                           float* pq, void* stream) {
  if (raw1 == nullptr) n1 = 0;
  if (n0 < 0 || n1 < 0 || D <= 0 || F <= 0) return int(cudaErrorInvalidValue);
  const int tn = tile_width(F);
  if (tn == 0) return int(cudaErrorInvalidValue);
  int dev = 0, optin = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return int(err);
  if (kSharedBytes > size_t(optin)) return int(cudaErrorInvalidValue);
  Params p;
  p.x[0] = raw0;
  p.x[1] = raw1;
  p.g[0] = g0;
  p.g[1] = g1;
  p.n[0] = n0;
  p.n[1] = n1;
  p.units0 = (n0 + kUnitRows - 1) / kUnitRows;
  p.units = p.units0 + (n1 + kUnitRows - 1) / kUnitRows;
  p.proj = proj;
  p.pq = pq;
  p.D = D;
  p.F = F;
  p.nk = (D + kDepth - 1) / kDepth;
  p.tma = (n0 == 0 || tma_rows(raw0, D)) && (n1 == 0 || tma_rows(raw1, D));
  if (p.units == 0) return int(cudaSuccess);
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  if (p.tma) {
    const float* xs[2] = {raw0, raw1};
    const int ns[2] = {n0, n1};
    for (int s = 0; s < 2; ++s)
      for (int b = 0; b < kBoxes && ns[s] > 0 && err == cudaSuccess; ++b)
        err = row_map(&maps.box[b][s], xs[s], ns[s], D, kUnitRows << b);
    if (err != cudaSuccess) return int(err);
  }
  // About one block an SM, each with at least a unit a consumer warp
  const int by_units = (p.units + kConsumers - 1) / kConsumers;
  const int grid = by_units < sms ? by_units : sms;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tn) {
    case 4: err = launch_tn<4>(maps, p, grid, st); break;
    case 8: err = launch_tn<8>(maps, p, grid, st); break;
    case 12: err = launch_tn<12>(maps, p, grid, st); break;
    case 15: err = launch_tn<15>(maps, p, grid, st); break;
    default: err = launch_tn<16>(maps, p, grid, st); break;
  }
  return int(err);
}

}  // extern "C"
