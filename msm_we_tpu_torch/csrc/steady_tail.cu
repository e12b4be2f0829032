// The hot step's steady-state tail for Hopper (sm_90a), one launch for one
// (S, S) f32 flux matrix: the transition matrix, the fixed squarings with a
// row renormalisation after each, the stationary vector and its residual,
// the early-exit rounds, and the target flux. Wrapper:
// ops/steady_tail.py::steady_tail; plain version: step.py::_steady_state
// (ops/steady_tail.py::steady_tail_plain adds its round count).
//
// It replaces no Pallas call. The JAX package leaves this tail to XLA
// (msm_we_tpu/parallel/sharded.py::steady_state_from_flux, a lax.while_loop
// of extra squarings); the port ran it as some 70 small PyTorch launches and
// 16 conditional graph nodes (csrc/graph_if.cu), which took 0.33-0.36 ms of
// a 0.9 ms hot step at S = 252 on an H100 against a bound of a few
// microseconds. This kernel runs the whole of it, its convergence loop
// included, with no host read and no conditional node.
//
// What it computes is step._steady_state's, term by term:
//  1. T: a row with outflux out_i > 0 divided exactly by out_i; a row with
//     none the identity row; a target row 1/n_basis on the basis states.
//  2. n_fixed squarings Tn <- Tn Tn, each followed by the renormalisation
//     of every row by max(sum_j Tn_ij, 1e-30) (the clamp keeps NaN, as
//     torch's clamp does).
//  3. p = p0 Tn from p0 = 1/S, p / max(sum p, 1e-30), residual
//     sum_j |(p T)_j - p_j|.
//  4. While rounds < max_rounds and residual > tol: one more squaring and
//     step 3. tol arrives as the largest f32 not above the caller's tol
//     (_device.f64_threshold), so the f32 test decides as a host read would.
//  5. flux = sum over target columns j and all rows i of T_ij p_i.
// Every product is an f32 fmaf or multiply on the CUDA cores (no tensor
// cores, no TF32). The renormalisation multiplies a row by the IEEE
// reciprocal of its clamped sum, within an ulp of step.py's division: an
// IEEE division of every element as it is staged made a squaring about
// 20 us at S = 252 on an H100 (5 us without it), some blocks taking its
// slow path on the zero padding. Every sum has a fixed order and there are
// no atomics on data,
// so one flux matrix gives the same bits on every run; the orders differ
// from cuBLAS's and torch's reductions, so the results match the PyTorch
// tail to f32 reordering, not bitwise.
//
// What bounds it on an H100: operations. At S = 252 a squaring is 2 S^3 =
// 32 MFLOP, 9 of them 0.29 GFLOP, 4.3 us at 67 TFLOP/s of f32; the bytes
// (the 254 KB flux matrix in, T out) take 0.15 us at 3.35 TB/s. What sets
// the time in practice is the chain of dependent phases: a squaring needs
// the whole previous power, the renormalisation needs whole rows, the
// residual needs the whole vector; a grid barrier between two of them
// costs about 1 us.
//
// Design: one persistent cooperative grid (a launch with
// cudaLaunchAttributeCooperative, captured into a CUDA graph as one kernel
// node), phases separated by grid barriers (cooperative_groups grid sync):
//  * Phase 0: a warp a row sums the row of fm and writes that row of T,
//    both into the output and into a padded copy Tp (NP = S rounded up to
//    kChunk, zero padding) that the squarings read.
//  * A squaring: the NP x NP product is cut into kTM x kTN output tiles
//    (128 at S = 252), taken by the blocks in turn (a
//    block takes several where the grid is smaller than the tiles). A
//    block stages kChunk values of k at a time of its row block and column
//    block into shared memory by cp.async from L2, through a ring of
//    kStages chunks; each thread scales the values it copied by their
//    rows' reciprocals. Each of the 8 warps takes an eighth of every
//    chunk's k for the whole tile and each lane 4 rows x 4 columns of it in
//    registers (16 independent ascending-k fmaf chains, 2 shared loads a k
//    step); the warps' partial tiles are added in warp order. The product
//    goes out unnormalised, with the tile's partial row sums (a fixed
//    shuffle tree over its 32 columns). The next squaring (and the
//    stationary vector) adds the NP / kTN partials of each row in tile
//    order, their loads sent out before the first chunk's copies: the
//    renormalisation costs no barrier of its own.
//  * The stationary vector: warps take columns in turn (p0 Tn column sums,
//    barrier; every block adds the vector in the same order and
//    normalises it, columns of p T - p in turn, barrier; every block adds
//    the |.| in the same order). Every block so holds the same residual,
//    bit for bit, and takes the same decision on the next round: the loop
//    needs no flag and no host.
//  * Block 0 adds the target flux at the end (only the target columns,
//    found 32 to a ballot), writes the round count, and adds it to an
//    optional device counter (null for the plain graph).
// Barriers at 0 extra rounds: 1 after phase 0, 1 a squaring, 2 in the
// stationary vector (12 at S = 252); each extra round adds 3. Shared memory
// (49 KB of ring, opted in as dynamic memory) is S-independent but for two
// vectors of NP floats (reciprocals, p), which bounds S by kMaxStates; the
// scratch (three NP x NP matrices, the partials, two vectors) comes from
// the wrapper.
//
// Plain C interface for ctypes: does not synchronise, allocates nothing.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "assign_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTM = 16;        // rows of a squaring's output tile
constexpr int kTN = 32;        // columns of a squaring's output tile
constexpr int kChunk = 64;     // values of k staged at a time; NP's multiple
constexpr int kStages = 4;     // chunks in the cp.async ring
constexpr int kThreads = 256;  // 8 warps, each over an eighth of a chunk
constexpr int kWarps = kThreads / 32;
constexpr int kKW = kChunk / kWarps;  // values of k a warp takes of a chunk
constexpr int kAStride = kChunk + 4;  // 16-byte rows, 4 banks apart
constexpr int kMaxStates = 2048;

struct Args {
  const float* fm;
  const bool* basis;
  const bool* target;
  int S, NP, NBr, NBc, n_fixed, max_rounds;
  float tol;
  float* T;         // (S, S) out
  float* p;         // (S,) out
  float* flux;      // () out
  float* residual;  // () out
  int* rounds;      // () out
  int* counter;     // () in/out, may be null
  float* Tp;        // (NP, NP) scratch: T padded
  float* C[2];      // (NP, NP) scratch: unnormalised powers
  float* part[2];   // (NBc, NP) scratch: their partial row sums
  float* praw;      // (NP,) scratch: p0 Tn
  float* dabs;      // (NP,) scratch: |p T - p|
};

// A stage of the ring: a chunk of the row block and of the column block
constexpr int kStageA = kTM * kAStride;
constexpr int kStageFloats = kStageA + kChunk * kTN;

// The block's shared memory: the ring, the row reciprocals and p (dynamic),
// and the reductions' scratch
struct Smem {
  float* ring;      // kStages x kStageFloats
  float* rinv;      // NP
  float* ps;        // NP
  float* red;       // kWarps
  unsigned* masks;  // kWarps
};

__device__ __forceinline__ float* stage_a(Smem& sm, int st) {
  return sm.ring + st * kStageFloats;
}

__device__ __forceinline__ float* stage_b(Smem& sm, int st) {
  return sm.ring + st * kStageFloats + kStageA;
}

__device__ __forceinline__ float clamp_min(float s) {
  return s < 1e-30f ? 1e-30f : s;  // torch's clamp(min=1e-30): NaN stays
}

// Sum of v over the warp, the same bits in every lane (the two lanes of a
// butterfly pair add the same two numbers).
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of v over the block, the same bits in every thread: the warps'
// butterflies, then the warp sums in warp order.
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();  // red may still be read by the previous call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = red[0];
  for (int w = 1; w < kWarps; ++w) s += red[w];
  return s;
}

// Phase 0: T (into the output and the padded Tp), a warp a row.
__device__ void transition_rows(const Args& a, float* red) {
  const int lane = threadIdx.x & 31;
  float nb = 0.f;
  for (int j = threadIdx.x; j < a.S; j += kThreads) nb += a.basis[j] ? 1.f : 0.f;
  nb = block_sum(nb, red);  // an exact count below 2^24
  const float recycle = 1.f / (nb < 1.f ? 1.f : nb);
  const int warps = gridDim.x * kWarps;
  for (int i = blockIdx.x * kWarps + (threadIdx.x >> 5); i < a.NP; i += warps) {
    float* trow = a.Tp + size_t(i) * a.NP;
    if (i >= a.S) {
      for (int j = lane; j < a.NP; j += 32) trow[j] = 0.f;
      continue;
    }
    const float* frow = a.fm + size_t(i) * a.S;
    const bool tgt = a.target[i];
    float f[8];  // the row's first 256 values, kept for the division
#pragma unroll
    for (int u = 0; u < 8; ++u) f[u] = lane + 32 * u < a.S ? frow[lane + 32 * u] : 0.f;
    float out = 0.f;
#pragma unroll
    for (int u = 0; u < 8; ++u) out += f[u];  // + 0 past the row's end is exact
    for (int j = lane + 256; j < a.S; j += 32) out += frow[j];
    out = warp_sum(out);
    const bool pos = out > 0.f;
    auto put = [&](int j, float x) {
      float v = 0.f;
      if (j < a.S) {
        if (tgt) v = a.basis[j] ? recycle : 0.f;
        else if (pos) v = x / out;
        else v = (i == j) ? 1.f : 0.f;
        a.T[size_t(i) * a.S + j] = v;
      }
      trow[j] = v;
    };
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (lane + 32 * u < a.NP) put(lane + 32 * u, f[u]);
    for (int j = lane + 256; j < a.NP; j += 32) put(j, j < a.S ? frow[j] : 0.f);
  }
}

// The renormalisation of the last power: 1 / max(row sum, 1e-30) for every
// row, the NBc partials of a row added in tile order. A thread takes rows
// k and k + kThreads at a time and loads 8 partials of each before it adds
// any, so a block waits on L2 once a batch (once at S <= 512) and not once
// a row. ``first`` is the thread's first batch, which the caller loads
// (load_partials) before it sends its own loads out.
struct Partials {
  float v0[8], v1[8];
};

__device__ __forceinline__ void load_partials(const Args& a, const float* part,
                                              int k, int b0, Partials& p) {
  const int NP = a.NP, k2 = k + kThreads;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const bool ok = k < NP && b0 + u < a.NBc;
    const float* q = part + size_t(b0 + u) * NP;
    p.v0[u] = ok ? __ldcg(q + k) : 0.f;
    p.v1[u] = ok && k2 < NP ? __ldcg(q + k2) : 0.f;
  }
}

__device__ void row_recips(const Args& a, const float* part, const Partials& first,
                           float* rinv) {
  const int NP = a.NP;
  for (int k = threadIdx.x; k < NP; k += 2 * kThreads) {
    const int k2 = k + kThreads;
    float s0 = 0.f, s1 = 0.f;
    for (int b0 = 0; b0 < a.NBc; b0 += 8) {
      Partials p;
      if (k == int(threadIdx.x) && b0 == 0) p = first;
      else load_partials(a, part, k, b0, p);
#pragma unroll
      for (int u = 0; u < 8; ++u) {  // + 0 past the last partial is exact
        s0 += p.v0[u];
        s1 += p.v1[u];
      }
    }
    rinv[k] = 1.f / clamp_min(s0);
    if (k2 < NP) rinv[k2] = 1.f / clamp_min(s1);
  }
}

// Copies of one chunk of tile (bi, bj) into stage st: A row tid >> 4 at
// columns k0 + 4 (tid & 15), B rows k0 + (tid >> 3) + 32 m at columns
// 4 (tid & 7) of the column block.
__device__ __forceinline__ void issue_chunk(const Args& a, const float* src,
                                            int bi, int bj, int k0, Smem& sm,
                                            int st) {
  const int tid = threadIdx.x, NP = a.NP;
  {
    const int r = tid >> 4, q = tid & 15;
    cp_async16(stage_a(sm, st) + r * kAStride + 4 * q,
               src + size_t(bi * kTM + r) * NP + k0 + 4 * q, true);
  }
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int kk = (tid >> 3) + 32 * m, q = tid & 7;
    cp_async16(stage_b(sm, st) + kk * kTN + 4 * q,
               src + size_t(k0 + kk) * NP + bj * kTN + 4 * q, true);
  }
  cp_async_commit();
}

// This thread's own copies of a chunk times their rows' reciprocals.
__device__ __forceinline__ void scale_chunk(const float* rinv, int bi, int k0,
                                            Smem& sm, int st) {
  const int tid = threadIdx.x;
  {
    const int r = tid >> 4;
    float4* v = reinterpret_cast<float4*>(stage_a(sm, st) + r * kAStride + 4 * (tid & 15));
    const float s = rinv[bi * kTM + r];
    *v = make_float4(v->x * s, v->y * s, v->z * s, v->w * s);
  }
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int kk = (tid >> 3) + 32 * m;
    float4* v = reinterpret_cast<float4*>(stage_b(sm, st) + kk * kTN + 4 * (tid & 7));
    const float s = rinv[k0 + kk];
    *v = make_float4(v->x * s, v->y * s, v->z * s, v->w * s);
  }
}

// One squaring: dst = Tn Tn with Tn = src (Tp) or, with recip_part, src
// times the reciprocals of its row sums, computed here from recip_part
// into sm.rinv while the first chunks are in flight; with scale alone,
// sm.rinv already holds them. dst goes out unnormalised, dpart its tiles' row sums.
// Warp w takes k in [kKW w, kKW w + kKW) of every chunk for the whole
// tile, its lane rows rg + 4 q (q < 4) and columns 4 cg + c (c < 4): per k
// one 16-byte load of B and a quarter of one of A serve 16 fmaf. The
// warps' sums of a cell are added in warp order at the end.
__device__ void square(const Args& a, const float* src, bool scale,
                       const float* recip_part, float* dst, float* dpart,
                       Smem& sm) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = lane >> 3, cg = lane & 7;
  const int NP = a.NP, nch = NP / kChunk, tiles = a.NBr * a.NBc;
  int t = blockIdx.x;
  Partials first;
  if (recip_part) load_partials(a, recip_part, tid, 0, first);
  // The first kStages - 1 chunks of a tile go out at once (an empty group
  // where the tile has fewer), so that the wait below always leaves the
  // newest kStages - 1 groups in flight
  auto prologue = [&](int bi, int bj) {
    for (int c = 0; c < kStages - 1; ++c) {
      if (c < nch) issue_chunk(a, src, bi, bj, c * kChunk, sm, c);
      else cp_async_commit();
    }
  };
  if (t < tiles) prologue(t / a.NBc, t % a.NBc);
  if (recip_part) row_recips(a, recip_part, first, sm.rinv);
  __syncthreads();
  for (bool first_tile = true; t < tiles; t += gridDim.x, first_tile = false) {
    const int bi = t / a.NBc, bj = t % a.NBc;
    if (!first_tile) prologue(bi, bj);
    float acc[4][4] = {};
    for (int c = 0; c < nch; ++c) {
      const int st = c % kStages, ahead = c + kStages - 1;
      if (ahead < nch) issue_chunk(a, src, bi, bj, ahead * kChunk, sm, ahead % kStages);
      else cp_async_commit();
      cp_async_wait<kStages - 1>();
      if (scale) scale_chunk(sm.rinv, bi, c * kChunk, sm, st);
      __syncthreads();
      const float* As = stage_a(sm, st) + kKW * warp;
      const float* Bs = stage_b(sm, st) + kKW * warp * kTN + 4 * cg;
#pragma unroll
      for (int k = 0; k < kKW; k += 4) {
        float4 av[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          av[q] = *reinterpret_cast<const float4*>(As + (rg + 4 * q) * kAStride + k);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 b = *reinterpret_cast<const float4*>(Bs + (k + kk) * kTN);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float x = kk == 0 ? av[q].x : kk == 1 ? av[q].y : kk == 2 ? av[q].z : av[q].w;
            acc[q][0] = fmaf(x, b.x, acc[q][0]);
            acc[q][1] = fmaf(x, b.y, acc[q][1]);
            acc[q][2] = fmaf(x, b.z, acc[q][2]);
            acc[q][3] = fmaf(x, b.w, acc[q][3]);
          }
        }
      }
      __syncthreads();
    }
    // The warps' partial tiles meet in the ring, idle after the loop
    float* part_tiles = sm.ring;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      *reinterpret_cast<float4*>(part_tiles + warp * kTM * kTN + (rg + 4 * q) * kTN + 4 * cg) =
          make_float4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]);
    __syncthreads();
    const int r = tid >> 4, c2 = 2 * (tid & 15);
    float2 v = *reinterpret_cast<const float2*>(part_tiles + r * kTN + c2);
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const float2 u = *reinterpret_cast<const float2*>(part_tiles + w * kTM * kTN + r * kTN + c2);
      v = make_float2(v.x + u.x, v.y + u.y);
    }
    const int row = bi * kTM + r;
    *reinterpret_cast<float2*>(dst + size_t(row) * NP + bj * kTN + c2) = v;
    float s = v.x + v.y;
    for (int o = 8; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if ((tid & 15) == 0) dpart[size_t(bj) * NP + row] = s;
    __syncthreads();  // the ring takes the next tile's copies
  }
}

// A warp's first batch of a column of M (row stride NP): rows lane + 32 u
// (u < 8), 0 past S or where the warp has no column.
__device__ __forceinline__ void load_column(const Args& a, const float* M, int j,
                                            int k0, float (&c)[8]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int k = k0 + lane + 32 * u;
    c[u] = j < a.S && k < a.S ? __ldcg(M + size_t(k) * a.NP + j) : 0.f;
  }
}

// sum_k w(k) M_kj over the rows of column j, lane-strided fmaf chains in
// ascending k, then the warp's butterfly; ``first`` is the column's first
// batch, already loaded.
template <typename W>
__device__ __forceinline__ float column_dot(const Args& a, const float* M, int j,
                                            const float (&first)[8], W w) {
  const int lane = threadIdx.x & 31;
  float v = 0.f;
  for (int k0 = 0; k0 < a.S; k0 += 256) {
    float c[8];
    if (k0 == 0) {
#pragma unroll
      for (int u = 0; u < 8; ++u) c[u] = first[u];
    } else {
      load_column(a, M, j, k0, c);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int k = k0 + lane + 32 * u;
      if (k < a.S) v = w(k, c[u], v);
    }
  }
  return warp_sum(v);
}

// The stationary vector of the last power a.C[cur] (times the reciprocals
// of the row sums in ``part``, computed here into sm.rinv) and its residual
// against T; every block returns the same residual. p lands in shared
// memory (sm.ps) in every block and in the output. Column sums go a warp a
// column; each warp's first column is in flight while the block adds what
// the column's weights need.
__device__ float stationary(const Args& a, const float* C, const float* part,
                            Smem& sm, cg::grid_group& grid) {
  const int S = a.S, tid = threadIdx.x, lane = tid & 31;
  const int gw = blockIdx.x * kWarps + (tid >> 5), nw = gridDim.x * kWarps;
  const float p0 = 1.f / float(S);
  const float* rinv = sm.rinv;
  float* ps = sm.ps;
  Partials firstp;
  load_partials(a, part, tid, 0, firstp);
  float first[8];
  load_column(a, C, gw, 0, first);
  row_recips(a, part, firstp, sm.rinv);
  __syncthreads();
  for (int j = gw; j < S; j += nw) {
    if (j != gw) load_column(a, C, j, 0, first);
    const float v = column_dot(a, C, j, first, [&](int k, float x, float acc) {
      return fmaf(p0, x * rinv[k], acc);
    });
    if (lane == 0) a.praw[j] = v;
  }
  grid.sync();
  load_column(a, a.Tp, gw, 0, first);
  for (int k = tid; k < S; k += kThreads) ps[k] = __ldcg(a.praw + k);
  __syncthreads();
  float s = 0.f;
  for (int k = tid; k < S; k += kThreads) s += ps[k];
  const float denom = clamp_min(block_sum(s, sm.red));
  for (int k = tid; k < S; k += kThreads) ps[k] = ps[k] / denom;
  __syncthreads();
  for (int j = gw; j < S; j += nw) {
    if (j != gw) load_column(a, a.Tp, j, 0, first);
    const float v = column_dot(a, a.Tp, j, first, [&](int k, float x, float acc) {
      return fmaf(ps[k], x, acc);
    });
    if (lane == 0) {
      a.dabs[j] = fabsf(v - ps[j]);
      a.p[j] = ps[j];
    }
  }
  grid.sync();
  float r = 0.f;
  for (int j = tid; j < S; j += kThreads) r += __ldcg(a.dabs + j);
  return block_sum(r, sm.red);
}

// Block 0, at the end: sum over target columns j and rows i of T_ij p_i.
// The target columns come 32 to a ballot, so only they are walked.
__device__ float target_flux(const Args& a, Smem& sm) {
  const float* ps = sm.ps;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float f = 0.f;
  for (int j0 = 0; j0 < a.S; j0 += kThreads) {
    const int j = j0 + tid;
    const unsigned m = __ballot_sync(0xffffffffu, j < a.S && a.target[j]);
    if (lane == 0) sm.masks[warp] = m;
    __syncthreads();
    for (int w = 0; w < kWarps; ++w) {
      for (unsigned mw = sm.masks[w]; mw; mw &= mw - 1) {
        const int col = j0 + 32 * w + __ffs(mw) - 1;
        for (int i = tid; i < a.S; i += kThreads)
          f = fmaf(__ldcg(a.Tp + size_t(i) * a.NP + col), ps[i], f);
      }
    }
    __syncthreads();
  }
  return block_sum(f, sm.red);
}

__global__ void __launch_bounds__(kThreads)
steady_tail_kernel(Args a) {
  extern __shared__ __align__(16) float dyn[];
  __shared__ float red[kWarps];
  __shared__ unsigned masks[kWarps];
  Smem sm{dyn, dyn + kStages * kStageFloats, dyn + kStages * kStageFloats + a.NP,
          red, masks};
  cg::grid_group grid = cg::this_grid();

  transition_rows(a, sm.red);
  grid.sync();
  int cur = 0;  // a.C[cur] holds the last power
  square(a, a.Tp, false, nullptr, a.C[cur], a.part[cur], sm);
  grid.sync();
  for (int s = 1; s < a.n_fixed; ++s) {
    square(a, a.C[cur], true, a.part[cur], a.C[cur ^ 1], a.part[cur ^ 1], sm);
    cur ^= 1;
    grid.sync();
  }
  float res = stationary(a, a.C[cur], a.part[cur], sm, grid);
  int rounds = 0;
  while (rounds < a.max_rounds && res > a.tol) {
    square(a, a.C[cur], true, nullptr, a.C[cur ^ 1], a.part[cur ^ 1], sm);
    cur ^= 1;
    grid.sync();
    res = stationary(a, a.C[cur], a.part[cur], sm, grid);
    ++rounds;
  }
  if (blockIdx.x != 0) return;
  const float f = target_flux(a, sm);
  if (threadIdx.x == 0) {
    *a.flux = f;
    *a.residual = res;
    *a.rounds = rounds;
    if (a.counter) atomicAdd(a.counter, rounds);
  }
}

}  // namespace

extern "C" {

// The tail of one (S, S) f32 flux matrix (row-major, contiguous) with bool
// masks of S states, on ``stream``. n_fixed >= 1 squarings, at most
// max_rounds extra rounds while the residual exceeds tol. Writes T (S, S),
// p (S), flux, residual and rounds; adds rounds to *counter when counter is
// not null. ``scratch`` holds 3 NP^2 + 2 NBc NP + 2 NP floats (NP = S
// rounded up to kChunk, NBc = NP / kTN). Returns a
// cudaError_t (cudaErrorInvalidValue for S outside [1, kMaxStates] or
// n_fixed < 1).
int msm_steady_tail(const void* fm, const void* basis, const void* target,
                    int S, int n_fixed, int max_rounds, float tol, void* T,
                    void* p, void* flux, void* residual, void* rounds,
                    void* counter, void* scratch, void* stream) {
  if (S < 1 || S > kMaxStates || n_fixed < 1 || max_rounds < 0)
    return int(cudaErrorInvalidValue);
  Args a;
  a.fm = static_cast<const float*>(fm);
  a.basis = static_cast<const bool*>(basis);
  a.target = static_cast<const bool*>(target);
  a.S = S;
  a.NP = (S + kChunk - 1) / kChunk * kChunk;
  a.NBr = a.NP / kTM;
  a.NBc = a.NP / kTN;
  a.n_fixed = n_fixed;
  a.max_rounds = max_rounds;
  a.tol = tol;
  a.T = static_cast<float*>(T);
  a.p = static_cast<float*>(p);
  a.flux = static_cast<float*>(flux);
  a.residual = static_cast<float*>(residual);
  a.rounds = static_cast<int*>(rounds);
  a.counter = static_cast<int*>(counter);
  float* s = static_cast<float*>(scratch);
  const size_t sq = size_t(a.NP) * a.NP, pv = size_t(a.NBc) * a.NP;
  a.Tp = s;
  a.C[0] = s + sq;
  a.C[1] = s + 2 * sq;
  a.part[0] = s + 3 * sq;
  a.part[1] = s + 3 * sq + pv;
  a.praw = s + 3 * sq + 2 * pv;
  a.dabs = a.praw + a.NP;

  const size_t smem = (size_t(kStages) * kStageFloats + 2 * size_t(a.NP)) * sizeof(float);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      steady_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return int(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, steady_tail_kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return int(err);
  const int tiles = a.NBr * a.NBc;
  const int grid = tiles < per_sm * sms ? tiles : per_sm * sms;  // all resident
  if (grid < 1) return int(cudaErrorCooperativeLaunchTooLarge);

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, steady_tail_kernel, a);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

}  // extern "C"
