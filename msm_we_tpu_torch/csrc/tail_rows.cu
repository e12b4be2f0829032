// The row passes of the float64 steady-state tail for Hopper (sm_90a): the
// tail that an f32 flux matrix of more than S_MAX states takes in float64
// on the card, around cuBLAS's DGEMM squarings (step.py::_steady_state).
// Wrappers: ops/tail_rows.py::renormalize and ::transition; plain versions:
// step.py::_renormalize and step.py::_transition_matrix (with
// step.py::_target_flux).
//
// It replaces no Pallas call. The JAX package leaves this tail to XLA
// (msm_we_tpu/parallel/sharded.py::steady_state_from_flux: the transition
// matrix, the squarings of a lax.while_loop, each renormalised). The port
// ran these row passes as PyTorch launches on the padded, strided squares:
// a row sum and a division after each squaring, and some fifteen passes
// for the transition matrix, its f32 copy and the target flux, about
// 1.95 ms of an 11.8 ms tail at 3,202 states on an H100 beside 9.87 ms of
// DGEMM.
//
// What it computes is the plain version's, term by term, in float64:
//  * tail_renorm_kernel: each row of a squared matrix divided, in place, by
//    max(sum_j A_ij, 1e-30) (the clamp keeps NaN, as torch's clamp does).
//    An IEEE division of every element, as step.py divides, not a
//    reciprocal.
//  * tail_transition_kernel: from the f32 (or f64) flux matrix fm, T in
//    float64: a row with outflux out_i = sum_j fm_ij > 0 divided exactly by
//    out_i (no clamp); a row with none the identity row; a target row
//    1 / max(n_basis, 1) on the basis states. Beside it the f32 copy of T,
//    each value the f64 one rounded once (what T.to(float32) gives), and
//    each row's target mass sum over target columns j of T_ij, so that the
//    target flux is p . mass, the plain version's sum in another order.
// Every sum is in float64 in a fixed order (a thread's values in column
// order, a warp's butterfly, the warps in order), so one input gives the
// same bits on every run; the orders differ from torch's reductions, so
// the results match the plain version to float64 reordering, not bitwise.
//
// What bounds it on an H100: bytes. At 3,202 states a row pass of the f64
// matrix (82 MB, rows padded to 32 bytes) reads and writes it once: 164 MB,
// 49 us at 3.35 TB/s; the transition pass reads the f32 flux (41 MB) and
// writes T (82 MB) and its f32 copy (41 MB), 49 us as well. The divisions
// (10.25M IEEE f64 divisions a pass) stay below that on the FP64 units.
//
// Design: one block of 256 threads a row (a grid-stride loop over rows). A
// thread keeps its values of the row in registers: 16 values a thread, as
// 8 aligned 16-byte loads in the renormalisation (rows start on 32 bytes,
// step.ROW_ALIGN) and as coalesced 4- or 8-byte loads of the flux, so rows
// of up to 4,096 states are read once; past that a row's further values
// are read again for the second pass (from L2). The block sums the row,
// then writes every value of it. A row's padding columns are left as they
// are in the renormalisation and written as 0 by the transition pass. The
// loads a thread sends out before it sums are what keeps the memory busy,
// so the register bounds (kRenormBlocks, kTransitionBlocks) are set for as
// many blocks an SM as the values fit without spilling: at 3,202 states
// on an H100 a renormalisation takes 57 us (86% of its floor), the
// transition pass 73 us (67%).
// Neither kernel allocates or reads anything back to the host, so both
// are captured into the step's CUDA graph as plain kernel nodes, the
// renormalisation also inside the conditional rounds' bodies.
//
// Plain C interface for ctypes: does not synchronise, allocates nothing.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Blocks an SM holds: 64 registers a thread for the renormalisation, 85
// for the transition pass (at 64 it spills and took 94 us, at 128 81 us,
// against 73 us here, at 3,202 states on an H100)
constexpr int kRenormBlocks = 4;
constexpr int kTransitionBlocks = 3;
constexpr int kVec = 8;             // 16-byte pairs a thread keeps (renorm)
constexpr int kVals = 2 * kVec;     // values a thread keeps (transition)
constexpr int kAlignBytes = 32;     // step.ROW_ALIGN

__device__ __forceinline__ double clamp_min(double s) {
  return s < 1e-30 ? 1e-30 : s;  // torch's clamp(min=1e-30): NaN stays
}

// Sum of v over the block, the same bits in every thread: the warps'
// butterflies (both lanes of a pair add the same two numbers), then the
// warp sums in warp order.
__device__ double block_sum(double v, double* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // red may still be read by the previous call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = red[0];
  for (int w = 1; w < kWarps; ++w) s += red[w];
  return s;
}

// Rows of a (S, S) f64 matrix with leading dimension ld (a multiple of 4,
// rows on 32 bytes) divided by their clamped sums, in place. The pair at
// column 2k holds columns 2k and 2k + 1; where S is odd the last pair's
// second value is padding, neither added nor written.
__global__ void __launch_bounds__(kThreads, kRenormBlocks)
tail_renorm_kernel(double* __restrict__ a, int S, int ld) {
  __shared__ double red[kWarps];
  const int tid = threadIdx.x;
  const int n2 = (S + 1) / 2;
  for (int i = blockIdx.x; i < S; i += gridDim.x) {
    double2* row = reinterpret_cast<double2*>(a + size_t(i) * ld);
    double2 v[kVec];
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      const int k = tid + u * kThreads;
      v[u] = k < n2 ? row[k] : make_double2(0.0, 0.0);
    }
    double s = 0.0;
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      const int k = tid + u * kThreads;
      if (k < n2) {
        s += v[u].x;
        if (2 * k + 1 < S) s += v[u].y;
      }
    }
    for (int k = tid + kVec * kThreads; k < n2; k += kThreads) {
      const double2 w = row[k];
      s += w.x;
      if (2 * k + 1 < S) s += w.y;
    }
    const double d = clamp_min(block_sum(s, red));
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      const int k = tid + u * kThreads;
      if (k < n2) {
        double2 w = v[u];
        w.x = w.x / d;
        if (2 * k + 1 < S) w.y = w.y / d;
        row[k] = w;
      }
    }
    for (int k = tid + kVec * kThreads; k < n2; k += kThreads) {
      double2 w = row[k];
      w.x = w.x / d;
      if (2 * k + 1 < S) w.y = w.y / d;
      row[k] = w;
    }
  }
}

// The transition matrix of the (S, S) row-major flux fm: T (leading
// dimension ld, padding columns 0), its f32 copy T32 (S, S; may be null)
// and each row's target mass.
template <typename F>
__global__ void __launch_bounds__(kThreads, kTransitionBlocks)
tail_transition_kernel(const F* __restrict__ fm, const bool* __restrict__ basis,
                       const bool* __restrict__ target, int S, int ld,
                       double* __restrict__ T, float* __restrict__ T32,
                       double* __restrict__ mass) {
  __shared__ double red[kWarps];
  const int tid = threadIdx.x;
  for (int i = blockIdx.x; i < S; i += gridDim.x) {
    const F* frow = fm + size_t(i) * S;
    double* trow = T + size_t(i) * ld;
    float* t32 = T32 ? T32 + size_t(i) * S : nullptr;
    double m = 0.0;
    if (target[i]) {  // the same for the whole block
      double nb = 0.0;
      for (int j = tid; j < S; j += kThreads) nb += basis[j] ? 1.0 : 0.0;
      nb = block_sum(nb, red);  // an exact count
      const double r = 1.0 / (nb < 1.0 ? 1.0 : nb);
      for (int j = tid; j < ld; j += kThreads) {
        const double v = j < S && basis[j] ? r : 0.0;
        trow[j] = v;
        if (j < S) {
          if (t32) t32[j] = static_cast<float>(v);
          if (target[j]) m += v;
        }
      }
    } else {
      F f[kVals];
      double s = 0.0;
#pragma unroll
      for (int u = 0; u < kVals; ++u) {
        const int j = tid + u * kThreads;
        f[u] = j < S ? frow[j] : F(0);
      }
#pragma unroll
      for (int u = 0; u < kVals; ++u)
        if (tid + u * kThreads < S) s += static_cast<double>(f[u]);
      for (int j = tid + kVals * kThreads; j < S; j += kThreads)
        s += static_cast<double>(frow[j]);
      const double out = block_sum(s, red);
      const bool pos = out > 0.0;  // NaN: no outflux, the identity row
      auto put = [&](int j, double x) {
        const double v = pos ? x / out : (i == j ? 1.0 : 0.0);
        trow[j] = v;
        if (t32) t32[j] = static_cast<float>(v);
        if (target[j]) m += v;
      };
#pragma unroll
      for (int u = 0; u < kVals; ++u) {
        const int j = tid + u * kThreads;
        if (j < S) put(j, static_cast<double>(f[u]));
      }
      for (int j = tid + kVals * kThreads; j < S; j += kThreads)
        put(j, static_cast<double>(frow[j]));
      for (int j = S + tid; j < ld; j += kThreads) trow[j] = 0.0;
    }
    m = block_sum(m, red);
    if (tid == 0) mass[i] = m;
  }
}

// Blocks for S rows: one a row, at most 65,535 (a grid-stride loop takes
// the rest).
int row_grid(int S) { return S < 65535 ? S : 65535; }

bool aligned(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % kAlignBytes == 0;
}

}  // namespace

extern "C" {

// Renormalise the rows of the (S, S) f64 matrix ``a`` (leading dimension
// ld, a multiple of 4 not below S; ``a`` on 32 bytes) in place, on
// ``stream``. Returns a cudaError_t (cudaErrorInvalidValue for a shape or
// alignment the kernel does not take).
int msm_tail_renorm(void* a, int S, int ld, void* stream) {
  if (S < 1 || ld < S || ld % 4 != 0 || !aligned(a))
    return int(cudaErrorInvalidValue);
  tail_renorm_kernel<<<row_grid(S), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<double*>(a), S, ld);
  return int(cudaGetLastError());
}

// The transition pass of the (S, S) row-major flux ``fm`` (f64 where
// ``f64_input``, else f32) with bool masks of S states, on ``stream``:
// writes T (S rows of ld doubles, on 32 bytes), T32 (S x S floats; skipped
// where null) and mass (S doubles). Returns a cudaError_t.
int msm_tail_transition(const void* fm, int f64_input, const void* basis,
                        const void* target, int S, int ld, void* T, void* T32,
                        void* mass, void* stream) {
  if (S < 1 || ld < S || ld % 4 != 0 || !aligned(T))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool* b = static_cast<const bool*>(basis);
  const bool* t = static_cast<const bool*>(target);
  double* Td = static_cast<double*>(T);
  float* T32f = static_cast<float*>(T32);
  double* md = static_cast<double*>(mass);
  if (f64_input)
    tail_transition_kernel<double><<<row_grid(S), kThreads, 0, st>>>(
        static_cast<const double*>(fm), b, t, S, ld, Td, T32f, md);
  else
    tail_transition_kernel<float><<<row_grid(S), kThreads, 0, st>>>(
        static_cast<const float*>(fm), b, t, S, ld, Td, T32f, md);
  return int(cudaGetLastError());
}

}  // extern "C"
