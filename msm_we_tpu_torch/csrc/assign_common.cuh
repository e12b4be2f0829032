// Device helpers shared by the assignment kernels of this directory
// (stratified_assign.cu, pair_assign.cu, assign_flux.cu): the (score, id)
// order every kernel reduces by, mask reads, a binary search, the override
// orders and the cp.async copies (steady_tail.cu stages its squarings with
// them too). They live in an anonymous namespace, so
// each source that includes them compiles its own copy.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Overrides { kNone = 0, kFluxOrder = 1, kPredictOrder = 2 };

// Feature rows and the override masks and id outputs of the parent set
// (slot 0) and the child set (slot 1)
struct Sides {
  const float* x[2];         // (n_side, F) parent, child features
  const uint8_t* basis[2];   // (n_side,) or null
  const uint8_t* target[2];  // (n_side,) or null
  int32_t* idx[2];           // (n_side,) output ids
};

// (s, k) lies below (bs, bk) in (score, id) order; bk < 0: nothing yet
// (bs is then +inf, so inf and NaN scores are never taken)
__device__ __forceinline__ bool better(float s, int k, float bs, int bk) {
  return s < bs || (bk >= 0 && s == bs && k < bk);
}

__device__ __forceinline__ bool flag(const uint8_t* m, int row) {
  return m != nullptr && m[row] != 0;
}

// First index of a sorted array whose value is >= v (lower) or > v (upper)
template <bool UPPER, typename T, typename V>
__device__ int search(const T* a, int n, V v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (UPPER ? !(v < a[mid]) : a[mid] < v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// One cp.async of 4, 8 or 16 bytes into shared memory (both addresses
// aligned to the size; 16 bytes bypass L1), zero-filled when !ok
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async8(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 8 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// This thread's committed copies, all but the newest N groups, have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace
