// The cp.async copies that csrc/matmul_ln.cu, csrc/flash_attention.cu and
// csrc/depthwise_conv.cu share (sm_80 and later; built here for sm_90a):
// copies from device to shared memory, zero-filled past the bounds, in
// commit groups.  16 bytes through L2 only (`.cg`); 4 and 8 bytes through
// L1 (`.ca`, the only form that takes them), for rows that are not 16-byte
// aligned, such as a channel slice that starts at an odd multiple of 2.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// V elements from src to shared memory at dst, the first `valid` of them
// inside the bounds and the rest zero.  Where `vec` says the rows are
// 16-byte aligned: one asynchronous 16-byte copy that reads only the valid
// bytes (none, from the aligned `base`, where valid <= 0) and zero-fills the
// rest.  Else bounds-checked scalars, stored at once.
template <typename R, int V>
__device__ __forceinline__ void copy_chunk(void* dst, const R* src, long long valid, bool vec,
                                           const R* base) {
  if (vec) {
    const int n = valid <= 0 ? 0 : valid >= V ? V : (int)valid;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     (uint32_t)__cvta_generic_to_shared(dst)),
                 "l"(n ? src : base), "r"(n * (int)sizeof(R))
                 : "memory");
    return;
  }
  union {
    uint4 u;
    R r[V];
  } c;
#pragma unroll
  for (int i = 0; i < V; ++i) c.r[i] = i < valid ? src[i] : R(0);
  *reinterpret_cast<uint4*>(dst) = c.u;
}

// N bytes (4, 8 or 16) from src to shared memory at dst, or N zero bytes
// where !valid (then nothing is read, from the valid address `base`).
template <int N>
__device__ __forceinline__ void copy_bytes(void* dst, const void* src, bool valid,
                                           const void* base) {
  static_assert(N == 4 || N == 8 || N == 16, "cp.async copies 4, 8 or 16 bytes");
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(valid ? src : base), "r"(valid ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(valid ? src : base), "n"(N), "r"(valid ? N : 0)
                 : "memory");
}

// f(integral_constant<int, n>) for a run-time n in 1..N (nothing for n = 0)
template <int N, typename F>
__device__ __forceinline__ void with_count(int n, F&& f) {
  if constexpr (N > 0) {
    if (n == N) f(std::integral_constant<int, N>{});
    else with_count<N - 1>(n, f);
  }
}

}  // namespace
