// The mma.sync arithmetic that csrc/fused_ibn.cu, csrc/matmul_ln.cu and
// csrc/flash_attention.cu share
// (sm_80 and later; built here for sm_90a): float32 as 3xTF32 on
// mma.m16n8k8, bfloat16 as one mma.m16n8k16 term, both accumulating in
// float32, issued as PTX with the ISA's fragment layouts (the WMMA API's
// tf32 fragments compile to k = 4 instructions and generic loads).
//
// 3xTF32: each operand a is split into big = tf32(a) (rounded to nearest)
// and small = a - big, and small.big + big.small + big.big is accumulated
// (the tensor cores read the top 19 bits of small).  The dropped
// small.small term and that truncation cost about 2^-21 of a product,
// where one TF32 term costs 2^-11.  The tensor cores round their own
// float32 sums towards zero, so a caller sums each K slab from zero and
// adds it to its accumulator in float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* p) { *p = __float2bfloat16(v); }

// v rounded to TF32 (10 mantissa bits), to nearest with ties away from zero
// (as cvt.rna.tf32.f32, without its checks for inf and NaN: two integer
// operations instead of four)
__device__ __forceinline__ uint32_t tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// The tensor-core arithmetic of each input type.  Fragments follow the PTX
// ISA layouts of mma.m16n8k8 (tf32) and mma.m16n8k16 (bf16), with
// g = lane / 4 and t = lane % 4: A (16 x K, row-major in shared memory), B
// (K x 8, row-major [k][n] in shared memory), C (16 x 8): rows g and g + 8,
// columns 2t and 2t + 1.  Padding of the shared-memory rows (elements):
// PAD_A makes the A loads, PAD_B the B loads free of bank conflicts.
template <typename T>
struct Mma;

template <>
struct Mma<float> {
  using S = float;
  static constexpr int K = 8, PAD_A = 4, PAD_B = 8;
  struct A { uint32_t big[4], small[4]; };
  struct B { uint32_t big[2], small[2]; };
  // a = big + small exactly; small goes to the tensor cores as it is, which
  // read its top 19 bits (|small| <= 2^-11 |a|, so that costs 2^-21 |a|)
  template <int N>
  __device__ static void split(const float (&v)[N], uint32_t (&big)[N], uint32_t (&small)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      big[i] = tf32(v[i]);
      small[i] = __float_as_uint(v[i] - __uint_as_float(big[i]));
    }
  }
  // s: the tile's (row 0, k 0)
  __device__ static A load_a(const S* s, int ld, int lane) {
    const int g = lane / 4, t = lane % 4;
    const float v[4] = {s[g * ld + t], s[(g + 8) * ld + t], s[g * ld + t + 4],
                        s[(g + 8) * ld + t + 4]};
    A a;
    split(v, a.big, a.small);
    return a;
  }
  // The resident x block (the A operand of every F tile) is split once, as
  // it is stored: big at p, small at p + part.
  static constexpr int X_PARTS = 2;
  __device__ static void put_x(float v, S* p, int part) {
    const uint32_t big = tf32(v);
    p[0] = __uint_as_float(big);
    p[part] = v - __uint_as_float(big);
  }
  __device__ static A load_x(const S* s, int ld, int part, int lane) {
    const int g = lane / 4, t = lane % 4;
    const int o[4] = {g * ld + t, (g + 8) * ld + t, g * ld + t + 4, (g + 8) * ld + t + 4};
    A a;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a.big[i] = __float_as_uint(s[o[i]]);
      a.small[i] = __float_as_uint(s[part + o[i]]);
    }
    return a;
  }
  // s: the tile's (k 0, n 0)
  __device__ static B load_b(const S* s, int ld, int lane) {
    const int g = lane / 4, t = lane % 4;
    const float v[2] = {s[t * ld + g], s[(t + 4) * ld + g]};
    B b;
    split(v, b.big, b.small);
    return b;
  }
  // the same B tile stored transposed, [n][k] (s: its (n 0, k 0)), as K is
  // in Q K^T: the A layout's rows g, so PAD_A's padding fits it too
  __device__ static B load_bt(const S* s, int ld, int lane) {
    const int g = lane / 4, t = lane % 4;
    const float v[2] = {s[g * ld + t], s[g * ld + t + 4]};
    B b;
    split(v, b.big, b.small);
    return b;
  }
  __device__ static void mma1(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  // d += a @ b: the small terms first, then big . big
  __device__ static void mma(float (&d)[4], const A& a, const B& b) {
    mma1(d, a.big, b.small);
    mma1(d, a.small, b.big);
    mma1(d, a.big, b.big);
  }
  // a @ b[j] for NJ tiles that share a: the small terms into ds[j], big . big
  // into db[j], issued term by term across the tiles, so that no mma waits
  // on the one issued just before it (the sum of a tile is ds + db)
  template <int NJ>
  __device__ static void mma_row(float (&ds)[NJ][4], float (&db)[NJ][4], const A& a,
                                 const B (&b)[NJ]) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) mma1(ds[j], a.big, b[j].small);
#pragma unroll
    for (int j = 0; j < NJ; ++j) mma1(db[j], a.big, b[j].big);
#pragma unroll
    for (int j = 0; j < NJ; ++j) mma1(ds[j], a.small, b[j].big);
  }
};

template <>
struct Mma<__nv_bfloat16> {
  using S = __nv_bfloat16;
  static constexpr int K = 16, PAD_A = 8, PAD_B = 8;
  struct A { uint32_t r[4]; };
  struct B { uint32_t r[2]; };
  __device__ static uint32_t pair(const S* p) { return *reinterpret_cast<const uint32_t*>(p); }
  __device__ static uint32_t pack(S lo, S hi) {
    return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
  }
  __device__ static A load_a(const S* s, int ld, int lane) {
    const int g = lane / 4, t = lane % 4;
    return A{{pair(s + g * ld + 2 * t), pair(s + (g + 8) * ld + 2 * t),
              pair(s + g * ld + 2 * t + 8), pair(s + (g + 8) * ld + 2 * t + 8)}};
  }
  static constexpr int X_PARTS = 1;
  __device__ static void put_x(float v, S* p, int) { *p = __float2bfloat16(v); }
  __device__ static A load_x(const S* s, int ld, int, int lane) { return load_a(s, ld, lane); }
  __device__ static B load_b(const S* s, int ld, int lane) {
    const int g = lane / 4, t = lane % 4;
    return B{{pack(s[2 * t * ld + g], s[(2 * t + 1) * ld + g]),
              pack(s[(2 * t + 8) * ld + g], s[(2 * t + 9) * ld + g])}};
  }
  __device__ static B load_bt(const S* s, int ld, int lane) {
    const int g = lane / 4, t = lane % 4;
    return B{{pair(s + g * ld + 2 * t), pair(s + g * ld + 2 * t + 8)}};
  }
  __device__ static void mma(float (&d)[4], const A& a, const B& b) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(b.r[0]), "r"(b.r[1]));
  }
  // one term: ds is not touched (see Mma<float>::mma_row)
  template <int NJ>
  __device__ static void mma_row(float (&)[NJ][4], float (&db)[NJ][4], const A& a,
                                 const B (&b)[NJ]) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) mma(db[j], a, b[j]);
  }
};

__device__ __forceinline__ void zero(float (&d)[4]) { d[0] = d[1] = d[2] = d[3] = 0.f; }
__device__ __forceinline__ void add(float (&acc)[4], const float (&d)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += d[e];
}

}  // namespace
