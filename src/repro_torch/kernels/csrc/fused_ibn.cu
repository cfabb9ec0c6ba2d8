// Fused inverted bottleneck  out = act(x @ w1) @ w2  (gated:
// (act(x @ wg) * (x @ w1)) @ w2)  for Hopper (sm_90a).
//
// Replaces the TPU kernel `fused_ibn` (`_ibn_kernel`, `_ibn_gated_kernel`,
// `_mask_ragged_f`) of src/repro/kernels/fused_ibn.py.  There the F axis is
// a sequential grid dimension and the output accumulator is a scratch that
// survives from one grid step to the next.  Blocks of a CUDA grid share
// nothing, so here one block owns BM rows and loops over the F tiles
// itself: a (BM, BF) tile of the expanded intermediate T is produced into
// shared memory, activated, zeroed past the true F (after the activation,
// so an activation with act(0) != 0 stays right), rounded to the input
// type, contracted into a register accumulator and dropped.  T never
// reaches device memory.
//
// Bound on this card: operations.  At the widths of EdgeNeXt-S the two
// products cost more time at the tensor cores' rate than x, w1, w2 and out
// cost at the memory rate.  This first version does its products as float32
// multiply-adds on the CUDA cores (exact float32, which the 3e-5 tolerance
// against the reference needs and TF32 would not give); it therefore sits
// far from the card's tensor-core bound, and says so in PERF.md.
//
// Shapes: any M, D, F, Do.  Every load is a scalar, bounds-checked load, so
// the odd D that a folded bias row gives (49, 97, 161, 305) needs no
// alignment.  Do wider than one block's accumulator (16 * NJ columns) is
// split over blockIdx.y; each such block recomputes T.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;   // rows per block
constexpr int BF = 64;   // columns of T per tile
constexpr int DK = 16;   // slab of D per step of the first product
constexpr int FK = 16;   // slab of BF per step of the second product
constexpr int NT = 256;  // threads: 16 (columns) x 16 (row groups of 4)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* p) { *p = __float2bfloat16(v); }
// round to the working type and back: the rounding point of T
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

// 0 = gelu (tanh form), 1 = silu, 2 = relu^2
__device__ __forceinline__ float activate(float v, int act) {
  if (act == 0) {
    const float u = 0.7978845608028654f * (v + 0.044715f * v * v * v);
    return 0.5f * v * (1.f + tanhf(u));
  }
  if (act == 1) return v / (1.f + expf(-v));
  const float r = fmaxf(v, 0.f);
  return r * r;
}

template <typename T, bool GATED, int NJ>
__global__ void __launch_bounds__(NT)
ibn_kernel(const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ wg,
           const T* __restrict__ w2, T* __restrict__ out, int M, int D, int F, int Do, int act) {
  constexpr int DOT = 16 * NJ;  // output columns per block
  __shared__ float xs[BM][DK];
  __shared__ __align__(16) float w1s[DK][BF];
  __shared__ __align__(16) float wgs[GATED ? DK : 1][BF];
  __shared__ float ts[BM][BF];
  __shared__ float w2s[FK][DOT];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * DOT;

  float acc[4][NJ];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[r][j] = 0.f;

  for (int f0 = 0; f0 < F; f0 += BF) {
    // ---- first product: T tile (BM, BF), 4x4 per thread, D in slabs ----
    float up[4][4], gt[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) { up[r][c] = 0.f; gt[r][c] = 0.f; }

    for (int k0 = 0; k0 < D; k0 += DK) {
      for (int i = tid; i < BM * DK; i += NT) {
        const int r = i / DK, k = i % DK;
        const long long gm = m0 + r;
        const int gk = k0 + k;
        xs[r][k] = (gm < M && gk < D) ? to_f32(x[gm * D + gk]) : 0.f;
      }
      for (int i = tid; i < DK * BF; i += NT) {
        const int k = i / BF, f = i % BF;
        const int gk = k0 + k, gf = f0 + f;
        const bool ok = gk < D && gf < F;
        w1s[k][f] = ok ? to_f32(w1[(long long)gk * F + gf]) : 0.f;
        if (GATED) wgs[k][f] = ok ? to_f32(wg[(long long)gk * F + gf]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < DK; ++k) {
        const float4 wv = *reinterpret_cast<const float4*>(&w1s[k][tx * 4]);
        const float wa[4] = {wv.x, wv.y, wv.z, wv.w};
        float xv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) xv[r] = xs[ty * 4 + r][k];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) up[r][c] += xv[r] * wa[c];
        if (GATED) {
          const float4 gv = *reinterpret_cast<const float4*>(&wgs[k][tx * 4]);
          const float ga[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) gt[r][c] += xv[r] * ga[c];
        }
      }
      __syncthreads();
    }

    // ---- activation, ragged-F mask after it, rounding to the input type ----
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float t = GATED ? activate(gt[r][c], act) * up[r][c] : activate(up[r][c], act);
        if (f0 + tx * 4 + c >= F) t = 0.f;
        ts[ty * 4 + r][tx * 4 + c] = round_to(t, x);
      }

    // ---- second product: acc (BM, DOT) += T tile @ w2 tile, BF in slabs ----
    for (int fk0 = 0; fk0 < BF && f0 + fk0 < F; fk0 += FK) {
      for (int i = tid; i < FK * DOT; i += NT) {
        const int fk = i / DOT, n = i % DOT;
        const int gf = f0 + fk0 + fk, gn = n0 + n;
        w2s[fk][n] = (gf < F && gn < Do) ? to_f32(w2[(long long)gf * Do + gn]) : 0.f;
      }
      __syncthreads();  // w2s ready; on the first slab also ts
#pragma unroll
      for (int fk = 0; fk < FK; ++fk) {
        float tv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) tv[r] = ts[ty * 4 + r][fk0 + fk];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float wv = w2s[fk][tx + 16 * j];
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r][j] += tv[r] * wv;
        }
      }
      __syncthreads();  // before w2s, and then ts, are written again
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const long long gm = m0 + ty * 4 + r;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < Do) from_f32(acc[r][j], out + gm * Do + gn);
    }
  }
}

template <typename T, bool GATED>
int launch(const void* x, const void* w1, const void* wg, const void* w2, void* out,
           long long M, int D, int F, int Do, int act, cudaStream_t s) {
  const unsigned gm = (unsigned)((M + BM - 1) / BM);
#define REPRO_IBN_LAUNCH(NJ)                                                          \
  ibn_kernel<T, GATED, NJ><<<dim3(gm, (Do + 16 * NJ - 1) / (16 * NJ)), NT, 0, s>>>(   \
      (const T*)x, (const T*)w1, (const T*)wg, (const T*)w2, (T*)out, (int)M, D, F, Do, act)
  if (Do <= 16 * 3) REPRO_IBN_LAUNCH(3);
  else if (Do <= 16 * 6) REPRO_IBN_LAUNCH(6);
  else if (Do <= 16 * 10) REPRO_IBN_LAUNCH(10);
  else REPRO_IBN_LAUNCH(19);
#undef REPRO_IBN_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; act: 0 gelu-tanh, 1 silu, 2 relu^2;
// wg == nullptr selects the ungated form.  Returns cudaGetLastError().
extern "C" int repro_fused_ibn(const void* x, const void* w1, const void* wg, const void* w2,
                               void* out, long long M, int D, int F, int Do, int act, int dtype,
                               void* stream) {
  if (M <= 0 || M > 2147483647LL || D <= 0 || F <= 0 || Do <= 0 || act < 0 || act > 2 ||
      (Do + 303) / 304 > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return wg ? launch<float, true>(x, w1, wg, w2, out, M, D, F, Do, act, s)
              : launch<float, false>(x, w1, wg, w2, out, M, D, F, Do, act, s);
  if (dtype == 1)
    return wg ? launch<__nv_bfloat16, true>(x, w1, wg, w2, out, M, D, F, Do, act, s)
              : launch<__nv_bfloat16, false>(x, w1, wg, w2, out, M, D, F, Do, act, s);
  return (int)cudaErrorInvalidValue;
}
