// Online-softmax (flash) attention, forward only, for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_attention` / `_flash_kernel` of
// src/repro/kernels/flash_attention.py.  There the KV axis is a sequential
// grid dimension and the running (m, l, acc) are three scratches that
// survive from one grid step to the next.  Here one block owns a tile of BQ
// query rows of one (batch, head) and loops over the KV tiles itself, with
// m and l in registers and acc spread over the threads' registers.  The
// [Sq, Sk] score matrix never reaches device memory.
//
// Same semantics as the TPU kernel: scores in float32 from q * scale;
// masks `causal` (q_pos >= k_pos), `window` (q_pos - k_pos < window) and
// k_pos < Sk; NEG_INF = -1e30 is finite, so a row whose every key is masked
// softmaxes to uniform over the Sk keys, as the plain version does; p is
// rounded to v's type before P @ V; l == 0 divides by 1.  KV tiles that
// causal/window masking empties for the whole query tile are skipped,
// unless a row of the tile has no unmasked key at all (it then needs
// every tile for its uniform average).
//
// Bound on this card: bytes (q, k, v read once, out written once) at the
// shapes EdgeNeXt's XCA gives, where the sequence is the 24..76 channels
// of a head and the head dim D is the token count, up to 1024.  A
// [S, 1024] float32 tile of q, k and v together does not fit shared
// memory, and a [BQ, 1024] accumulator does not fit one thread.  So:
//   * Q K^T loops D in slabs of DS columns staged in shared memory; warp w
//     owns query rows w and w + 8, lane i owns key i of the KV tile
//     (BK = 32 = one warp), so the row max and row sum are warp shuffles;
//   * the output's D is spread over the block: thread t owns columns
//     t, t + 256, ... (NJ of them) of all BQ rows, reads each v element
//     straight from device memory (coalesced, used by this thread alone)
//     and p from shared memory;
//   * D wider than 256 * NJ is split over blockIdx.z; each such block
//     recomputes the scores.  D is a runtime argument of any size.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 16;    // query rows per block (2 per warp)
constexpr int BK = 32;    // keys per KV tile (1 per lane)
constexpr int DS = 128;   // slab of D per step of Q K^T
constexpr int NT = 256;   // threads
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* p) { *p = __float2bfloat16(v); }
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int NJ>
__global__ void __launch_bounds__(NT)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, int Sq, int Sk, int D, float scale, int causal,
             int has_window, int window) {
  __shared__ float qs[BQ][DS];
  __shared__ float ks[BK][DS + 1];
  __shared__ float ps[BQ][BK];
  __shared__ float alphas[BQ];
  __shared__ float ls[BQ];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int dz = blockIdx.z * (NT * NJ);
  const T* qb = q + bh * Sq * D;
  const T* kb = k + bh * Sk * D;
  const T* vb = v + bh * Sk * D;

  // KV range this query tile can see; all of it if some row sees nothing
  const int q_last = min(q0 + BQ, Sq) - 1;
  int k_begin = has_window ? max(0, q0 - window + 1) : 0;
  int k_end = causal ? min(Sk, q_last + 1) : Sk;
  bool some_row_empty = k_begin >= k_end;
  for (int qp = q0; qp <= q_last; ++qp) {
    const int lo = has_window ? max(0, qp - window + 1) : 0;
    const int hi = causal ? min(Sk - 1, qp) : Sk - 1;
    some_row_empty |= lo > hi;
  }
  if (some_row_empty) { k_begin = 0; k_end = Sk; }

  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};
  float acc[BQ][NJ];
#pragma unroll
  for (int r = 0; r < BQ; ++r)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[r][j] = 0.f;

  for (int kk0 = (k_begin / BK) * BK; kk0 < k_end; kk0 += BK) {
    // ---- scores of rows (warp, warp + 8) against key `lane` ----
    float s[2] = {0.f, 0.f};
    for (int d0 = 0; d0 < D; d0 += DS) {
      for (int i = tid; i < BQ * DS; i += NT) {
        const int r = i / DS, d = i % DS;
        const bool ok = q0 + r < Sq && d0 + d < D;
        qs[r][d] = ok ? to_f32(qb[(long long)(q0 + r) * D + d0 + d]) * scale : 0.f;
      }
      for (int i = tid; i < BK * DS; i += NT) {
        const int r = i / DS, d = i % DS;
        const bool ok = kk0 + r < Sk && d0 + d < D;
        ks[r][d] = ok ? to_f32(kb[(long long)(kk0 + r) * D + d0 + d]) : 0.f;
      }
      __syncthreads();
      const int dmax = min(DS, D - d0);
      for (int d = 0; d < dmax; ++d) {
        const float kv = ks[lane][d];
        s[0] += qs[warp][d] * kv;
        s[1] += qs[warp + 8][d] * kv;
      }
      __syncthreads();
    }

    // ---- mask, online softmax; p goes to shared memory ----
    const int kp = kk0 + lane;
    const bool in_range = kp < Sk;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp + 8 * h;
      const int qp = q0 + r;
      const bool ok = in_range && (!causal || qp >= kp) && (!has_window || qp - kp < window);
      const float sv = ok ? s[h] : NEG_INF;
      const float m_new = fmaxf(m_run[h], warp_max(sv));
      const float p = in_range ? expf(sv - m_new) : 0.f;  // keys past Sk do not exist
      const float alpha = expf(m_run[h] - m_new);
      l_run[h] = l_run[h] * alpha + warp_sum(p);
      m_run[h] = m_new;
      ps[r][lane] = round_to(p, v);
      if (lane == 0) alphas[r] = alpha;
    }
    __syncthreads();

    // ---- acc = acc * alpha + P @ V; thread owns columns dz + tid + NT * j ----
#pragma unroll
    for (int r = 0; r < BQ; ++r) {
      const float a = alphas[r];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[r][j] *= a;
    }
    const int nk = min(BK, Sk - kk0);
    for (int kk = 0; kk < nk; ++kk) {
      float vv[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = dz + tid + NT * j;
        vv[j] = d < D ? to_f32(vb[(long long)(kk0 + kk) * D + d]) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < BQ; ++r) {
        const float pv = ps[r][kk];
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[r][j] += pv * vv[j];
      }
    }
    __syncthreads();  // before ps and alphas are written again
  }

  if (lane == 0) {
    ls[warp] = l_run[0];
    ls[warp + 8] = l_run[1];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < BQ; ++r) {
    if (q0 + r >= Sq) continue;
    const float l = ls[r] == 0.f ? 1.f : ls[r];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = dz + tid + NT * j;
      if (d < D) from_f32(acc[r][j] / l, out + (bh * Sq + q0 + r) * D + d);
    }
  }
}

}  // namespace

// q: [BH, Sq, D], k, v: [BH, Sk, D], out: [BH, Sq, D], all dense.
// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError().
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     long long BH, int Sq, int Sk, int D, float scale, int causal,
                                     int has_window, int window, int dtype, void* stream) {
  if (BH <= 0 || BH > 2147483647LL || Sq <= 0 || Sk <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const int nj = D <= NT ? 1 : (D <= 2 * NT ? 2 : 4);
  const unsigned gy = (Sq + BQ - 1) / BQ, gz = (D + NT * nj - 1) / (NT * nj);
  if (gy > 65535u || gz > 65535u) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)BH, gy, gz);
  cudaStream_t s = (cudaStream_t)stream;
#define REPRO_FLASH_LAUNCH(T, NJ)                                                     \
  flash_kernel<T, NJ><<<grid, NT, 0, s>>>((const T*)q, (const T*)k, (const T*)v, (T*)out, \
                                          Sq, Sk, D, scale, causal, has_window, window)
  if (dtype == 0) {
    if (nj == 1) REPRO_FLASH_LAUNCH(float, 1);
    else if (nj == 2) REPRO_FLASH_LAUNCH(float, 2);
    else REPRO_FLASH_LAUNCH(float, 4);
  } else if (dtype == 1) {
    if (nj == 1) REPRO_FLASH_LAUNCH(__nv_bfloat16, 1);
    else if (nj == 2) REPRO_FLASH_LAUNCH(__nv_bfloat16, 2);
    else REPRO_FLASH_LAUNCH(__nv_bfloat16, 4);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef REPRO_FLASH_LAUNCH
  return (int)cudaGetLastError();
}
