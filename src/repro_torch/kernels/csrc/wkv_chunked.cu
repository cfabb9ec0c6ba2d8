// Chunked RWKV-6 WKV recurrence from a zero state, for Hopper (sm_90a).
//
// Replaces the TPU kernel `wkv_chunked` (`_wkv_kernel`) of
// src/repro/kernels/rwkv_chunk.py.  Per chunk of C tokens, with
// b = cumsum(logw) and b_prev = b - logw (the cumsum up to t - 1):
//
//   out[t]   = (r[t] * e^{b_prev[t]}) @ S + sum_{s<t} A[t,s] v[s] + (sum_k r u k)[t] v[t]
//   A[t,s]   = sum_k r[t,k] k[s,k] e^{b_prev[t,k] - b[s,k]}                 (s < t)
//   S       <- e^{b_C} * S + (k * e^{b_C - b})^T @ v
//
// Every exponent is <= 0 (logw <= 0), so nothing overflows and nothing is
// clamped.  On the TPU the grid runs (bh, chunk) in order and carries S in
// VMEM scratch across the chunk axis, and a [C, C, K] decay tensor (1 MiB at
// C = K = 64) is built in VMEM.  Here:
//
// - Blocks run in no order, so each block loops over the chunks itself with
//   S in shared memory.  Column v of out and of S depends only on column v
//   of v, so the grid is (bh, V tiles of BV = 32 columns), one column a
//   lane: 64 blocks at RWKV-6 B = 1 (32 heads x V = 64), 256 at B = 4, and
//   80 for RecurrentGemma's lowered bh = 1, V = 2560.  Each V tile
//   recomputes the score matrix A: the recompute factor is ceil(V / 32),
//   2 at V = 64 (80 at V = 2560, where K = 1 makes A cheap).
// - A is never stored whole: it is built 64 x 64 (t rows x s rows) at a
//   time in shared memory, one exp per (t, s, k) term as the reference
//   writes it (no factoring of e^{b_prev[t] - b_ref} e^{b_ref - b[s]}),
//   and consumed at once by A @ v into registers.  Masked (s >= t) terms
//   are skipped, not computed.
// - Shared memory versus the chunk: k, b (with a leading zero row, so
//   b_prev[t] = bz[t]) and the V tile of v are held for the whole chunk;
//   r and the scores are held for one 64-row tile of t at a time.  At
//   C = 256, K = 64 that is 208 KB, under the 227 KB a block may have;
//   the wrapper (`rwkv_chunk.smem_bytes`) raises above that.  So the t
//   rows of a chunk are tiled (64 at a time); the chunk itself is never
//   split: S is updated once per chunk, as the chunk length says.
// - Ragged T and any C (not only powers of two): C is a run-time argument;
//   the last chunk holds n = T - c0 < C live rows and only those are read,
//   summed over and written.  No pad copy.  That equals the reference's
//   padded tail, which is recurrence-neutral (r = k = logw = 0).
// - Types: r, k, v (and out) float32 or bfloat16; logw and u float32 or
//   bfloat16, each with its own code.  Every input is converted to float32
//   on load and all sums are float32 on the CUDA cores (no tensor cores:
//   the float32 case is held to 2e-4).  The final state is float32.
//
// Bound on this card: per chunk the work is 2 C K V (inter, state) plus
// C^2 (K + V) (scores, A @ v) multiply-adds against (3 K + 2 V) x C values
// read and written; at RWKV-6's served shape (BH = 128, T = 512, K = V = 64,
// C = 64, bf16 r/k/v) that is ~2.1 GFLOP against ~52 MB, bytes-bound at
// ~16 us on paper.  This kernel is bound instead by the C^2 K / 2 exps and
// the shared-memory loads of the score loop (two broadcast loads, one
// conflict-free load pair and one exp per term, on 256 threads) and by the
// serial chunk loop of a block; PERF.md has its times against the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;               // threads: 8 warps
constexpr int TR = 64;                // t rows of an output / score tile
constexpr int TS = 64;                // s rows of a score tile
constexpr int BV = 32;                // V columns a block owns, one a lane
constexpr int SMEM_LIMIT = 232448;    // bytes of shared memory a block may have

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* p) { *p = __float2bfloat16(v); }

// logw and u: 0 = float32, 1 = bfloat16 (the code is uniform over the grid)
__device__ __forceinline__ float load_any(const void* p, long long i, int code) {
  return code == 0 ? static_cast<const float*>(p)[i]
                   : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

// Offsets, in floats, of the shared-memory arrays.  Rows of K values are
// padded to K + 1 so that 32 lanes reading 32 consecutive rows hit 32 banks.
struct Layout {
  int kp, ast;                          // row strides: [.][K + 1], scores [.][max(K, TS) + 1]
  int k_s, bz, v_s, r_s, a_s, s_s, u_s, d_s, total;
};

__host__ __device__ inline Layout layout(int C, int K) {
  Layout m;
  m.kp = K + 1;
  m.ast = (K > TS ? K : TS) + 1;
  int o = 0;
  m.k_s = o; o += C * m.kp;             // k of the chunk, then k * e^{b_C - b}
  m.bz = o;  o += (C + 1) * m.kp;       // bz[0] = 0, bz[t + 1] = b[t]
  m.v_s = o; o += C * BV;               // the block's V tile of v
  m.r_s = o; o += TR * m.kp;            // r of one t-row tile
  m.a_s = o; o += TR * m.ast;           // r * e^{b_prev}, then one 64 x 64 score tile
  m.s_s = o; o += K * BV;               // the state's V tile
  m.u_s = o; o += K;
  m.d_s = o; o += TR;                   // sum_k r u k of the t-row tile
  m.total = o;
  return m;
}

template <typename Tin>
__global__ void __launch_bounds__(NT)
wkv_chunked_kernel(const Tin* __restrict__ r, const Tin* __restrict__ k,
                   const Tin* __restrict__ v, const void* __restrict__ logw, int logw_code,
                   const void* __restrict__ u, int u_code, Tin* __restrict__ out,
                   float* __restrict__ state, int T, int K, int V, int C) {
  extern __shared__ float sm[];
  const Layout L = layout(C, K);
  const int KP = L.kp, AST = L.ast;
  float* k_s = sm + L.k_s;
  float* bz = sm + L.bz;
  float* v_s = sm + L.v_s;
  float* r_s = sm + L.r_s;
  float* a_s = sm + L.a_s;
  float* S = sm + L.s_s;
  float* u_s = sm + L.u_s;
  float* d_s = sm + L.d_s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long bh = blockIdx.x;
  const int v0 = blockIdx.y * BV;
  const bool v_live = v0 + lane < V;
  const long long row0 = bh * T;        // first token row of this bh

  for (int i = tid; i < K * BV; i += NT) S[i] = 0.f;
  for (int i = tid; i < K; i += NT) {
    u_s[i] = load_any(u, bh * K + i, u_code);
    bz[i] = 0.f;                        // row 0 of bz stays 0 for every chunk
  }
  __syncthreads();

  for (int c0 = 0; c0 < T; c0 += C) {
    const int n = min(C, T - c0);       // live rows of this chunk
    for (int i = tid; i < n * K; i += NT) {
      const int t = i / K, kk = i - t * K;
      const long long g = (row0 + c0 + t) * K + kk;
      k_s[t * KP + kk] = to_f32(k[g]);
      bz[(t + 1) * KP + kk] = load_any(logw, g, logw_code);
    }
    for (int i = tid; i < n * BV; i += NT) {
      const int t = i / BV, j = i - t * BV;
      v_s[i] = v0 + j < V ? to_f32(v[(row0 + c0 + t) * V + v0 + j]) : 0.f;
    }
    __syncthreads();
    // b = cumsum(logw) over the chunk, in place, one thread per k column
    for (int kk = tid; kk < K; kk += NT) {
      float run = 0.f;
      for (int t = 1; t <= n; ++t) {
        run += bz[t * KP + kk];
        bz[t * KP + kk] = run;
      }
    }
    __syncthreads();

    for (int r0 = 0; r0 < n; r0 += TR) {
      const int rows = min(TR, n - r0);
      // r of the tile, and r * e^{b_prev} into a_s
      for (int i = tid; i < TR * K; i += NT) {
        const int t = i / K, kk = i - t * K;
        float rv = 0.f, rd = 0.f;
        if (t < rows) {
          rv = to_f32(r[(row0 + c0 + r0 + t) * K + kk]);
          rd = rv * expf(bz[(r0 + t) * KP + kk]);
        }
        r_s[t * KP + kk] = rv;
        a_s[t * AST + kk] = rd;
      }
      __syncthreads();
      if (tid < TR) {                   // the current token's bonus
        float d = 0.f;
        if (tid < rows)
          for (int kk = 0; kk < K; ++kk)
            d += r_s[tid * KP + kk] * u_s[kk] * k_s[(r0 + tid) * KP + kk];
        d_s[tid] = d;
      }
      // inter: rows warp + 8 i of the tile, column v0 + lane
      float acc[TR / 8];
#pragma unroll
      for (int i = 0; i < TR / 8; ++i) acc[i] = 0.f;
      for (int kk = 0; kk < K; ++kk) {
        const float sv = S[kk * BV + lane];
#pragma unroll
        for (int i = 0; i < TR / 8; ++i) acc[i] += a_s[(warp + 8 * i) * AST + kk] * sv;
      }
      __syncthreads();                  // a_s is overwritten by the score tiles

      // intra: score tiles of the source rows s0 .. s0 + 63 for s < t
      for (int s0 = 0; s0 <= r0; s0 += TS) {
        const int srows = min(TS, n - s0);
        {
          const int s = tid % TS, tq = tid / TS;   // this thread: column s, rows tq + 4 i
          const int gs = s0 + s;
          unsigned live = 0;
#pragma unroll
          for (int i = 0; i < TR / 4; ++i) {
            const int t = tq + 4 * i;
            if (s < srows && t < rows && gs < r0 + t) live |= 1u << i;
          }
          float a[TR / 4];
#pragma unroll
          for (int i = 0; i < TR / 4; ++i) a[i] = 0.f;
          if (live) {
            for (int kk = 0; kk < K; ++kk) {
              const float ks = k_s[gs * KP + kk];
              const float bs = bz[(gs + 1) * KP + kk];
#pragma unroll
              for (int i = 0; i < TR / 4; ++i) {
                const int t = tq + 4 * i;
                if (live >> i & 1u)
                  a[i] += r_s[t * KP + kk] * ks * expf(bz[(r0 + t) * KP + kk] - bs);
              }
            }
          }
#pragma unroll
          for (int i = 0; i < TR / 4; ++i) a_s[(tq + 4 * i) * AST + s] = a[i];
        }
        __syncthreads();
        for (int s = 0; s < srows; ++s) {
          const float vv = v_s[(s0 + s) * BV + lane];
#pragma unroll
          for (int i = 0; i < TR / 8; ++i) acc[i] += a_s[(warp + 8 * i) * AST + s] * vv;
        }
        __syncthreads();
      }

#pragma unroll
      for (int i = 0; i < TR / 8; ++i) {
        const int t = warp + 8 * i;
        if (t < rows && v_live)
          from_f32(acc[i] + d_s[t] * v_s[(r0 + t) * BV + lane],
                   out + (row0 + c0 + r0 + t) * V + v0 + lane);
      }
    }

    // state: k * e^{b_C - b} in place of k, then S <- e^{b_C} S + k_dec^T v
    for (int i = tid; i < n * K; i += NT) {
      const int s = i / K, kk = i - s * K;
      k_s[s * KP + kk] *= expf(bz[n * KP + kk] - bz[(s + 1) * KP + kk]);
    }
    __syncthreads();
    for (int kk = warp; kk < K; kk += NT / 32) {
      float sv = expf(bz[n * KP + kk]) * S[kk * BV + lane];
      for (int s = 0; s < n; ++s) sv += k_s[s * KP + kk] * v_s[s * BV + lane];
      S[kk * BV + lane] = sv;
    }
    __syncthreads();                    // before the next chunk's loads
  }

  for (int i = tid; i < K * BV; i += NT) {
    const int kk = i / BV, j = i - kk * BV;
    if (v0 + j < V) state[(bh * K + kk) * V + v0 + j] = S[i];
  }
}

constexpr int MAX_DEVICES = 64;

template <typename Tin>
int launch(const void* r, const void* k, const void* v, const void* logw, int logw_code,
           const void* u, int u_code, void* out, void* state, long long BH, int T, int K, int V,
           int C, cudaStream_t s) {
  auto kern = wkv_chunked_kernel<Tin>;
  const size_t smem = (size_t)layout(C, K).total * sizeof(float);
  // raised to the whole limit once per instance and device, not per launch
  static bool opted_in[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES || !opted_in[dev]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return (int)err;
    if (dev < MAX_DEVICES) opted_in[dev] = true;
  }
  const dim3 grid((unsigned)BH, (unsigned)((V + BV - 1) / BV));
  kern<<<grid, NT, smem, s>>>((const Tin*)r, (const Tin*)k, (const Tin*)v, logw, logw_code, u,
                              u_code, (Tin*)out, (float*)state, T, K, V, C);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, logw: [BH, T, K]; v, out: [BH, T, V]; u: [BH, K]; state: [BH, K, V]
// float32, all dense.  dtype is the type of r, k, v and out; logw_dtype and
// u_dtype are each 0 = float32 or 1 = bfloat16.  1 <= C <= T, and the
// shared memory of (C, K) within the limit.  Returns cudaGetLastError().
extern "C" int repro_wkv_chunked(const void* r, const void* k, const void* v, const void* logw,
                                 const void* u, void* out, void* state, long long BH, int T,
                                 int K, int V, int C, int dtype, int logw_dtype, int u_dtype,
                                 void* stream) {
  if (BH <= 0 || BH > 2147483647LL || T <= 0 || K <= 0 || V <= 0 || C <= 0 || C > T ||
      (V + BV - 1) / BV > 65535 || (long long)layout(C, K).total * 4 > SMEM_LIMIT ||
      (logw_dtype != 0 && logw_dtype != 1) || (u_dtype != 0 && u_dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(r, k, v, logw, logw_dtype, u, u_dtype, out, state, BH, T, K, V, C, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, logw, logw_dtype, u, u_dtype, out, state, BH, T, K, V,
                                 C, s);
  return (int)cudaErrorInvalidValue;
}
