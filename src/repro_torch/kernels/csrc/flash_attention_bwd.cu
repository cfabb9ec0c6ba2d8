// The backward of flash attention for Hopper (sm_90a): dq, dk and dv of
// out = softmax(mask(q k^T * scale)) v from q, k, v, out, dout and the
// forward's float32 log-sum-exp of each row (csrc/flash_attention.cu writes
// it where the caller asks for it).
//
// Replaces `_flash_bwd` of src/repro/models/attention.py (jnp under the
// `flash_attention` custom_vjp; the TPU package has no Pallas backward).  Its
// function, not its blocking:
//   delta = rowsum(dO . O);  P = exp(S * scale - lse), S masked to NEG_INF;
//   dP = dO V^T;  dS = P (dP - delta);
//   dQ = dS K * scale;  dK = dS^T Q * scale;  dV = P^T dO.
// Masks `causal` (q_pos >= k_pos), `window` (q_pos - k_pos < window) and the
// bounds, as the forward's.  A row with no unmasked key has lse = NEG_INF and
// so P = 1 on its masked keys, which is what the reference's formulas give.
// Scores, P, dP, dS and every sum are float32; P and dS are rounded to the
// input type where they enter a tensor-core product (bfloat16: one term;
// float32: 3xTF32, mma.cuh), and dq, dk, dv are stored in the input type.
//
// Bound on this card: bytes at the trained shapes (q, k, v, out, dout read
// once, dq, dk, dv written once, 2 bytes each in bf16: 4 x 32 x 512 x 80 moves
// 84 MB, 25 us at 3.35 TB/s, against 13.6 us of bf16 products under the
// causal mask).  The design takes the reference's split, which needs no
// atomics:
//   1. attn_bwd_delta_kernel: delta = rowsum(dO . O) in float32, a warp a
//      row;
//   2. attn_bwd_dkv_kernel: a block of 4 warps owns 64 keys of one (batch,
//      head), a warp 16 of them, and walks the 64-query tiles that its keys can see
//      (the tiles the causal or window mask hides whole are skipped, as the
//      forward's KV loop skips them); it holds dK and dV of its keys in
//      float32 registers and recomputes S^T and dP^T of each tile on the
//      tensor cores;
//   3. attn_bwd_dq_kernel: a block owns 64 queries and walks the key tiles
//      they can see, dQ in float32 registers.
// Each output element is summed by one thread in a fixed order, so two calls
// give the same bits.  Tiles come to shared memory by cp.async (zero-filled
// past the bounds and past D), one stage at a time: a plain kernel, with no
// double buffering, ldmatrix, wgmma or TMA yet (ROADMAP queue 2).  D is taken
// in chunks of DC columns (one compiled instance each; the registers a
// thread keeps grow with DC): the scores' depth chunk by chunk, the output
// columns one chunk a block over blockIdx.z (a wider D recomputes S and dP
// in every output chunk).  D <= 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "cp_async.cuh"
#include "mma.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int TQ = 64;     // queries of a tile
constexpr int TK = 64;     // keys of a tile
constexpr int NT = 128;    // threads of a dkv / dq block: 4 warps, 16 rows each
constexpr int D_MAX = 256;
constexpr int MAX_DEVICES = 64;
constexpr int SMEM_OPT_IN = 220 * 1024;

// Columns of D a block takes at once (a compiled instance each): all of D up
// to 80, else chunks of 128 (bfloat16) or 64 (float32, whose 3xTF32
// temporaries need the registers).
template <typename T>
__host__ __device__ inline int bwd_chunk(int D) {
  if (D <= 64) return 64;
  if (D <= 80) return 80;
  return sizeof(T) == 2 ? 128 : 64;
}
// Row stride (elements) of a staged tile: 16-byte rows for cp.async, padded
// as mma.cuh's A rows are.
template <typename T, int DC>
constexpr int bwd_ld = DC + Mma<T>::PAD_A;
// Four tiles of 64 rows (two A operands, two B operands), then two float32
// rows of 64 (the dkv block's lse and delta of its query tile).
template <typename T, int DC>
constexpr size_t bwd_smem = sizeof(T) * 4 * 64 * bwd_ld<T, DC> + 2 * 64 * sizeof(float);

// Whether some query row sees no key at all (its P is then 1 on the masked
// keys, and no tile may be skipped): only under a window.
__device__ __forceinline__ bool some_row_empty(int Sq, int Sk, int has_window, int window) {
  return has_window && (window <= 0 || (long long)Sq - 1 >= (long long)Sk + window - 1);
}

__device__ __forceinline__ bool visible(int qp, int kp, int causal, int has_window, int window) {
  return (!causal || qp >= kp) && (!has_window || qp - kp < window);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// two neighbouring outputs of a row; `pair` where both exist and the address
// is aligned for one store of both
__device__ __forceinline__ void store2(float a, float b, float* p, bool pair) {
  if (pair) *reinterpret_cast<float2*>(p) = make_float2(a, b);
  else *p = a;
}
__device__ __forceinline__ void store2(float a, float b, __nv_bfloat16* p, bool pair) {
  if (pair) *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  else *p = __float2bfloat16(a);
}

// rows [row0, row0 + 64) of src [rows][D] (those past `rows` zero), chunk c's
// DC columns (those past D zero), into dst [64][ld], by all NT threads
template <typename T, int DC>
__device__ __forceinline__ void stage(typename Mma<T>::S* dst, const T* src_t, int row0, int rows,
                                      int c, int D, bool vec) {
  using R = std::conditional_t<sizeof(T) == 4, uint32_t, uint16_t>;
  constexpr int V = 16 / sizeof(T), CPR = DC * (int)sizeof(T) / 16, ld = bwd_ld<T, DC>;
  const R* src = reinterpret_cast<const R*>(src_t);
  const int c0 = c * DC, c1 = min(D, c0 + DC);
#pragma unroll 4
  for (int i = threadIdx.x; i < 64 * CPR; i += NT) {
    const int r = i / CPR, col = (i % CPR) * V;
    copy_chunk<R, V>(dst + r * ld + col, src + (long long)(row0 + r) * D + c0 + col,
                     row0 + r < rows ? (long long)(c1 - c0 - col) : 0, vec, src);
  }
}

// acc[j] (+)= A_rows B_j^T over one depth chunk: A is this warp's 16 rows of
// a [64][ld] tile, B_j the 8 rows 8j.. of another, both [row][depth]; nks
// mma steps of depth
template <typename T, int DC>
__device__ __forceinline__ void rows_by_rows(float (&acc)[8][4], const typename Mma<T>::S* a,
                                             const typename Mma<T>::S* b, int nks, int lane) {
  using MM = Mma<T>;
  constexpr int ld = bwd_ld<T, DC>, NKS = DC / MM::K;
#pragma unroll
  for (int kk = 0; kk < NKS; ++kk) {
    if (kk >= nks) break;
    const typename MM::A af = MM::load_a(a + kk * MM::K, ld, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      MM::mma(acc[j], af, MM::load_bt(b + j * 8 * ld + kk * MM::K, ld, lane));
  }
}

// acc[n] += X B over the 64 inner rows: X [16][64] is this warp's score-shaped
// fragments (x[j] the C fragment of inner columns 8j..8j+7), rounded to the
// input type; B [64][ld] a staged tile [inner][column]; the output columns
// 8n.. for 8n < wz
template <typename T, int DC>
__device__ __forceinline__ void frags_by_tile(float (&acc)[DC / 8][4], const float (&x)[8][4],
                                              const typename Mma<T>::S* b, int wz, int lane) {
  using MM = Mma<T>;
  constexpr int ld = bwd_ld<T, DC>, NO = DC / 8;
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const typename MM::A a{{pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                              pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                              pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                              pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])}};
#pragma unroll
      for (int n = 0; n < NO; ++n)
        if (8 * n < wz) MM::mma(acc[n], a, MM::load_b(b + kk * 16 * ld + 8 * n, ld, lane));
    }
  } else {
    // the A fragment's column t holds inner row 2t and t + 4 row 2t + 1 (the
    // C layout of the scores); B's rows are read in the same order
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const float av[4] = {x[kk][0], x[kk][2], x[kk][1], x[kk][3]};
      typename MM::A a;
      MM::split(av, a.big, a.small);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        if (8 * n >= wz) continue;
        const float* bp = b + (kk * 8 + 2 * t) * ld + 8 * n + g;
        const float bv[2] = {bp[0], bp[ld]};
        typename MM::B bb;
        MM::split(bv, bb.big, bb.small);
        MM::mma(acc[n], a, bb);
      }
    }
  }
}

// delta[row] = sum_d dout[row, d] * out[row, d] in float32: a warp a row,
// lanes over d, then a butterfly (a fixed order)
template <typename T>
__global__ void __launch_bounds__(256)
attn_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                      float* __restrict__ delta, long long rows, int D) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* o = out + row * D;
  const T* d = dout + row * D;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc += to_f32(o[c]) * to_f32(d[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// grid (BH, key tiles, output chunks)
template <typename T, int DC>
__global__ void __launch_bounds__(NT, 1)
attn_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                    int Sq, int Sk, int D, float scale, int causal, int has_window, int window) {
  using MM = Mma<T>;
  using S = typename MM::S;
  constexpr int U = MM::K, NO = DC / 8, ld = bwd_ld<T, DC>, TILE = 64 * ld;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* ks = reinterpret_cast<S*>(smem_raw);
  S* vs = ks + TILE;
  S* qs = vs + TILE;
  S* dos = qs + TILE;
  float* ls = reinterpret_cast<float*>(dos + TILE);
  float* dl = ls + 64;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const long long bh = blockIdx.x;
  const int k0 = blockIdx.y * TK, z = blockIdx.z, nc = (D + DC - 1) / DC;
  const int wz = min(D, (z + 1) * DC) - z * DC;  // this block's output columns
  const T* qb = q + bh * Sq * D;
  const T* dob = dout + bh * Sq * D;
  const T* kb = k + bh * Sk * D;
  const T* vb = v + bh * Sk * D;
  const float* lb = lse + bh * Sq;
  const float* db = delta + bh * Sq;
  constexpr int V = 16 / sizeof(T);
  const bool vec = D % V == 0 &&
                   (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) % 16 == 0;

  // the queries these keys are visible to: q >= k0 under `causal`, q <
  // k_last + window under a window
  const int k_last = min(k0 + TK, Sk) - 1;
  int q_begin = causal ? k0 : 0;
  int q_end = has_window ? (int)min((long long)Sq, (long long)k_last + window) : Sq;
  if (some_row_empty(Sq, Sk, has_window, window)) { q_begin = 0; q_end = Sq; }
  const int qt0 = q_begin / TQ, qt1 = q_end > q_begin ? (q_end + TQ - 1) / TQ : qt0;

  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) zero(dka[n]), zero(dva[n]);
  if (nc == 1 && qt0 < qt1) {  // K and V stay for every query tile
    stage<T, DC>(ks, kb, k0, Sk, 0, D, vec);
    stage<T, DC>(vs, vb, k0, Sk, 0, D, vec);
  }
  for (int qt = qt0; qt < qt1; ++qt) {
    const int q0 = qt * TQ;
    __syncthreads();  // every warp is done with the last tile's q, dO, lse, delta
    if (tid < 64) {
      ls[tid] = q0 + tid < Sq ? lb[q0 + tid] : 0.f;
      dl[tid] = q0 + tid < Sq ? db[q0 + tid] : 0.f;
    }
    // ---- S^T = K Q^T and dP^T = V dO^T over D, chunk by chunk ----
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) zero(s[j]), zero(dp[j]);
    for (int c = 0; c < nc; ++c) {
      if (c > 0) __syncthreads();  // every warp is done with chunk c - 1
      if (nc > 1) {
        stage<T, DC>(ks, kb, k0, Sk, c, D, vec);
        stage<T, DC>(vs, vb, k0, Sk, c, D, vec);
      }
      stage<T, DC>(qs, qb, q0, Sq, c, D, vec);
      stage<T, DC>(dos, dob, q0, Sq, c, D, vec);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      const int nks = (min(D, (c + 1) * DC) - c * DC + U - 1) / U;
      rows_by_rows<T, DC>(s, ks + warp * 16 * ld, qs, nks, lane);
      rows_by_rows<T, DC>(dp, vs + warp * 16 * ld, dos, nks, lane);
    }
    // ---- P^T and dS^T on the fragments: rows are keys, columns queries ----
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * j + 2 * t + (e & 1), qp = q0 + qi;
        const int kp = k0 + warp * 16 + g + 8 * (e >> 1);
        float p = 0.f;
        if (qp < Sq && kp < Sk)
          p = expf((visible(qp, kp, causal, has_window, window) ? s[j][e] * scale : NEG_INF) -
                   ls[qi]);
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - dl[qi]);
      }
    if (nc > 1) {  // this block's output columns of q and dO
      __syncthreads();
      stage<T, DC>(qs, qb, q0, Sq, z, D, vec);
      stage<T, DC>(dos, dob, q0, Sq, z, D, vec);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    // ---- dV += P^T dO, dK += dS^T Q over the tile's queries ----
    frags_by_tile<T, DC>(dva, s, dos, wz, lane);
    frags_by_tile<T, DC>(dka, dp, qs, wz, lane);
  }

  // ---- dk * scale and dv, stored once ----
  const bool pairs = D % 2 == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kp = k0 + warp * 16 + g + 8 * h;
    if (kp >= Sk) continue;
    T* dkr = dk + (bh * Sk + kp) * D + z * DC;
    T* dvr = dv + (bh * Sk + kp) * D + z * DC;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = 8 * n + 2 * t;
      if (col < wz) {
        store2(dka[n][2 * h] * scale, dka[n][2 * h + 1] * scale, dkr + col, pairs && col + 1 < wz);
        store2(dva[n][2 * h], dva[n][2 * h + 1], dvr + col, pairs && col + 1 < wz);
      }
    }
  }
}

// grid (BH, query tiles, output chunks)
template <typename T, int DC>
__global__ void __launch_bounds__(NT, 1)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq, int Sq, int Sk, int D,
                   float scale, int causal, int has_window, int window) {
  using MM = Mma<T>;
  using S = typename MM::S;
  constexpr int U = MM::K, NO = DC / 8, ld = bwd_ld<T, DC>, TILE = 64 * ld;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* qs = reinterpret_cast<S*>(smem_raw);
  S* dos = qs + TILE;
  S* ks = dos + TILE;
  S* vs = ks + TILE;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const long long bh = blockIdx.x;
  // the last query tiles (the most keys under `causal`) are scheduled first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TQ, z = blockIdx.z, nc = (D + DC - 1) / DC;
  const int wz = min(D, (z + 1) * DC) - z * DC;
  const T* qb = q + bh * Sq * D;
  const T* dob = dout + bh * Sq * D;
  const T* kb = k + bh * Sk * D;
  const T* vb = v + bh * Sk * D;
  constexpr int V = 16 / sizeof(T);
  const bool vec = D % V == 0 &&
                   (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) % 16 == 0;

  // this warp's rows g and g + 8: their lse and delta
  float lr[2], dr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qp = q0 + warp * 16 + g + 8 * h;
    lr[h] = qp < Sq ? lse[bh * Sq + qp] : 0.f;
    dr[h] = qp < Sq ? delta[bh * Sq + qp] : 0.f;
  }
  // the keys these queries see (as the forward's KV loop bounds them)
  const int q_last = min(q0 + TQ, Sq) - 1;
  int k_begin = has_window ? max(0, q0 - window + 1) : 0;
  int k_end = causal ? min(Sk, q_last + 1) : Sk;
  if (some_row_empty(Sq, Sk, has_window, window)) { k_begin = 0; k_end = Sk; }
  const int kt0 = k_begin / TK, kt1 = k_end > k_begin ? (k_end + TK - 1) / TK : kt0;

  float dqa[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) zero(dqa[n]);
  if (nc == 1 && kt0 < kt1) {  // q and dO stay for every key tile
    stage<T, DC>(qs, qb, q0, Sq, 0, D, vec);
    stage<T, DC>(dos, dob, q0, Sq, 0, D, vec);
  }
  for (int kt = kt0; kt < kt1; ++kt) {
    const int key0 = kt * TK;
    __syncthreads();  // every warp is done with the last tile's K and V
    // ---- S = Q K^T and dP = dO V^T over D, chunk by chunk ----
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) zero(s[j]), zero(dp[j]);
    for (int c = 0; c < nc; ++c) {
      if (c > 0) __syncthreads();
      if (nc > 1) {
        stage<T, DC>(qs, qb, q0, Sq, c, D, vec);
        stage<T, DC>(dos, dob, q0, Sq, c, D, vec);
      }
      stage<T, DC>(ks, kb, key0, Sk, c, D, vec);
      stage<T, DC>(vs, vb, key0, Sk, c, D, vec);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      const int nks = (min(D, (c + 1) * DC) - c * DC + U - 1) / U;
      rows_by_rows<T, DC>(s, qs + warp * 16 * ld, ks, nks, lane);
      rows_by_rows<T, DC>(dp, dos + warp * 16 * ld, vs, nks, lane);
    }
    // ---- dS on the fragments: rows are queries, columns keys ----
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int qp = q0 + warp * 16 + g + 8 * h, kp = key0 + 8 * j + 2 * t + (e & 1);
        float p = 0.f;
        if (qp < Sq && kp < Sk)
          p = expf((visible(qp, kp, causal, has_window, window) ? s[j][e] * scale : NEG_INF) -
                   lr[h]);
        s[j][e] = p * (dp[j][e] - dr[h]);
      }
    if (nc > 1) {  // this block's output columns of K
      __syncthreads();
      stage<T, DC>(ks, kb, key0, Sk, z, D, vec);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    // ---- dQ += dS K over the tile's keys ----
    frags_by_tile<T, DC>(dqa, s, ks, wz, lane);
  }

  const bool pairs = D % 2 == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qp = q0 + warp * 16 + g + 8 * h;
    if (qp >= Sq) continue;
    T* dqr = dq + (bh * Sq + qp) * D + z * DC;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = 8 * n + 2 * t;
      if (col < wz)
        store2(dqa[n][2 * h] * scale, dqa[n][2 * h + 1] * scale, dqr + col, pairs && col + 1 < wz);
    }
  }
}

// the dynamic shared memory past the 48 KiB a launch gets without asking:
// opted in once per kernel and device
template <typename K>
cudaError_t opt_in(K kern, bool (&done)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_OPT_IN);
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return err;
}

template <typename T, int DC>
int launch_at(const void* q, const void* k, const void* v, const void* out, const void* dout,
              const float* lse, float* delta, void* dq, void* dk, void* dv, long long BH, int Sq,
              int Sk, int D, float scale, int causal, int has_window, int window, cudaStream_t s) {
  const unsigned gq = (Sq + TQ - 1) / TQ, gk = (Sk + TK - 1) / TK, gz = (D + DC - 1) / DC;
  const long long rows = BH * Sq;
  if (BH > 2147483647LL || gq > 65535u || gk > 65535u || (rows + 7) / 8 > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem = bwd_smem<T, DC>;
  static_assert(smem <= (size_t)SMEM_OPT_IN, "shared memory of a block");
  static bool dkv_opted[MAX_DEVICES] = {}, dq_opted[MAX_DEVICES] = {};
  cudaError_t err = opt_in(attn_bwd_dkv_kernel<T, DC>, dkv_opted);
  if (err == cudaSuccess) err = opt_in(attn_bwd_dq_kernel<T, DC>, dq_opted);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_delta_kernel<T><<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(
      (const T*)out, (const T*)dout, delta, rows, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dkv_kernel<T, DC><<<dim3((unsigned)BH, gk, gz), NT, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dk, (T*)dv, Sq, Sk,
      D, scale, causal, has_window, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dq_kernel<T, DC><<<dim3((unsigned)BH, gq, gz), NT, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dq, Sq, Sk, D, scale,
      causal, has_window, window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const float* lse, float* delta, void* dq, void* dk, void* dv, long long BH, int Sq,
           int Sk, int D, float scale, int causal, int has_window, int window, cudaStream_t s) {
  const int dc = bwd_chunk<T>(D);
#define REPRO_BWD(DC)                                                                         \
  if (dc == DC)                                                                               \
    return launch_at<T, DC>(q, k, v, out, dout, lse, delta, dq, dk, dv, BH, Sq, Sk, D, scale, \
                            causal, has_window, window, s);
  REPRO_BWD(64)
  REPRO_BWD(80)
  if constexpr (sizeof(T) == 2) {
    REPRO_BWD(128)
  }
#undef REPRO_BWD
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, out, dout, dq: [BH, Sq, D]; k, v, dk, dv: [BH, Sk, D]; lse: [BH, Sq]
// float32 (the forward's); delta: [BH, Sq] float32 scratch; all dense, D <=
// 256.  dtype: 0 = float32, 1 = bfloat16.  Three launches on `stream` (delta,
// dK / dV, dQ), nothing synchronised.  Returns the first CUDA error of the
// launches, or cudaErrorInvalidValue for arguments it does not take.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* out, const void* dout, const void* lse,
                                         void* delta, void* dq, void* dk, void* dv, long long BH,
                                         int Sq, int Sk, int D, float scale, int causal,
                                         int has_window, int window, int dtype, void* stream) {
  if (BH <= 0 || Sq <= 0 || Sk <= 0 || D <= 0 || D > D_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  float* dl = (float*)delta;
  if (dtype == 0)
    return launch<float>(q, k, v, out, dout, l, dl, dq, dk, dv, BH, Sq, Sk, D, scale, causal,
                         has_window, window, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, dout, l, dl, dq, dk, dv, BH, Sq, Sk, D, scale,
                                 causal, has_window, window, s);
  return (int)cudaErrorInvalidValue;
}
