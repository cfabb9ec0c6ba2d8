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
// bounds, as the forward's, q_pos = q_offset + the query's row (q_offset >=
// 0: a sequence shard's queries against the keys from the sequence's
// start).  A row with no unmasked key has lse = NEG_INF and
// so P = 1 on its masked keys, which is what the reference's formulas give.
// P is computed as the forward computes it, in the log2 domain: ex2(S *
// scale * log2(e) - lse * log2(e)).  Scores, P, dP, dS and every sum are
// float32; P and dS are rounded to the input type where they enter a
// tensor-core product (bfloat16: one term; float32: 3xTF32, mma.cuh), and
// dq, dk, dv are stored in the input type.
//
// Bound on this card: bytes at the trained shapes (q, k, v, out, dout read
// once, dq, dk, dv written once, 2 bytes each in bf16: 4 x 32 x 512 x 80 moves
// 84 MB, 25 us at 3.35 TB/s, against 13.6 us of bf16 products under the
// causal mask).  What keeps a kernel of this split from it is latency, not
// bytes: tiles waited for before their products, fragments loaded by
// narrow shared loads, a mask test on every score, and blocks that re-read
// each query tile they see.  So the design below overlaps the loads with
// the products, loads fragments by ldmatrix, tests masks only where a tile
// needs them, and widens the dK / dV block where it fits.  It needs no
// atomics (the reference's split):
//   1. attn_bwd_delta_kernel: delta = rowsum(dO . O) in float32, 8 lanes a
//      row by 16-byte loads;
//   2. attn_bwd_dkv_kernel: a block of BK / 16 warps owns BK keys of one
//      (batch, head), a warp 16 of them, with their K and V resident in
//      shared memory (all of D), and walks the 64-query tiles that its keys
//      can see (tiles the causal or window mask hides whole are skipped, as
//      the forward's KV loop skips them).  It holds dK and dV of its keys in
//      float32 registers and recomputes S^T and dP^T of each tile on the
//      tensor cores;
//   3. attn_bwd_dq_kernel: a block of 4 warps owns 64 queries, q and dO
//      resident, and walks the 64-key tiles they can see, dQ in float32
//      registers.
// Both walks run over a ring of ST stages in shared memory, filled by
// cp.async (zero past the bounds and past D): the copies of tile i + ST - 1
// are issued before the products of tile i, as online_kernel's `issue`
// does, so the loads land while the tensor cores work.  bf16 fragments come
// by ldmatrix (ldmatrix.cuh) from rows padded to an odd multiple of 16
// bytes, free of bank conflicts: plain for the A and B^T operands of S^T =
// K Q^T, dP^T = V dO^T (S = Q K^T, dP = dO V^T in the dq kernel), `.trans`
// for the [inner][column] B operands of dV += P^T dO, dK += dS^T Q and dQ +=
// dS K.  float32 keeps mma.cuh's fragment loads.  Each warp sorts each tile
// it visits: one that lies wholly inside the bounds and the masks takes P
// without a mask or bounds test, one that the masks hide whole is skipped
// (unless some row sees no key), and only the diagonal, window-edge and
// ragged tiles test every score.
//
// D is taken in chunks of DC columns (the registers a thread keeps grow with
// DC): the scores' depth chunk by chunk, the output columns one chunk a
// block over blockIdx.z.  A block keeps every chunk of its resident operand
// and rings the other one chunk a stage, taking its own output chunk z last
// so that that stage is still in place for the output products: a wider D
// recomputes S and dP in each output chunk but stages nothing twice.
// PLAN (below; the wrapper's flash_attention_bwd.PLAN mirrors it) sets BK,
// ST and DC for each dtype and width.  Each output element is summed by one
// thread in a fixed order, so two calls give the same bits.  D <= 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "cp_async.cuh"
#include "ldmatrix.cuh"
#include "mma.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int TQ = 64;     // queries of a dkv ring tile and of a dq block
constexpr int TK = 64;     // keys of a dq ring tile
constexpr int NTQ = 128;   // threads of a dq block: 4 warps, 16 queries each
constexpr int D_MAX = 256;
constexpr int MAX_DEVICES = 64;
constexpr int SMEM_OPT_IN = 220 * 1024;

// A row of PLAN: for heads of `dtype` (0 float32, 1 bfloat16) up to `d_max`
// wide (the first row that takes D), `keys` a dkv block (16 a warp), `stages`
// of the ring and the D chunk `chunk`.  Mirrored by PLAN in
// kernels/flash_attention_bwd.py, which a CPU test holds equal to this
// table; set from `python -m repro_torch.profile_flash_attention_bwd`.
struct PlanRow {
  int dtype, d_max, keys, stages, chunk;
};
constexpr PlanRow PLAN[] = {
    // dtype, d_max, keys, stages, chunk
    {1, 64, 128, 2, 64},
    {1, 80, 64, 2, 80},
    {1, 128, 128, 2, 128},
    {1, 256, 128, 2, 128},
    {0, 64, 128, 2, 64},
    {0, 80, 64, 2, 80},
    {0, 128, 64, 2, 64},
    {0, 256, 64, 2, 64},
};
constexpr int PLAN_ROWS = sizeof(PLAN) / sizeof(PLAN[0]);

// Row stride (elements) of a staged chunk: bf16 rows an odd multiple of 16
// bytes (ldmatrix free of bank conflicts), float32 rows 4 mod 32 words
// (mma.cuh's scalar fragment loads free of them).
template <typename T, int DC>
constexpr int bwd_ld = DC + Mma<T>::PAD_A;
// Dynamic shared memory of a dkv block: K and V of its `keys` keys, all nc
// chunks, then `stages` ring stages of a (q, dO) chunk of TQ rows, then
// their lse and delta rows (float32).
template <typename T, int DC>
constexpr size_t dkv_smem(int keys, int stages, int nc) {
  return sizeof(T) * (size_t)bwd_ld<T, DC> * (2 * keys * nc + stages * 2 * TQ) +
         sizeof(float) * (size_t)stages * 2 * TQ;
}
// ... of a dq block: q and dO of its TQ queries, all nc chunks, then the
// ring of (K, V) chunks of TK keys.
template <typename T, int DC>
constexpr size_t dq_smem(int stages, int nc) {
  return sizeof(T) * (size_t)bwd_ld<T, DC> * (2 * TQ * nc + stages * 2 * TK);
}

// Whether some query row sees no key at all (its P is then 1 on the masked
// keys, and no tile may be skipped): only under a window (q_offset >= 0, so
// `causal` leaves every row key 0).
__device__ __forceinline__ bool some_row_empty(int Sq, int Sk, int has_window, int window,
                                               int q_offset) {
  return has_window &&
         (window <= 0 || (long long)q_offset + Sq - 1 >= (long long)Sk + window - 1);
}

__device__ __forceinline__ bool visible(int qp, int kp, int causal, int has_window, int window) {
  return (!causal || qp >= kp) && (!has_window || qp - kp < window);
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

// rows [row0, row0 + R) of src [rows][D] (those past `rows` zero), chunk c's
// DC columns (those past D zero), into dst [R][ld], by the block's NT
// threads; asynchronous where `vec` (commit and wait are the caller's)
template <typename T, int DC, int R, int NT>
__device__ __forceinline__ void stage(typename Mma<T>::S* dst, const T* src_t, int row0, int rows,
                                      int c, int D, bool vec) {
  using Raw = std::conditional_t<sizeof(T) == 4, uint32_t, uint16_t>;
  constexpr int V = 16 / sizeof(T), CPR = DC * (int)sizeof(T) / 16, ld = bwd_ld<T, DC>;
  const Raw* src = reinterpret_cast<const Raw*>(src_t);
  const int c0 = c * DC, c1 = min(D, c0 + DC);
#pragma unroll
  for (int j = 0; j < (R * CPR + NT - 1) / NT; ++j) {
    const int i = threadIdx.x + j * NT;
    if (R * CPR % NT != 0 && i >= R * CPR) break;
    const int r = i / CPR, col = (i % CPR) * V;
    copy_chunk<Raw, V>(dst + r * ld + col, src + (long long)(row0 + r) * D + c0 + col,
                       row0 + r < rows ? (long long)(c1 - c0 - col) : 0, vec, src);
  }
}

// acc[j] (+)= A_rows B_j^T over one depth chunk: A is this warp's 16 rows of
// a staged [.][ld] chunk (at a), B_j the rows 8j..8j+7 of a 64-row one (at
// b), both [row][depth].  The whole chunk's depth, whatever D: the columns
// past D are staged as zeros and add exact zeros, and the unrolled loop
// keeps no branch.  bf16: every fragment by ldmatrix.x4, the step's four B
// loads in flight together before its eight products.
template <typename T, int DC>
__device__ __forceinline__ void rows_by_rows(float (&acc)[8][4], const typename Mma<T>::S* a,
                                             const typename Mma<T>::S* b, int lane) {
  using MM = Mma<T>;
  constexpr int ld = bwd_ld<T, DC>, NKS = DC / MM::K;
  if constexpr (sizeof(T) == 2) {
    // this lane's row addresses (bytes): the A tiles (rows 0-7 / 8-15 by
    // lane bit 3, depth 0-7 / 8-15 by bit 4), the B tiles (rows by bit 4,
    // depth by bit 3)
    const uint32_t aa =
        smem_u32(a) + 2 * (((lane >> 3 & 1) * 8 + (lane & 7)) * ld + (lane >> 4) * 8);
    const uint32_t ba =
        smem_u32(b) + 2 * (((lane >> 4) * 8 + (lane & 7)) * ld + (lane >> 3 & 1) * 8);
#pragma unroll
    for (int kk = 0; kk < NKS; ++kk) {
      typename MM::A af;
      ldsm_x4(af.r, aa + 32 * kk);
      uint32_t r[4][4];
#pragma unroll
      for (int np = 0; np < 4; ++np) ldsm_x4(r[np], ba + 2 * (np * 16 * ld + kk * 16));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        MM::mma(acc[2 * np], af, typename MM::B{{r[np][0], r[np][1]}});
        MM::mma(acc[2 * np + 1], af, typename MM::B{{r[np][2], r[np][3]}});
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < NKS; ++kk) {
      const typename MM::A af = MM::load_a(a + kk * MM::K, ld, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        MM::mma(acc[j], af, MM::load_bt(b + j * 8 * ld + kk * MM::K, ld, lane));
    }
  }
}

// acc[n] += X B over the 64 inner rows: X [16][64] is this warp's score-shaped
// fragments (x[j] the C fragment of inner columns 8j..8j+7), rounded to the
// input type; B [64][ld] a staged chunk [inner][column] (at b); every output
// column of the chunk (those past D are zero and never stored).  bf16: B by
// ldmatrix.x4.trans, up to four column pairs in flight before their
// products.
template <typename T, int DC>
__device__ __forceinline__ void frags_by_tile(float (&acc)[DC / 8][4], const float (&x)[8][4],
                                              const typename Mma<T>::S* b, int lane) {
  using MM = Mma<T>;
  constexpr int ld = bwd_ld<T, DC>, NO = DC / 8;
  if constexpr (sizeof(T) == 2) {
    static_assert(NO % 2 == 0, "bf16 chunks are whole 16-column pairs");
    const uint32_t ba =
        smem_u32(b) + 2 * (((lane >> 3 & 1) * 8 + (lane & 7)) * ld + (lane >> 4) * 8);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const typename MM::A a{{pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                              pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                              pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                              pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])}};
#pragma unroll
      for (int n0 = 0; n0 < NO / 2; n0 += 4) {
        uint32_t r[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (n0 + i < NO / 2) ldsm_x4_t(r[i], ba + 2 * (kk * 16 * ld + (n0 + i) * 16));
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (n0 + i < NO / 2) {
            MM::mma(acc[2 * (n0 + i)], a, typename MM::B{{r[i][0], r[i][1]}});
            MM::mma(acc[2 * (n0 + i) + 1], a, typename MM::B{{r[i][2], r[i][3]}});
          }
      }
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
        const float* bp = b + (kk * 8 + 2 * t) * ld + 8 * n + g;
        const float bv[2] = {bp[0], bp[ld]};
        typename MM::B bb;
        MM::split(bv, bb.big, bb.small);
        MM::mma(acc[n], a, bb);
      }
    }
  }
}

// delta[row] = sum_d dout[row, d] * out[row, d] in float32: DR lanes a row
// (32 / DR rows a warp), lane l over the row's 16-byte pieces l, l + DR, ...
// (single elements where the rows are not 16-byte aligned), then a
// butterfly over the DR lanes (a fixed order)
constexpr int DR = 8;
template <typename T>
__global__ void __launch_bounds__(256)
attn_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                      float* __restrict__ delta, long long rows, int D) {
  constexpr int V = 16 / sizeof(T);
  const long long row = (long long)blockIdx.x * (256 / DR) + threadIdx.x / DR;
  const int l = threadIdx.x % DR;
  float acc = 0.f;  // every lane reaches the shuffles
  if (row < rows) {
    const T* o = out + row * D;
    const T* d = dout + row * D;
    const bool vec = D % V == 0 && (reinterpret_cast<uintptr_t>(out) |
                                    reinterpret_cast<uintptr_t>(dout)) % 16 == 0;
    if (vec) {
      for (int c = l * V; c < D; c += DR * V) {
        const uint4 a = *reinterpret_cast<const uint4*>(o + c);
        const uint4 b = *reinterpret_cast<const uint4*>(d + c);
        const T* av = reinterpret_cast<const T*>(&a);
        const T* bv = reinterpret_cast<const T*>(&b);
#pragma unroll
        for (int i = 0; i < V; ++i) acc += to_f32(av[i]) * to_f32(bv[i]);
      }
    } else {
      for (int c = l; c < D; c += DR) acc += to_f32(o[c]) * to_f32(d[c]);
    }
  }
#pragma unroll
  for (int off = DR / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (l == 0 && row < rows) delta[row] = acc;
}

// grid (BH, key blocks, output chunks); 2 * BK threads; NC the chunks of D
// where the instance's PLAN row fixes them, else 0 (counted at run time)
template <typename T, int DC, int BK, int ST, int NC>
__global__ void __launch_bounds__(2 * BK, 1)
attn_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                    int Sq, int Sk, int D, float scale, int causal, int has_window, int window,
                    int q_offset) {
  using MM = Mma<T>;
  using S = typename MM::S;
  static_assert(ST >= 2 && BK % 16 == 0, "a ring of two stages or more, 16 keys a warp");
  constexpr int NT = 2 * BK, NO = DC / 8, ld = bwd_ld<T, DC>, QT = TQ * ld;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nc = NC > 0 ? NC : (D + DC - 1) / DC, z = blockIdx.z;
  S* ks = reinterpret_cast<S*>(smem_raw);  // [nc][BK][ld]
  S* vs = ks + nc * BK * ld;               // [nc][BK][ld]
  S* ring = vs + nc * BK * ld;             // [ST][q, dO][TQ][ld]
  float* ls = reinterpret_cast<float*>(ring + ST * 2 * QT);  // [ST][TQ]
  float* dl = ls + ST * TQ;                                  // [ST][TQ]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const long long bh = blockIdx.x;
  const int k0 = blockIdx.y * BK, kw0 = k0 + 16 * warp;  // the block's, this warp's keys
  const int wz = min(D, (z + 1) * DC) - z * DC;           // this block's output columns
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

  // the queries these keys are visible to: q_offset + q >= k0 under
  // `causal`, q_offset + q < k_last + window under a window
  const int k_last = min(k0 + BK, Sk) - 1;
  int q_begin = causal ? max(0, k0 - q_offset) : 0;
  int q_end = has_window
                  ? (int)max(0LL, min((long long)Sq, (long long)k_last + window - q_offset))
                  : Sq;
  const bool empty = some_row_empty(Sq, Sk, has_window, window, q_offset);
  if (empty) { q_begin = 0; q_end = Sq; }
  const int qt0 = q_begin / TQ, qt1 = q_end > q_begin ? (q_end + TQ - 1) / TQ : qt0;
  // a unit: one chunk of one query tile's q and dO; chunk z comes last
  const int tiles = qt1 - qt0, units = tiles * nc;

  auto issue = [&](int u) {
    const int i = u / nc, j = u % nc, slot = u % ST, q0 = (qt0 + i) * TQ;
    S* b = ring + slot * 2 * QT;
    stage<T, DC, TQ, NT>(b, qb, q0, Sq, (z + 1 + j) % nc, D, vec);
    stage<T, DC, TQ, NT>(b + QT, dob, q0, Sq, (z + 1 + j) % nc, D, vec);
    if (j == nc - 1) {  // the tile's lse and delta, for its P and dS
      if (tid < TQ)
        copy_bytes<4>(ls + slot * TQ + tid, lb + q0 + tid, q0 + tid < Sq, lb);
      else if (tid < 2 * TQ)
        copy_bytes<4>(dl + slot * TQ + tid - TQ, db + q0 + tid - TQ, q0 + tid - TQ < Sq, db);
    }
  };

  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) zero(dka[n]), zero(dva[n]);
  if (units > 0) {  // K and V stay for every query tile (in the first group)
    for (int c = 0; c < nc; ++c) {
      stage<T, DC, BK, NT>(ks + c * BK * ld, kb, k0, Sk, c, D, vec);
      stage<T, DC, BK, NT>(vs + c * BK * ld, vb, k0, Sk, c, D, vec);
    }
    issue(0);
  }
  cp_async_commit();
#pragma unroll
  for (int u = 1; u < ST - 1; ++u) {
    if (u < units) issue(u);
    cp_async_commit();
  }
  const float sl = scale * LOG2E, neg2 = __fmul_rn(NEG_INF, LOG2E);
  for (int i = 0, u = 0; i < tiles; ++i) {
    const int q0 = (qt0 + i) * TQ;
    const long long p0 = (long long)q_offset + q0;   // the tile's first position
    // warp-uniform: the masks hide this tile from all of the warp's keys
    // (P = 0 there unless a row sees no key)
    const bool hidden = !empty && (kw0 >= Sk || (causal && p0 + TQ - 1 < kw0) ||
                                   (has_window && p0 - (kw0 + 15) >= window));
    // ---- S^T = K Q^T and dP^T = V dO^T, chunk by chunk ----
    float s[8][4], dp[8][4];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) zero(s[jj]), zero(dp[jj]);
    for (int j = 0; j < nc; ++j, ++u) {
      cp_async_wait<ST - 2>();  // unit u landed; the ST - 2 after it may be in flight
      // every warp is done with unit u - 1, whose stage unit u + ST - 1 takes
      __syncthreads();
      if (u + ST - 1 < units) issue(u + ST - 1);
      cp_async_commit();
      if (hidden) continue;
      const int c = (z + 1 + j) % nc;
      const S* b = ring + (u % ST) * 2 * QT;
      rows_by_rows<T, DC>(s, ks + (c * BK + 16 * warp) * ld, b, lane);
      rows_by_rows<T, DC>(dp, vs + (c * BK + 16 * warp) * ld, b + QT, lane);
    }
    if (hidden) continue;
    // ---- P^T and dS^T on the fragments: rows are keys, columns queries ----
    const int slot = (u - 1) % ST;  // the tile's last unit: chunk z
    const S* b = ring + slot * 2 * QT;
    const float* lr = ls + slot * TQ;
    const float* dr = dl + slot * TQ;
    const bool inner = kw0 + 15 < Sk && q0 + TQ <= Sq && (!causal || p0 >= kw0 + 15) &&
                       (!has_window || p0 + TQ - 1 - kw0 < window);
    if (inner) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 8 * jj + 2 * t + (e & 1);
          const float p = ex2(s[jj][e] * sl - __fmul_rn(lr[qi], LOG2E));
          s[jj][e] = p;
          dp[jj][e] = p * (dp[jj][e] - dr[qi]);
        }
    } else {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 8 * jj + 2 * t + (e & 1), qp = q0 + qi;
          const int kp = kw0 + g + 8 * (e >> 1);
          float p = 0.f;
          if (qp < Sq && kp < Sk)
            p = ex2((visible(q_offset + qp, kp, causal, has_window, window) ? s[jj][e] * sl
                                                                            : neg2) -
                    __fmul_rn(lr[qi], LOG2E));
          s[jj][e] = p;
          dp[jj][e] = p * (dp[jj][e] - dr[qi]);
        }
    }
    // ---- dV += P^T dO, dK += dS^T Q over the tile's queries: chunk z is
    //      the one in this stage ----
    frags_by_tile<T, DC>(dva, s, b + QT, lane);
    frags_by_tile<T, DC>(dka, dp, b, lane);
  }

  // ---- dk * scale and dv, stored once ----
  const bool pairs = D % 2 == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kp = kw0 + g + 8 * h;
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

// Blocks of the dq kernel a SM should hold at once (the registers' bound
// passed to ptxas): three for the bf16 chunk of 80 columns (170 registers a
// thread, where it takes 238 unbounded: dq 8-12 % faster at h2o-danube's
// shape on an H100), else what the kernel needs (the bf16 64-column chunk
// holds three blocks at its own 152 registers, and bounded it spills and is
// slower).
template <typename T, int DC>
constexpr int dq_min_blocks = sizeof(T) == 2 && DC == 80 ? 3 : 1;

// grid (BH, query tiles, output chunks); NTQ threads; NC as the dkv kernel's
template <typename T, int DC, int ST, int NC>
__global__ void __launch_bounds__(NTQ, dq_min_blocks<T, DC>)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq, int Sq, int Sk, int D,
                   float scale, int causal, int has_window, int window, int q_offset) {
  using MM = Mma<T>;
  using S = typename MM::S;
  static_assert(ST >= 2, "a ring of two stages or more");
  constexpr int NT = NTQ, NO = DC / 8, ld = bwd_ld<T, DC>, QT = TQ * ld, KT = TK * ld;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nc = NC > 0 ? NC : (D + DC - 1) / DC, z = blockIdx.z;
  S* qs = reinterpret_cast<S*>(smem_raw);  // [nc][TQ][ld]
  S* dos = qs + nc * QT;                   // [nc][TQ][ld]
  S* ring = dos + nc * QT;                 // [ST][K, V][TK][ld]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const long long bh = blockIdx.x;
  // the last query tiles (the most keys under `causal`) are scheduled first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TQ, qw0 = q0 + 16 * warp;
  const int wz = min(D, (z + 1) * DC) - z * DC;
  const T* qb = q + bh * Sq * D;
  const T* dob = dout + bh * Sq * D;
  const T* kb = k + bh * Sk * D;
  const T* vb = v + bh * Sk * D;
  constexpr int V = 16 / sizeof(T);
  const bool vec = D % V == 0 &&
                   (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) % 16 == 0;

  // this warp's rows g and g + 8: their lse (log2 domain) and delta
  float lr[2], dr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qp = qw0 + g + 8 * h;
    lr[h] = qp < Sq ? __fmul_rn(lse[bh * Sq + qp], LOG2E) : 0.f;
    dr[h] = qp < Sq ? delta[bh * Sq + qp] : 0.f;
  }
  // the keys these queries see (as the forward's KV loop bounds them), at
  // positions q_offset + q0 ... q_offset + q_last
  const int q_last = min(q0 + TQ, Sq) - 1;
  const long long p0 = (long long)q_offset + q0, p_last = (long long)q_offset + q_last;
  int k_begin = has_window ? (int)max(0LL, p0 - window + 1) : 0;
  int k_end = causal ? (int)min((long long)Sk, p_last + 1) : Sk;
  const bool empty = some_row_empty(Sq, Sk, has_window, window, q_offset);
  if (empty) { k_begin = 0; k_end = Sk; }
  const int kt0 = k_begin / TK, kt1 = k_end > k_begin ? (k_end + TK - 1) / TK : kt0;
  // a unit: one chunk of one key tile's K and V; chunk z comes last
  const int tiles = kt1 - kt0, units = tiles * nc;

  auto issue = [&](int u) {
    const int i = u / nc, j = u % nc, key0 = (kt0 + i) * TK;
    S* b = ring + (u % ST) * 2 * KT;
    stage<T, DC, TK, NT>(b, kb, key0, Sk, (z + 1 + j) % nc, D, vec);
    stage<T, DC, TK, NT>(b + KT, vb, key0, Sk, (z + 1 + j) % nc, D, vec);
  };

  float dqa[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) zero(dqa[n]);
  if (units > 0) {  // q and dO stay for every key tile (in the first group)
    for (int c = 0; c < nc; ++c) {
      stage<T, DC, TQ, NT>(qs + c * QT, qb, q0, Sq, c, D, vec);
      stage<T, DC, TQ, NT>(dos + c * QT, dob, q0, Sq, c, D, vec);
    }
    issue(0);
  }
  cp_async_commit();
#pragma unroll
  for (int u = 1; u < ST - 1; ++u) {
    if (u < units) issue(u);
    cp_async_commit();
  }
  const float sl = scale * LOG2E, neg2 = __fmul_rn(NEG_INF, LOG2E);
  for (int i = 0, u = 0; i < tiles; ++i) {
    const int key0 = (kt0 + i) * TK;
    const long long pw0 = (long long)q_offset + qw0;   // the warp's first position
    const bool hidden = !empty && (qw0 >= Sq || (causal && pw0 + 15 < key0) ||
                                   (has_window && pw0 - (key0 + TK - 1) >= window));
    // ---- S = Q K^T and dP = dO V^T, chunk by chunk ----
    float s[8][4], dp[8][4];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) zero(s[jj]), zero(dp[jj]);
    for (int j = 0; j < nc; ++j, ++u) {
      cp_async_wait<ST - 2>();
      __syncthreads();
      if (u + ST - 1 < units) issue(u + ST - 1);
      cp_async_commit();
      if (hidden) continue;
      const int c = (z + 1 + j) % nc;
      const S* b = ring + (u % ST) * 2 * KT;
      rows_by_rows<T, DC>(s, qs + c * QT + 16 * warp * ld, b, lane);
      rows_by_rows<T, DC>(dp, dos + c * QT + 16 * warp * ld, b + KT, lane);
    }
    if (hidden) continue;
    // ---- dS on the fragments: rows are queries, columns keys ----
    const bool inner = key0 + TK <= Sk && qw0 + 15 < Sq && (!causal || pw0 >= key0 + TK - 1) &&
                       (!has_window || pw0 + 15 - key0 < window);
    if (inner) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          s[jj][e] = ex2(s[jj][e] * sl - lr[h]) * (dp[jj][e] - dr[h]);
        }
    } else {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int qp = qw0 + g + 8 * h, kp = key0 + 8 * jj + 2 * t + (e & 1);
          float p = 0.f;
          if (qp < Sq && kp < Sk)
            p = ex2((visible(q_offset + qp, kp, causal, has_window, window) ? s[jj][e] * sl
                                                                            : neg2) -
                    lr[h]);
          s[jj][e] = p * (dp[jj][e] - dr[h]);
        }
    }
    // ---- dQ += dS K over the tile's keys: chunk z is in the tile's last stage ----
    frags_by_tile<T, DC>(dqa, s, ring + ((u - 1) % ST) * 2 * KT, lane);
  }

  const bool pairs = D % 2 == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qp = qw0 + g + 8 * h;
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

template <typename T, int DC, int BK, int ST, int NC>
int launch_at(const void* q, const void* k, const void* v, const void* out, const void* dout,
              const float* lse, float* delta, void* dq, void* dk, void* dv, long long BH, int Sq,
              int Sk, int D, float scale, int causal, int has_window, int window, int q_offset,
              cudaStream_t s) {
  const int nc = (D + DC - 1) / DC;
  const unsigned gq = (Sq + TQ - 1) / TQ, gk = (Sk + BK - 1) / BK, gz = nc;
  const long long rows = BH * Sq;
  if (BH > 2147483647LL || gq > 65535u || gk > 65535u || (rows + 7) / 8 > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const size_t smem_kv = dkv_smem<T, DC>(BK, ST, nc), smem_q = dq_smem<T, DC>(ST, nc);
  if (smem_kv > (size_t)SMEM_OPT_IN || smem_q > (size_t)SMEM_OPT_IN)
    return (int)cudaErrorInvalidValue;
  static bool dkv_opted[MAX_DEVICES] = {}, dq_opted[MAX_DEVICES] = {};
  cudaError_t err = opt_in(attn_bwd_dkv_kernel<T, DC, BK, ST, NC>, dkv_opted);
  if (err == cudaSuccess) err = opt_in(attn_bwd_dq_kernel<T, DC, ST, NC>, dq_opted);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_delta_kernel<T><<<(unsigned)((rows + 256 / DR - 1) / (256 / DR)), 256, 0, s>>>(
      (const T*)out, (const T*)dout, delta, rows, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dkv_kernel<T, DC, BK, ST, NC><<<dim3((unsigned)BH, gk, gz), 2 * BK, smem_kv, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dk, (T*)dv, Sq, Sk,
      D, scale, causal, has_window, window, q_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dq_kernel<T, DC, ST, NC><<<dim3((unsigned)BH, gq, gz), NTQ, smem_q, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dq, Sq, Sk, D, scale,
      causal, has_window, window, q_offset);
  return (int)cudaGetLastError();
}

// The chunks of D every head of PLAN's row I has, where they are one number
// (the row takes the heads wider than the dtype's row before it), else 0.
template <int I>
constexpr int row_chunks() {
  int lo = 0;
  for (int r = 0; r < I; ++r)
    if (PLAN[r].dtype == PLAN[I].dtype && PLAN[r].d_max > lo) lo = PLAN[r].d_max;
  const int first = (lo + PLAN[I].chunk) / PLAN[I].chunk;
  const int last = (PLAN[I].d_max + PLAN[I].chunk - 1) / PLAN[I].chunk;
  return first == last ? last : 0;
}

// the first row of PLAN from row I on that takes a head of D in T
template <typename T, int I = 0>
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const float* lse, float* delta, void* dq, void* dk, void* dv, long long BH, int Sq,
           int Sk, int D, float scale, int causal, int has_window, int window, int q_offset,
           cudaStream_t s) {
  if constexpr (I == PLAN_ROWS) {
    return (int)cudaErrorInvalidValue;
  } else {
    constexpr PlanRow p = PLAN[I];
    if constexpr (p.dtype == (sizeof(T) == 2 ? 1 : 0)) {
      if (D <= p.d_max)
        return launch_at<T, p.chunk, p.keys, p.stages, row_chunks<I>()>(
            q, k, v, out, dout, lse, delta, dq, dk, dv, BH, Sq, Sk, D, scale, causal, has_window,
            window, q_offset, s);
    }
    return launch<T, I + 1>(q, k, v, out, dout, lse, delta, dq, dk, dv, BH, Sq, Sk, D, scale,
                            causal, has_window, window, q_offset, s);
  }
}

}  // namespace

// q, out, dout, dq: [BH, Sq, D]; k, v, dk, dv: [BH, Sk, D]; lse: [BH, Sq]
// float32 (the forward's); delta: [BH, Sq] float32 scratch; all dense, D <=
// 256.  q_offset (>= 0): the position of query row 0 less that of key row 0,
// which the masks read.  dtype: 0 = float32, 1 = bfloat16.  Three launches on `stream` (delta,
// dK / dV, dQ), nothing synchronised.  Returns the first CUDA error of the
// launches, or cudaErrorInvalidValue for arguments it does not take.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* out, const void* dout, const void* lse,
                                         void* delta, void* dq, void* dk, void* dv, long long BH,
                                         int Sq, int Sk, int D, float scale, int causal,
                                         int has_window, int window, int q_offset, int dtype,
                                         void* stream) {
  if (BH <= 0 || Sq <= 0 || Sk <= 0 || D <= 0 || D > D_MAX || q_offset < 0 ||
      (long long)q_offset + Sq > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  float* dl = (float*)delta;
  if (dtype == 0)
    return launch<float>(q, k, v, out, dout, l, dl, dq, dk, dv, BH, Sq, Sk, D, scale, causal,
                         has_window, window, q_offset, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, dout, l, dl, dq, dk, dv, BH, Sq, Sk, D, scale,
                                 causal, has_window, window, q_offset, s);
  return (int)cudaErrorInvalidValue;
}
