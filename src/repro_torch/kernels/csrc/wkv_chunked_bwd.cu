// Backward of the chunked RWKV-6 WKV recurrence from a given state (or
// zero), for Hopper (sm_90a).
//
// Replaces no Pallas kernel: it is the VJP that `jax.grad` takes of the jnp
// `wkv_chunked` of src/repro/models/rwkv6.py:100 (the reference trains
// through that form, never through its Pallas kernel).  The forward is
// csrc/wkv_chunked.cu; per token t, from S_0 (zero, or a given state):
//
//   out[t] = r[t]^T (S[t-1] + diag(u) k[t] v[t]^T),   S[t] = diag(e^{logw[t]}) S[t-1] + k[t] v[t]^T
//
// Given dout and an optional dS_T (null: zero), it returns dr, dk, dv (in
// the type of r, k, v), dlogw (logw's type), du (u's type) and, asked for
// it, dS_0: the reverse pass's G entering chunk 0.  S_0 enters the
// gradients only through the states entering each chunk (the forward's
// workspace, chunk 0's entry S_0): dr' carries it, and the suffix identity
// below needs no term of its own for it.  Per chunk
// of C rows, with b the in-chunk cumsum of logw, b_prev = b - logw, b_C
// the chunk's last b, S_c the state entering the chunk and G' the gradient
// of the state leaving it, dA[t,s] = dout[t].v[s] and
// A[t,s] = sum_k r[t] k[s] e^{b_prev[t] - b[s]} (s < t):
//
//   G_c   = e^{b_C} G' + (r e^{b_prev})^T dout                   (G_n = dS_T)
//   dr[t] = e^{b_prev[t]} (S_c dout[t]) + sum_{s<t} dA[t,s] k[s] e^{b_prev[t] - b[s]} + u k[t] (dout[t].v[t])
//   dk[s] = e^{b_C - b[s]} (G' v[s]) + sum_{t>s} dA[t,s] r[t] e^{b_prev[t] - b[s]} + u r[s] (dout[s].v[s])
//   dv[s] = (k[s] e^{b_C - b[s]})^T G' + sum_{t>s} A[t,s] dout[t] + (sum_k r u k)[s] dout[s]
//   du    = sum_t r[t] k[t] (dout[t].v[t])
//   dlogw[j] = sum_{t>j} r[t] dr'[t] - sum_{s>=j} k[s] dk'[s] + sum_v dS_T S_T
//
// where dr', dk' are dr, dk without their u terms: the cumulative identity
// of gated linear attention (Yang et al. 2023), a suffix sum over the whole
// sequence.  One call launches three kernels on the current stream:
//
// 1. The reverse states pass (`wkv_rstates_kernel`), grid (bh, K tile of
//    16 rows, V tile of 32 columns), one warp a block, the mirror of the
//    forward's states pass: from G = dS_T (or 0) it walks the sequence from
//    the last row to the first, SLAB rows at a time, cut at chunk
//    boundaries into segments; at each chunk's end it writes G (the G' of
//    that chunk) to a float32 workspace [BH, n_chunks, K, V], then
//    G <- 2^{b_e - b_a} G + (r 2^{b_prev - b_a})^T dout over the segment,
//    b_a the cumsum just before the segment's first row: every exponent
//    <= 0.  The product runs on 3xTF32 tensor cores.  The states entering
//    each chunk are the forward's own workspace, kept by the caller
//    (`WKVChunked` saves it): nothing recomputes them.
// 2. The gradients pass, one of two instances; PLAN (below) picks one by
//    (C, K, V).  Every product is factored about a row rho = b_prev of a
//    tile's first row, so that both factors' exponents are <= 0 at any
//    decay (a chunk's decay passes e^88 at RWKV-6's, where a reference at
//    the chunk's start overflows); a factor that underflows to 0 stands
//    for a term below 2^-126.  Products are mma.sync m16n8k8 in 3xTF32
//    (`mma.cuh`), for float32 and bfloat16 inputs alike.
//    - `wkv_grads_chunk_kernel`, grid (bh, chunk): one block a chunk of up
//      to 64 rows, its tiles resident.  The block copies the chunk's logw,
//      then its r, k, v, dout (in their input type), then S_c and G' into
//      shared memory once, by 16-byte cp.async copies in three groups in
//      the order they are needed, and takes the cumsum once.  Each 16-row
//      tile (TILE) belongs to a group of GW warps, which builds the tile's
//      Q = r 2^{b_prev - rho}; then every warp of the block takes n8 column
//      tiles of the tiles' blocks against the chunk's rows before them, dA
//      = dout v^T (to the tile's own last row) and A = Q (k 2^{rho - b})^T.
//      After one block-wide barrier a group reads shared memory only: dr',
//      dk' and dv of its rows live in the mma accumulator fragments of the
//      warps that own their columns (16 of K and 16 of V a warp), and the
//      per-column 2^x scale of each product applies to its fragment.  The
//      diagonal block is two exact SUB = 8 row blocks (one exp2 of
//      b_prev[t] - b[s] a live term; dr' and dk' a column a thread, from
//      registers) and the block below the first, one product factored
//      about b_prev of row 8, as the forward factors its own
//      (csrc/wkv_chunked.cu:36-40); dr' from the earlier rows is one
//      product of depth j0; dk' and dv from each later tile L read L's
//      blocks, transposed.  dlogw's in-chunk suffix is summed in the block,
//      in a fixed order (shuffles within a tile, then the later tiles'
//      totals), with one partial row of x and of du's terms a chunk; dr,
//      dk and dv are written once, from registers, in the inputs' type.
//      Blocks of a grid take the same time, so a wave's loads would meet
//      at its start: each block prefetches into L2 the rows of the block
//      one SM count later in launch order, its SM's next block.  A bf16
//      input is exact in TF32, so its products take one or two terms.
//    - `wkv_grads_tile_kernel`, grid (bh, chunk x tile), for chunks the
//      resident layout does not fit (C > 64, K or V > 64): one block of NW
//      warps a tile, the chunk's cumsum and the tile's rows in float32
//      shared memory, the other tiles staged one at a time, the diagonal
//      block exact, products summed into float32 shared accumulators; its
//      totals go to one partial row a tile.
// 3. The finishing pass (`wkv_finish_kernel`), grid (bh, part), a part
//    being a chunk (resident) or a tile: adds to each row's dlogw the later
//    parts' totals and the dS_T term, in the output's type, and sums du
//    over the parts.
//
// Repeatability: no atomics; every sum runs in a fixed order, so two calls
// give the same bits.  Rows past T are neither read nor written; C is a
// run-time argument.
//
// Bound on this card: bytes.  At RWKV-6's trained shape (BH = 128, T = 512,
// K = V = 64, C = 64, bf16 r/k/v/dout, float32 logw) the inputs and outputs
// are ~92 MB (~28 us at 3.35 TB/s) against ~5 GFLOP of products (~10 us at
// TF32's 495 TFLOP/s).  The two float32 workspaces (entering states and G')
// add ~34 MB read and ~17 MB written.  The chunk instance reads each input
// once (the tile instance reads a chunk's logw, S_c and G' once a tile, and
// its other tiles' rows on every visit); what bounds it before the bytes is
// building its 3xTF32 mma.sync fragments at one block of 16 warps a SM and
// the serial reverse pass (PERF.md has the phases).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "cp_async.cuh"
#include "mma.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int SMEM_LIMIT = 232448;   // bytes of shared memory a block may have
constexpr int KT = 16;               // state rows a reverse-states warp owns: one m16 tile
constexpr int KTP = KT + 8;          // row pitch of its staged r and cumsum
constexpr int NJ = 4;                // n8 tiles of the V columns it owns
constexpr int BVS = 8 * NJ;          // its V tile
constexpr int VSP = BVS + 8;         // row pitch of its staged dout
constexpr int SLAB = 32;             // rows it stages at a time
constexpr int TILE = 16;             // rows of a gradients-pass tile: one m16 tile
constexpr int NW = 4;                // warps of a tile-instance block
constexpr int GW = 4;                // warps of a chunk-instance group: one tile's rows
constexpr int GT = 32 * GW;          // threads of a group
constexpr int MAX_GROUPS = 4;        // groups of a chunk-instance block: chunks of up to 64 rows
constexpr int SUB = 8;               // rows of an exact diagonal block
constexpr int WJ = 2;                // n8 tiles of the K (and V) columns a group's warp owns
constexpr int FIN_X = 64;            // columns of a finishing block
constexpr int FIN_ROWS = 4;          // row slices of a finishing block
constexpr unsigned FULL = 0xffffffffu;
using M = Mma<float>;

// logw and u: 0 = float32, 1 = bfloat16 (the code is uniform over the grid)
__device__ __forceinline__ float load_any(const void* p, long long i, int code) {
  return code == 0 ? static_cast<const float*>(p)[i]
                   : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}
__device__ __forceinline__ void store_any(void* p, long long i, int code, float x) {
  if (code == 0)
    static_cast<float*>(p)[i] = x;
  else
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(x);
}

// 2^x in one MUFU instruction (relative error about 2^-22; a result below
// 2^-126 is flushed to 0, which stands for a term below the tolerance)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ M::A make_a(const float (&v)[4]) {
  M::A a;
  M::split(v, a.big, a.small);
  return a;
}
__device__ __forceinline__ M::B make_b(const float (&v)[2]) {
  M::B b;
  M::split(v, b.big, b.small);
  return b;
}

// ---------------------------------------------------------------------------
// 1. the reverse states pass
// ---------------------------------------------------------------------------

// the accumulator tile G (rows k0 + g, k0 + g + 8; columns v0 + 8 j + 2 tq,
// + 1) to a [K, V] float32 array
__device__ __forceinline__ void store_tile(float* dst, const float (&G)[NJ][4], int K, int V,
                                           int k0, int v0, int g, int tq) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = k0 + g + 8 * h;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = v0 + 8 * j + 2 * tq + e;
        if (row < K && col < V) dst[(long long)row * V + col] = G[j][2 * h + e];
      }
    }
}

template <typename Tin>
__global__ void __launch_bounds__(32)
wkv_rstates_kernel(const Tin* __restrict__ r, const Tin* __restrict__ dout,
                   const void* __restrict__ logw, int logw_code,
                   const float* __restrict__ dstate, float* __restrict__ gws,
                   float* __restrict__ ds0, int T, int K, int V, int C) {
  __shared__ __align__(16) float rs[SLAB * KTP];   // r, the warp's 16 columns
  __shared__ __align__(16) float bs[SLAB * KTP];   // the slab's cumsum of logw * log2 e
  __shared__ __align__(16) float ds[SLAB * VSP];   // dout, the warp's 32 columns
  const int lane = threadIdx.x, g = lane >> 2, tq = lane & 3;
  const long long bh = blockIdx.x;
  const int k0 = blockIdx.y * KT, v0 = blockIdx.z * BVS;
  const int n_chunks = (T + C - 1) / C, n_slabs = (T + SLAB - 1) / SLAB;

  // G from dS_T, or zero
  float G[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = k0 + g + 8 * h, col = v0 + 8 * j + 2 * tq + e;
        G[j][2 * h + e] = dstate != nullptr && row < K && col < V
                              ? dstate[(bh * K + row) * (long long)V + col]
                              : 0.f;
      }

  // the next slab (in walking order) in registers, loaded while this one
  // is worked on: lane l holds r and logw of rows q * 2 + l / 16, column
  // l % 16, and dout of rows q, column l
  constexpr int QK = SLAB * KT / 32, QV = SLAB * BVS / 32;
  float pr[QK], pw[QK], pd[QV];
  auto fetch = [&](int si) {
    const int r0 = si * SLAB, n = min(SLAB, T - r0);
#pragma unroll
    for (int q = 0; q < QK; ++q) {
      const int row = q * (32 / KT) + lane / KT, c = lane % KT;
      const bool in = row < n && k0 + c < K;
      const long long gi = (bh * T + r0 + row) * K + k0 + c;
      pr[q] = in ? to_f32(r[gi]) : 0.f;
      pw[q] = in ? load_any(logw, gi, logw_code) * LOG2E : 0.f;
    }
#pragma unroll
    for (int q = 0; q < QV; ++q) {
      const bool in = q < n && v0 + lane < V;
      pd[q] = in ? to_f32(dout[(bh * T + r0 + q) * V + v0 + lane]) : 0.f;
    }
  };
  fetch(n_slabs - 1);
  for (int si = n_slabs - 1; si >= 0; --si) {
    const int r0 = si * SLAB, n = min(SLAB, T - r0);
    __syncwarp();   // the last slab's reads are done
    // the slab's inclusive cumsum in registers: the two lanes of a column
    // (rows 2q and 2q + 1) add the same values in the same order
    {
      const bool odd = lane >= KT;
      float run = 0.f;
#pragma unroll
      for (int q = 0; q < QK; ++q) {
        const float other = __shfl_xor_sync(FULL, pw[q], KT);
        run += odd ? other : pw[q];
        const float even_row = run;
        run += odd ? pw[q] : other;
        pw[q] = odd ? run : even_row;
      }
    }
#pragma unroll
    for (int q = 0; q < QK; ++q) {
      const int row = q * (32 / KT) + lane / KT, c = lane % KT;
      rs[row * KTP + c] = pr[q];
      bs[row * KTP + c] = pw[q];
    }
#pragma unroll
    for (int q = 0; q < QV; ++q) ds[q * VSP + lane] = pd[q];
    __syncwarp();
    if (si > 0) fetch(si - 1);
    // the segments [a, e) of the slab, cut at chunk boundaries, last first
    for (int e = n; e > 0;) {
      const int ge = r0 + e, ci = (ge - 1) / C;
      const int a = max(0, ci * C - r0);
      if (ge % C == 0 || ge == T)   // the end of chunk ci: G is its G'
        store_tile(gws + ((bh * n_chunks + ci) * K) * (long long)V, G, K, V, k0, v0, g, tq);
      // G <- 2^{b[e-1] - b[a-1]} G + sum_{t in [a, e)} (r[t] 2^{b[t-1] - b[a-1]}) dout[t]^T
      const float ba0 = a ? bs[(a - 1) * KTP + g] : 0.f;
      const float ba1 = a ? bs[(a - 1) * KTP + g + 8] : 0.f;
      float d[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.f;
      for (int s0 = a & ~7; s0 < e; s0 += 8) {
        const int sa = s0 + tq, sb = sa + 4;
        const bool la = sa >= a && sa < e, lb = sb >= a && sb < e;
        // b_prev of row t is the cumsum of row t - 1 (0 at the slab's start)
        const float pa0 = sa ? bs[(sa - 1) * KTP + g] : 0.f;
        const float pa1 = sa ? bs[(sa - 1) * KTP + g + 8] : 0.f;
        const float pb0 = bs[(sb - 1) * KTP + g], pb1 = bs[(sb - 1) * KTP + g + 8];
        const float av[4] = {la ? rs[sa * KTP + g] * ex2(pa0 - ba0) : 0.f,
                             la ? rs[sa * KTP + g + 8] * ex2(pa1 - ba1) : 0.f,
                             lb ? rs[sb * KTP + g] * ex2(pb0 - ba0) : 0.f,
                             lb ? rs[sb * KTP + g + 8] * ex2(pb1 - ba1) : 0.f};
        M::B B[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float bv[2] = {ds[sa * VSP + 8 * j + g], ds[sb * VSP + 8 * j + g]};
          B[j] = make_b(bv);
        }
        const M::A A = make_a(av);
#pragma unroll
        for (int j = 0; j < NJ; ++j) M::mma(d[j], A, B[j]);
      }
      const float e0 = ex2(bs[(e - 1) * KTP + g] - ba0), e1 = ex2(bs[(e - 1) * KTP + g + 8] - ba1);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        G[j][0] = e0 * G[j][0] + d[j][0];
        G[j][1] = e0 * G[j][1] + d[j][1];
        G[j][2] = e1 * G[j][2] + d[j][2];
        G[j][3] = e1 * G[j][3] + d[j][3];
      }
      e = a;
    }
  }
  // G entering chunk 0: the initial state's gradient
  if (ds0 != nullptr) store_tile(ds0 + bh * K * (long long)V, G, K, V, k0, v0, g, tq);
}

// ---------------------------------------------------------------------------
// 2a. the gradients pass, one block a tile
// ---------------------------------------------------------------------------

// Float offsets of a tile-instance block's shared memory, all float32.
// Row pitches: K padded to kp + 4 (kp = K rounded up to 8), V to vp + 4, a
// TILE-wide block to TILE + 4; cp = C rounded up to a TILE.  Every array
// starts on 16 bytes (its offset a multiple of 4 floats).
struct GradLayout {
  int kp, vp, ldk, ldv, ldp, cp;
  int bz, ro, ko, vo, dob, x1, x2, q1, q2, pa, pb, adr, adk, adv, ss, sg, uf, bon, rk, tot, total;
};

__host__ __device__ inline GradLayout grad_layout(int C, int K, int V) {
  GradLayout L;
  L.kp = (K + 7) / 8 * 8;
  L.vp = (V + 7) / 8 * 8;
  L.ldk = L.kp + 4;
  L.ldv = L.vp + 4;
  L.ldp = TILE + 4;
  L.cp = (C + TILE - 1) / TILE * TILE;
  int o = 0;
  L.bz = o; o += (L.cp + 1) * L.ldk;   // bz[0] = 0, bz[s + 1] = b[s] (log2 units)
  L.ro = o; o += TILE * L.ldk;         // the tile's r, k, v, dout
  L.ko = o; o += TILE * L.ldk;
  L.vo = o; o += TILE * L.ldv;
  L.dob = o; o += TILE * L.ldv;
  L.x1 = o; o += TILE * L.ldk;         // another tile's k (earlier) or r (later)
  L.x2 = o; o += TILE * L.ldv;         // ... its v (earlier) or dout (later)
  L.q1 = o; o += TILE * L.ldk;         // decayed operands
  L.q2 = o; o += TILE * L.ldk;
  L.pa = o; o += TILE * L.ldp;         // a block of dA (or its transpose)
  L.pb = o; o += TILE * L.ldp;         // a block of A, transposed
  L.adr = o; o += TILE * L.ldk;        // accumulators of dr', dk', dv
  L.adk = o; o += TILE * L.ldk;
  L.adv = o; o += TILE * L.ldv;
  L.ss = o; o += L.kp * L.ldv;         // S_c
  L.sg = o; o += L.kp * L.ldv;         // G'
  L.uf = o; o += L.kp;
  L.bon = o; o += TILE;                // dout[t].v[t]
  L.rk = o; o += TILE;                 // sum_k r u k of each row
  L.tot = o; o += L.kp > 32 * NW ? L.kp : 32 * NW;   // the cumsum's partial totals
  L.total = o * 4;
  return L;
}

// A warp's share of C[16 x N] = A[16 x kd] @ B[kd x N] (kd a multiple of 8,
// N of 8): the n8 tiles warp, warp + NW, ..., two at a time, which share
// each A fragment and interleave their mma chains; A row-major in shared
// memory, B row-major [k][n] or (BT) stored transposed [n][k].  3xTF32,
// summed from zero over kd; epi(row, col, value) takes each result.
template <bool BT, typename Epi>
__device__ __forceinline__ void gemm16(const float* A, int lda, const float* B, int ldb, int kd,
                                       int ncols, int warp, int lane, Epi epi) {
  const int g = lane >> 2, tq = lane & 3;
  auto load_b = [&](int n0, int k0) {
    return BT ? M::load_bt(B + n0 * ldb + k0, ldb, lane) : M::load_b(B + k0 * ldb + n0, ldb, lane);
  };
  auto put = [&](int n0, const float (&d)[4]) {
    epi(g, n0 + 2 * tq, d[0]);
    epi(g, n0 + 2 * tq + 1, d[1]);
    epi(g + 8, n0 + 2 * tq, d[2]);
    epi(g + 8, n0 + 2 * tq + 1, d[3]);
  };
  for (int n0 = warp * 8; n0 < ncols; n0 += 2 * NW * 8) {
    const int n1 = n0 + NW * 8;
    float d[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    if (n1 < ncols) {
      for (int k0 = 0; k0 < kd; k0 += 8) {
        const M::A a = M::load_a(A + k0, lda, lane);
        const M::B b[2] = {load_b(n0, k0), load_b(n1, k0)};
#pragma unroll
        for (int j = 0; j < 2; ++j) M::mma1(d[j], a.big, b[j].small);
#pragma unroll
        for (int j = 0; j < 2; ++j) M::mma1(d[j], a.small, b[j].big);
#pragma unroll
        for (int j = 0; j < 2; ++j) M::mma1(d[j], a.big, b[j].big);
      }
      put(n1, d[1]);
    } else {
      for (int k0 = 0; k0 < kd; k0 += 8) M::mma(d[0], M::load_a(A + k0, lda, lane), load_b(n0, k0));
    }
    put(n0, d[0]);
  }
}

// `rows` rows of `padw` elements from `src` (row pitch `width`) to a
// float32 [rows][ld] array, zero past the `live` rows and past `width`
// columns; U loads in flight a thread before their stores
template <typename R, int U = 8>
__device__ __forceinline__ void load_rows(float* dst, int ld, const R* src, int width, int rows,
                                          int padw, int live, int tid, int nt) {
  // element i = tid + m nt at (row, col), stepped without a division
  const int drow = nt / padw, dcol = nt - drow * padw;
  int row = tid / padw, col = tid - row * padw;
  while (row < rows) {
    float x[U];
    int rr[U], cc[U];
#pragma unroll
    for (int q = 0; q < U; ++q) {
      rr[q] = row, cc[q] = col;
      x[q] = row < live && col < width ? to_f32(src[(long long)row * width + col]) : 0.f;
      row += drow, col += dcol;
      if (col >= padw) col -= padw, ++row;
    }
#pragma unroll
    for (int q = 0; q < U; ++q)
      if (rr[q] < rows) dst[rr[q] * ld + cc[q]] = x[q];
  }
}

// the same for float32 rows by cp.async (in the caller's commit group):
// 16-byte copies, zero-filled past `width`, where the rows are 16-byte
// aligned, else 4-byte ones; `ld` a multiple of 4 and `padw` of 8
__device__ __forceinline__ void async_rows(float* dst, int ld, const float* src, int width,
                                           int rows, int padw, int live, int tid, int nt) {
  if ((uintptr_t)src % 16 == 0 && width % 4 == 0) {
    const int per = padw / 4;
    for (int i = tid; i < rows * per; i += nt) {
      const int row = i / per, c = (i - row * per) * 4;
      const long long valid = row < live ? (long long)width - c : 0;
      copy_chunk<float, 4>(dst + row * ld + c, src + (long long)row * width + c, valid, true, src);
    }
    return;
  }
  for (int i = tid; i < rows * padw; i += nt) {
    const int row = i / padw, c = i - row * padw;
    copy_bytes<4>(dst + row * ld + c, src + (long long)row * width + c, row < live && c < width,
                  src);
  }
}

template <typename Tin>
__global__ void __launch_bounds__(32 * NW)
wkv_grads_tile_kernel(const Tin* __restrict__ r, const Tin* __restrict__ k, const Tin* __restrict__ v,
                 const void* __restrict__ logw, int logw_code, const void* __restrict__ u,
                 int u_code, const Tin* __restrict__ dout, const float* __restrict__ sws,
                 const float* __restrict__ gws, Tin* __restrict__ dr, Tin* __restrict__ dk,
                 Tin* __restrict__ dv, float* dlw, float* __restrict__ xpart,
                 float* __restrict__ upart, int T, int K, int V, int C) {
  extern __shared__ __align__(16) float sm[];
  const GradLayout L = grad_layout(C, K, V);
  const int nt = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kp = L.kp, vp = L.vp, ldk = L.ldk, ldv = L.ldv, ldp = L.ldp;
  const long long bh = blockIdx.x;
  const int tpc = L.cp / TILE, n_chunks = (T + C - 1) / C, n_tiles = n_chunks * tpc;
  const int c = blockIdx.y / tpc, J = blockIdx.y - c * tpc;
  const int c0 = c * C, n = min(C, T - c0), j0 = J * TILE;
  const long long pidx = (bh * n_tiles + blockIdx.y) * K;   // this tile's partials
  if (j0 >= n) {   // a tile past T: zero partials, for the finishing pass's sums
    for (int kk = tid; kk < K; kk += nt) xpart[pidx + kk] = upart[pidx + kk] = 0.f;
    return;
  }
  const int live = min(TILE, n - j0);
  const long long row0 = bh * T + c0;   // the chunk's first row
  float* bz = sm + L.bz;
  float *ro = sm + L.ro, *ko = sm + L.ko, *vo = sm + L.vo, *dob = sm + L.dob;
  float *x1 = sm + L.x1, *x2 = sm + L.x2, *q1 = sm + L.q1, *q2 = sm + L.q2;
  float *pa = sm + L.pa, *pb = sm + L.pb, *adr = sm + L.adr, *adk = sm + L.adk, *adv = sm + L.adv;
  float *ss = sm + L.ss, *sg = sm + L.sg, *uf = sm + L.uf, *bon = sm + L.bon, *rkb = sm + L.rk;

  // 1. loads: by cp.async, logw of the chunk (float32; zero past its rows,
  // where the cumsum stays flat), the entering state S_c and the leaving
  // state's gradient G'; meanwhile the tile's r, k, v, dout and u, and the
  // accumulators zeroed
  if (logw_code == 0)
    async_rows(bz + ldk, ldk, static_cast<const float*>(logw) + row0 * K, K, L.cp, kp, n, tid, nt);
  async_rows(ss, ldv, sws + (bh * n_chunks + c) * (long long)K * V, V, kp, vp, K, tid, nt);
  async_rows(sg, ldv, gws + (bh * n_chunks + c) * (long long)K * V, V, kp, vp, K, tid, nt);
  cp_async_commit();
  if (logw_code != 0)
    load_rows(bz + ldk, ldk, static_cast<const __nv_bfloat16*>(logw) + row0 * K, K, L.cp, kp, n,
              tid, nt);
  load_rows(ro, ldk, r + (row0 + j0) * K, K, TILE, kp, live, tid, nt);
  load_rows(ko, ldk, k + (row0 + j0) * K, K, TILE, kp, live, tid, nt);
  load_rows(vo, ldv, v + (row0 + j0) * V, V, TILE, vp, live, tid, nt);
  load_rows(dob, ldv, dout + (row0 + j0) * V, V, TILE, vp, live, tid, nt);
  for (int kk = tid; kk < kp; kk += nt) {
    bz[kk] = 0.f;
    uf[kk] = kk < K ? load_any(u, bh * K + kk, u_code) : 0.f;
  }
  for (int i = tid; i < TILE * ldk; i += nt) adr[i] = adk[i] = 0.f;
  for (int i = tid; i < TILE * ldv; i += nt) adv[i] = 0.f;
  cp_async_wait<0>();
  __syncthreads();
  // b = cumsum of logw * log2 e over the chunk: thread (column kk, group q
  // of rows) sums its rows in order; then each adds the totals of the
  // groups before its own
  {
    const int ng = kp >= nt ? 1 : nt / kp, per = (L.cp + ng - 1) / ng;
    float* tot = sm + L.tot;
    for (int i = tid; i < kp * ng; i += nt) {
      const int kk = i % kp, q = i / kp, lo = q * per, hi = min(L.cp, lo + per);
      float run = 0.f;
      for (int s = lo; s < hi; ++s) bz[(s + 1) * ldk + kk] = run += bz[(s + 1) * ldk + kk] * LOG2E;
      tot[q * kp + kk] = run;
    }
    __syncthreads();
    for (int i = tid; i < kp * ng; i += nt) {
      const int kk = i % kp, q = i / kp, lo = q * per, hi = min(L.cp, lo + per);
      float before = 0.f;
      for (int p = 0; p < q; ++p) before += tot[p * kp + kk];
      for (int s = lo; s < hi; ++s) bz[(s + 1) * ldk + kk] += before;
    }
  }
  __syncthreads();
  // b_prev of row s is bz[s], b of row s bz[s + 1]; rho = b_prev of the
  // tile's first row; b_C = b of the chunk's last live row
  const float* rho = bz + j0 * ldk;
  const float* bC = bz + n * ldk;
  auto bp = [&](int s, int kk) { return bz[s * ldk + kk]; };        // b_prev, chunk row s
  auto bb = [&](int s, int kk) { return bz[(s + 1) * ldk + kk]; };  // b, chunk row s

  // 2. the diagonal block: dA = dout v^T (s <= t), then its exact terms
  gemm16<true>(dob, ldv, vo, ldv, vp, TILE, warp, lane,
               [&](int t, int s, float x) { pa[t * ldp + s] = x; });
  __syncthreads();
  for (int i = tid; i < TILE * kp; i += nt) {
    const int t = i / kp, kk = i - t * kp;
    if (t >= live) continue;
    float sr = 0.f, sk = 0.f;
    for (int s = 0; s < t; ++s)   // dr': s < t
      sr += pa[t * ldp + s] * ko[s * ldk + kk] * ex2(bp(j0 + t, kk) - bb(j0 + s, kk));
    for (int q = t + 1; q < live; ++q)   // dk' of row t: later rows q
      sk += pa[q * ldp + t] * ro[q * ldk + kk] * ex2(bp(j0 + q, kk) - bb(j0 + t, kk));
    adr[t * ldk + kk] = sr;
    adk[t * ldk + kk] = sk;
  }
  for (int i = tid; i < TILE * TILE; i += nt) {   // A^T of the block, exact
    const int t = i / TILE, s = i - t * TILE;
    float a[4] = {0.f, 0.f, 0.f, 0.f};   // four sums, so that no add waits on the last
    if (s < t && t < live)
      for (int kk = 0; kk < kp; kk += 4)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          a[e] += ro[t * ldk + kk + e] * ko[s * ldk + kk + e] *
                  ex2(bp(j0 + t, kk + e) - bb(j0 + s, kk + e));
    pb[s * ldp + t] = (a[0] + a[1]) + (a[2] + a[3]);
  }
  // the bonus's factors dout[t].v[t] and sum_k r u k: eight lanes a row,
  // each a strided share of the columns, then a fixed butterfly
  for (int i = tid; i < TILE * 8; i += nt) {
    const int t = i / 8, part = i - t * 8;
    float x = 0.f, y = 0.f;
    for (int vv = part; vv < vp; vv += 8) x += dob[t * ldv + vv] * vo[t * ldv + vv];
    for (int kk = part; kk < kp; kk += 8) y += ro[t * ldk + kk] * uf[kk] * ko[t * ldk + kk];
#pragma unroll
    for (int o = 4; o; o >>= 1) {
      x += __shfl_xor_sync(FULL, x, o);
      y += __shfl_xor_sync(FULL, y, o);
    }
    if (part == 0) bon[t] = x, rkb[t] = y;
  }
  // k decayed to the chunk's end, for the G' term of dv
  for (int i = tid; i < TILE * kp; i += nt) {
    const int s = i / kp, kk = i - s * kp;
    q1[s * ldk + kk] = ko[s * ldk + kk] * ex2(bC[kk] - bb(j0 + s, kk));
  }
  __syncthreads();
  gemm16<false>(pb, ldp, dob, ldv, TILE, vp, warp, lane,   // dv += A^T dout
                [&](int s, int vv, float x) { adv[s * ldv + vv] += x; });

  // 3. the chunk's states: dr' += 2^{b_prev} (dout S_c^T), dk' += 2^{b_C - b}
  // (v G'^T), dv += (k 2^{b_C - b}) G'
  gemm16<true>(dob, ldv, ss, ldv, vp, kp, warp, lane, [&](int t, int kk, float x) {
    adr[t * ldk + kk] += ex2(bp(j0 + t, kk)) * x;
  });
  gemm16<true>(vo, ldv, sg, ldv, vp, kp, warp, lane, [&](int s, int kk, float x) {
    adk[s * ldk + kk] += ex2(bC[kk] - bb(j0 + s, kk)) * x;
  });
  gemm16<false>(q1, ldk, sg, ldv, kp, vp, warp, lane,
                [&](int s, int vv, float x) { adv[s * ldv + vv] += x; });
  __syncthreads();

  // 4. the other tiles of the chunk, visited in order: each earlier tile
  // I (its k and v), about rho = b_prev of this tile's first row:
  // dr' += 2^{b_prev - rho} ((dout v_I^T) (k_I 2^{rho - b_I})); then each
  // later live tile L (its r and dout), about rho_L = b_prev of its first
  // row: Q_L = r_L 2^{b_prev - rho_L}, dA^T = v dout_L^T,
  // A^T = (k 2^{rho_L - b}) Q_L^T; dv += A^T dout_L, dk' += 2^{rho_L - b}
  // (dA^T Q_L)
  const int n_visits = (n - 1) / TILE;   // the chunk's live tiles but this one
  for (int m = 0; m < n_visits; ++m) {
    const int m0 = (m < J ? m : m + 1) * TILE;
    const long long o = row0 + m0;
    load_rows(x1, ldk, (m < J ? k : r) + o * K, K, TILE, kp, n - m0, tid, nt);
    load_rows(x2, ldv, (m < J ? v : dout) + o * V, V, TILE, vp, n - m0, tid, nt);
    __syncthreads();
    if (m < J) {
      for (int i = tid; i < TILE * kp; i += nt) {
        const int s = i / kp, kk = i - s * kp;
        q1[s * ldk + kk] = x1[s * ldk + kk] * ex2(rho[kk] - bb(m0 + s, kk));
      }
      gemm16<true>(dob, ldv, x2, ldv, vp, TILE, warp, lane,
                   [&](int t, int s, float x) { pa[t * ldp + s] = x; });
      __syncthreads();
      gemm16<false>(pa, ldp, q1, ldk, TILE, kp, warp, lane, [&](int t, int kk, float x) {
        adr[t * ldk + kk] += ex2(bp(j0 + t, kk) - rho[kk]) * x;
      });
    } else {
      const float* rhoL = bz + m0 * ldk;
      for (int i = tid; i < TILE * kp; i += nt) {
        const int t = i / kp, kk = i - t * kp;
        q1[t * ldk + kk] = x1[t * ldk + kk] * ex2(bp(m0 + t, kk) - rhoL[kk]);
        q2[t * ldk + kk] = ko[t * ldk + kk] * ex2(rhoL[kk] - bb(j0 + t, kk));
      }
      gemm16<true>(vo, ldv, x2, ldv, vp, TILE, warp, lane,
                   [&](int s, int t, float x) { pa[s * ldp + t] = x; });
      __syncthreads();
      gemm16<true>(q2, ldk, q1, ldk, kp, TILE, warp, lane,
                   [&](int s, int t, float x) { pb[s * ldp + t] = x; });
      __syncthreads();
      gemm16<false>(pb, ldp, x2, ldv, TILE, vp, warp, lane,
                    [&](int s, int vv, float x) { adv[s * ldv + vv] += x; });
      gemm16<false>(pa, ldp, q1, ldk, TILE, kp, warp, lane, [&](int s, int kk, float x) {
        adk[s * ldk + kk] += ex2(rhoL[kk] - bb(j0 + s, kk)) * x;
      });
    }
    __syncthreads();
  }

  // 5. dlogw within the tile (the suffix sum of x = r dr' - k dk', less
  // r dr' of the row itself), the tile's totals of x and of du's terms;
  // then dr, dk, dv with the u terms, once, in the inputs' type
  for (int kk = tid; kk < K; kk += nt) {
    float run = 0.f, du_sum = 0.f;
    for (int t = live - 1; t >= 0; --t) {
      const float xr = ro[t * ldk + kk] * adr[t * ldk + kk];
      run += xr - ko[t * ldk + kk] * adk[t * ldk + kk];
      dlw[(row0 + j0 + t) * K + kk] = run - xr;
    }
    for (int t = 0; t < live; ++t) du_sum += ro[t * ldk + kk] * ko[t * ldk + kk] * bon[t];
    xpart[pidx + kk] = run;
    upart[pidx + kk] = du_sum;
  }
  for (int i = tid; i < live * K; i += nt) {
    const int t = i / K, kk = i - t * K;
    const long long o = (row0 + j0 + t) * K + kk;
    from_f32(adr[t * ldk + kk] + uf[kk] * ko[t * ldk + kk] * bon[t], dr + o);
    from_f32(adk[t * ldk + kk] + uf[kk] * ro[t * ldk + kk] * bon[t], dk + o);
  }
  for (int i = tid; i < live * V; i += nt) {
    const int t = i / V, vv = i - t * V;
    from_f32(adv[t * ldv + vv] + rkb[t] * dob[t * ldv + vv], dv + (row0 + j0 + t) * V + vv);
  }
}

// ---------------------------------------------------------------------------
// 2b. the gradients pass, one block a chunk
// ---------------------------------------------------------------------------

// Byte offsets of a chunk-instance block's shared memory: r, k, v and dout
// of the chunk's rows in their input type (rows padded to kp + 16 bytes,
// kp = K rounded up to 8, and vp + 16 bytes), everything else float32: the
// cumsum ((cp + 1) rows of kp + 4, cp = C rounded up to a TILE), S_c and
// G' (kp rows of vp + 4), every tile's Q (cp rows of kp + 4), each group's
// blocks dA and A (TILE rows of cp + 4) and its diagonal block of A,
// transposed (TILE x (TILE + 4)), the exact diagonal blocks' dr' and dk'
// (two TILE x (kp + 4)), u, two factors a row, the cumsum's partial totals
// and each tile's totals of x and of du's terms.  Every array starts on 16
// bytes.
struct ChunkLayout {
  int kp, vp, ldk, ldv, ldkt, ldvt, cp, groups, ldc, ldp;
  int bz, rt, kt, vt, dt, ss, sg, qb, pa, pA, pd, xd, uf, bon, rk, tot, xt, ut, total;
};

__host__ __device__ inline ChunkLayout chunk_layout(int C, int K, int V, int isz) {
  ChunkLayout L;
  L.kp = (K + 7) / 8 * 8;
  L.vp = (V + 7) / 8 * 8;
  L.ldk = L.kp + 4;
  L.ldv = L.vp + 4;
  L.ldkt = L.kp + 16 / isz;
  L.ldvt = L.vp + 16 / isz;
  L.cp = (C + TILE - 1) / TILE * TILE;
  L.groups = L.cp / TILE;
  L.ldc = L.cp + 4;
  L.ldp = TILE + 4;
  int o = 0;
  L.bz = o; o += (L.cp + 1) * L.ldk * 4;   // bz[0] = 0, bz[s + 1] = b[s] (log2 units)
  L.rt = o; o += L.cp * L.ldkt * isz;
  L.kt = o; o += L.cp * L.ldkt * isz;
  L.vt = o; o += L.cp * L.ldvt * isz;
  L.dt = o; o += L.cp * L.ldvt * isz;
  L.ss = o; o += L.kp * L.ldv * 4;         // S_c
  L.sg = o; o += L.kp * L.ldv * 4;         // G'
  L.qb = o; o += L.cp * L.ldk * 4;         // Q of every tile
  L.pa = o; o += L.groups * TILE * L.ldc * 4;
  L.pA = o; o += L.groups * TILE * L.ldc * 4;
  L.pd = o; o += L.groups * TILE * L.ldp * 4;
  L.xd = o; o += L.groups * 2 * TILE * L.ldk * 4;
  L.uf = o; o += L.kp * 4;
  L.bon = o; o += L.cp * 4;                // dout[t].v[t]
  L.rk = o; o += L.cp * 4;                 // sum_k r u k of each row
  L.tot = o; o += (L.kp > GT * L.groups ? L.kp : GT * L.groups) * 4;
  L.xt = o; o += L.groups * L.kp * 4;
  L.ut = o; o += L.groups * L.kp * 4;
  L.total = o;
  return L;
}

// `rows` rows of `padw` elements (whole 16-byte chunks) from `src` (row
// pitch `width`) to shared memory at `dst` (row pitch `ld`), zero past the
// `live` rows and past `width` columns: 16-byte cp.async copies (in the
// caller's commit group) where the rows are 16-byte aligned, else plain
// loads, eight in flight a thread, stored at once
template <typename R>
__device__ __forceinline__ void stage_rows(R* dst, int ld, const R* src, int width, int rows,
                                           int padw, int live, int tid, int nt) {
  constexpr int VE = 16 / sizeof(R);
  if ((uintptr_t)src % 16 == 0 && ((long long)width * sizeof(R)) % 16 == 0) {
    const int per = padw / VE;
    for (int i = tid; i < rows * per; i += nt) {
      const int row = i / per, c = (i - row * per) * VE;
      const long long valid = row < live ? (long long)width - c : 0;
      copy_chunk<R, VE>(dst + row * ld + c, src + (long long)row * width + c, valid, true, src);
    }
    return;
  }
  for (int i0 = tid; i0 < rows * padw; i0 += 8 * nt) {
    R x[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int i = i0 + q * nt, row = i / padw, col = i - row * padw;
      x[q] = i < rows * padw && row < live && col < width ? src[(long long)row * width + col]
                                                          : R(0.f);
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int i = i0 + q * nt, row = i / padw, col = i - row * padw;
      if (i < rows * padw) dst[row * ld + col] = x[q];
    }
  }
}

// An operand that TF32 holds exactly (a bfloat16 input, widened: 8 bits of
// mantissa) has no small part, so that its 3xTF32 product needs two terms,
// or one where both are exact (the product is exact in float32).  X marks
// such an operand: its fragment is not split and the terms it zeroes are
// skipped.
template <bool X, int N>
__device__ __forceinline__ void split_x(const float (&v)[N], uint32_t (&big)[N],
                                        uint32_t (&small)[N]) {
  if constexpr (X) {
#pragma unroll
    for (int i = 0; i < N; ++i) big[i] = __float_as_uint(v[i]);
  } else {
    M::split(v, big, small);
  }
}

// d += a @ b: 3xTF32 less the terms an exact operand zeroes
template <bool AX, bool BX>
__device__ __forceinline__ void mma_x(float (&d)[4], const M::A& a, const M::B& b) {
  if constexpr (!BX) M::mma1(d, a.big, b.small);
  if constexpr (!AX) M::mma1(d, a.small, b.big);
  M::mma1(d, a.big, b.big);
}

// mma.m16n8k8 fragments (mma.cuh's layouts) from shared memory of either
// type (X: exact, not split): A (16 x 8) row-major, B row-major [k][n], B
// stored transposed [n][k]
template <bool X = false, typename R>
__device__ __forceinline__ M::A frag_a(const R* s, int ld, int g, int tq) {
  const float v[4] = {to_f32(s[g * ld + tq]), to_f32(s[(g + 8) * ld + tq]),
                      to_f32(s[g * ld + tq + 4]), to_f32(s[(g + 8) * ld + tq + 4])};
  M::A a;
  split_x<X>(v, a.big, a.small);
  return a;
}
template <bool X = false, typename R>
__device__ __forceinline__ M::B frag_b(const R* s, int ld, int g, int tq) {
  const float v[2] = {to_f32(s[tq * ld + g]), to_f32(s[(tq + 4) * ld + g])};
  M::B b;
  split_x<X>(v, b.big, b.small);
  return b;
}
template <bool X = false, typename R>
__device__ __forceinline__ M::B frag_bt(const R* s, int ld, int g, int tq) {
  const float v[2] = {to_f32(s[g * ld + tq]), to_f32(s[g * ld + tq + 4])};
  M::B b;
  split_x<X>(v, b.big, b.small);
  return b;
}

// four neighbouring elements from a 16-byte (float32) or 8-byte (bf16)
// aligned address, as float32
__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// an accumulator tile (rows g, g + 8; columns 2 tq, 2 tq + 1) to a
// float32 [16][ld] block
__device__ __forceinline__ void store_frag(float* dst, int ld, const float (&d)[4], int g,
                                           int tq) {
  dst[g * ld + 2 * tq] = d[0];
  dst[g * ld + 2 * tq + 1] = d[1];
  dst[(g + 8) * ld + 2 * tq] = d[2];
  dst[(g + 8) * ld + 2 * tq + 1] = d[3];
}

// two neighbouring outputs, the first at an even column: one store where
// the row's width is even, else one or two
__device__ __forceinline__ void put_pair(float* p, float a, float b, bool pair, bool second) {
  if (pair) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
    return;
  }
  p[0] = a;
  if (second) p[1] = b;
}
__device__ __forceinline__ void put_pair(__nv_bfloat16* p, float a, float b, bool pair,
                                         bool second) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
    return;
  }
  p[0] = __float2bfloat16(a);
  if (second) p[1] = __float2bfloat16(b);
}

// `bytes` from `p` into L2 (whole 128-byte lines, none before p)
__device__ __forceinline__ void prefetch_l2(const void* p, long long bytes, int tid, int nt) {
  const uintptr_t a = (uintptr_t)p, e = a + bytes;
  for (uintptr_t l = (a & ~(uintptr_t)127) + (uintptr_t)tid * 128; l < e; l += (uintptr_t)nt * 128)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(l < a ? a : l));
}

template <typename Tin>
__global__ void __launch_bounds__(GT * MAX_GROUPS, 1)
wkv_grads_chunk_kernel(const Tin* __restrict__ r, const Tin* __restrict__ k,
                       const Tin* __restrict__ v, const void* __restrict__ logw, int logw_code,
                       const void* __restrict__ u, int u_code, const Tin* __restrict__ dout,
                       const float* __restrict__ sws, const float* __restrict__ gws,
                       Tin* __restrict__ dr, Tin* __restrict__ dk, Tin* __restrict__ dv,
                       float* dlw, float* __restrict__ xpart, float* __restrict__ upart, int T,
                       int K, int V, int C, int ahead) {
  constexpr int TRI = SUB * (SUB - 1) / 2;   // live terms of an exact diagonal block
  constexpr bool XI = std::is_same<Tin, __nv_bfloat16>::value;   // inputs exact in TF32
  extern __shared__ __align__(16) unsigned char smc[];
  const ChunkLayout L = chunk_layout(C, K, V, sizeof(Tin));
  const int nt = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int J = warp / GW, wg = warp - J * GW, gt = tid - J * GT;   // the group: tile J
  const int kp = L.kp, vp = L.vp, ldk = L.ldk, ldv = L.ldv, ldkt = L.ldkt, ldvt = L.ldvt;
  const int ldc = L.ldc, ldp = L.ldp;
  const long long bh = blockIdx.x;
  const int c = blockIdx.y, n_chunks = (T + C - 1) / C;
  const int c0 = c * C, n = min(C, T - c0);
  const int j0 = J * TILE, live = min(TILE, n - j0);   // live <= 0: a tile past T
  const long long row0 = bh * T + c0;   // the chunk's first row
  float* bz = reinterpret_cast<float*>(smc + L.bz);
  Tin* rt = reinterpret_cast<Tin*>(smc + L.rt);
  Tin* kt = reinterpret_cast<Tin*>(smc + L.kt);
  Tin* vt = reinterpret_cast<Tin*>(smc + L.vt);
  Tin* dt = reinterpret_cast<Tin*>(smc + L.dt);
  float* ss = reinterpret_cast<float*>(smc + L.ss);
  float* sg = reinterpret_cast<float*>(smc + L.sg);
  float* qb = reinterpret_cast<float*>(smc + L.qb);
  float* pa = reinterpret_cast<float*>(smc + L.pa);
  float* pA = reinterpret_cast<float*>(smc + L.pA);
  float* uf = reinterpret_cast<float*>(smc + L.uf);
  float* bon = reinterpret_cast<float*>(smc + L.bon);
  float* rkb = reinterpret_cast<float*>(smc + L.rk);
  float* xt = reinterpret_cast<float*>(smc + L.xt);
  float* ut = reinterpret_cast<float*>(smc + L.ut);
  float* pag = pa + J * TILE * ldc;   // the group's own blocks and scratch
  float* pdg = reinterpret_cast<float*>(smc + L.pd) + J * TILE * ldp;
  float* xdr = reinterpret_cast<float*>(smc + L.xd) + J * 2 * TILE * ldk;
  float* xdk = xdr + TILE * ldk;
  auto group_sync = [&]() { asm volatile("bar.sync %0, %1;" ::"r"(1 + J), "r"(GT) : "memory"); };

  // 1. loads, once, by cp.async in three groups in the order they are
  // needed: the chunk's logw (float32; zero past its rows, where the cumsum
  // stays flat), its r, k, v and dout (for the blocks), S_c and G' (for
  // the states); bf16 logw by plain loads, widened
  if (logw_code == 0)
    stage_rows(bz + ldk, ldk, static_cast<const float*>(logw) + row0 * K, K, L.cp, kp, n, tid,
               nt);
  cp_async_commit();
  stage_rows(rt, ldkt, r + row0 * K, K, L.cp, kp, n, tid, nt);
  stage_rows(kt, ldkt, k + row0 * K, K, L.cp, kp, n, tid, nt);
  stage_rows(vt, ldvt, v + row0 * V, V, L.cp, vp, n, tid, nt);
  stage_rows(dt, ldvt, dout + row0 * V, V, L.cp, vp, n, tid, nt);
  cp_async_commit();
  async_rows(ss, ldv, sws + (bh * n_chunks + c) * (long long)K * V, V, kp, vp, K, tid, nt);
  async_rows(sg, ldv, gws + (bh * n_chunks + c) * (long long)K * V, V, kp, vp, K, tid, nt);
  cp_async_commit();
  if (logw_code != 0)
    load_rows(bz + ldk, ldk, static_cast<const __nv_bfloat16*>(logw) + row0 * K, K, L.cp, kp, n,
              tid, nt);
  for (int kk = tid; kk < kp; kk += nt) {
    bz[kk] = 0.f;
    uf[kk] = kk < K ? load_any(u, bh * K + kk, u_code) : 0.f;
  }
  cp_async_wait<2>();
  __syncthreads();

  // 2. b = cumsum of logw * log2 e over the chunk, once: thread (column kk,
  // group q of rows) sums its rows in order, eight loaded ahead; then each
  // adds the totals of the groups before its own
  {
    const int ng = kp >= nt ? 1 : nt / kp, per = (L.cp + ng - 1) / ng;
    float* tot = reinterpret_cast<float*>(smc + L.tot);
    for (int i = tid; i < kp * ng; i += nt) {
      const int kk = i % kp, q = i / kp, lo = q * per, hi = min(L.cp, lo + per);
      float run = 0.f;
      for (int s = lo; s < hi; s += 8) {
        float x[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) x[e] = s + e < hi ? bz[(s + e + 1) * ldk + kk] : 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (s + e < hi) bz[(s + e + 1) * ldk + kk] = run += x[e] * LOG2E;
      }
      tot[q * kp + kk] = run;
    }
    __syncthreads();
    for (int i = tid; i < kp * ng; i += nt) {
      const int kk = i % kp, q = i / kp, lo = q * per, hi = min(L.cp, lo + per);
      float before = 0.f;
      for (int p = 0; p < q; ++p) before += tot[p * kp + kk];
      for (int s = lo; s < hi; s += 8) {
        float x[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) x[e] = s + e < hi ? bz[(s + e + 1) * ldk + kk] : 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (s + e < hi) bz[(s + e + 1) * ldk + kk] = x[e] + before;
      }
    }
  }
  cp_async_wait<1>();   // r, k, v, dout
  __syncthreads();
  // b_prev of chunk row s is bz[s], b of row s bz[s + 1]; rho = b_prev of
  // the tile's first row; b_C = b of the chunk's last live row
  const float* rho = bz + j0 * ldk;
  const float* bC = bz + n * ldk;

  // 3. the tiles' blocks.  Each group: its tile's Q = r 2^{b_prev - rho},
  // the bonus's factors dout[t].v[t] and sum_k r u k, and the two exact
  // blocks of its diagonal block's A, transposed (pd), two lanes a term,
  // each over half of K.  Then every warp of the block takes n8 column
  // tiles of any live tile J (so that the later tiles' larger share evens
  // out): A = Q (k 2^{rho - b})^T against rows 0 .. j0 - 1 (pA), the block
  // of A_JJ^T below its first exact block, one product about rho8 = b_prev
  // of row 8, (k 2^{rho8 - b}) (r 2^{b_prev - rho8})^T (pd), and dA = dout
  // v^T against rows 0 .. j0 + 15 (pa)
  if (live > 0) {
    for (int i = gt; i < TILE * kp; i += GT) {
      const int t = i / kp, kk = i - t * kp;
      qb[(j0 + t) * ldk + kk] =
          to_f32(rt[(j0 + t) * ldkt + kk]) * ex2(bz[(j0 + t) * ldk + kk] - rho[kk]);
    }
    {
      const int t = gt >> 3, part = gt & 7;   // eight lanes a row
      float x = 0.f, y = 0.f;
      for (int vv = part; vv < vp; vv += 8)
        x += to_f32(dt[(j0 + t) * ldvt + vv]) * to_f32(vt[(j0 + t) * ldvt + vv]);
      for (int kk = part; kk < kp; kk += 8)
        y += to_f32(rt[(j0 + t) * ldkt + kk]) * uf[kk] * to_f32(kt[(j0 + t) * ldkt + kk]);
#pragma unroll
      for (int o = 4; o; o >>= 1) {
        x += __shfl_xor_sync(FULL, x, o);
        y += __shfl_xor_sync(FULL, y, o);
      }
      if (part == 0) bon[j0 + t] = x, rkb[j0 + t] = y;
    }
    {
      const int p = gt >> 1, half = gt & 1;
      int t = 1, s = 0;
      float a[4] = {0.f, 0.f, 0.f, 0.f};   // four sums, so that no add waits on the last
      if (p < 2 * TRI) {
        const int blk = p / TRI, p1 = p - blk * TRI;
        while ((t + 1) * t / 2 <= p1) ++t;   // t (t - 1) / 2 <= p1 < t (t + 1) / 2
        s = p1 - t * (t - 1) / 2 + blk * SUB;
        t += blk * SUB;
        const int hk = kp / 2, lo = half * hk;
        const Tin* rr = rt + (j0 + t) * ldkt;
        const Tin* kr = kt + (j0 + s) * ldkt;
        const float* bt = bz + (j0 + t) * ldk;
        const float* bs = bz + (j0 + s + 1) * ldk;
        for (int kk = lo; kk < lo + hk; kk += 4) {   // four columns a load
          const float4 x = ld4(rr + kk), y = ld4(kr + kk), et = ld4(bt + kk), es = ld4(bs + kk);
          a[0] += x.x * y.x * ex2(et.x - es.x);
          a[1] += x.y * y.y * ex2(et.y - es.y);
          a[2] += x.z * y.z * ex2(et.z - es.z);
          a[3] += x.w * y.w * ex2(et.w - es.w);
        }
      }
      float sum = (a[0] + a[1]) + (a[2] + a[3]);
      sum += __shfl_xor_sync(FULL, sum, 1);
      if (p < 2 * TRI && half == 0) pdg[s * ldp + t] = sum;
    }
    for (int i = gt; i < TILE * TILE; i += GT) {   // the rest of A^T but the factored block: zero
      const int s = i / TILE, t = i - s * TILE;
      if (!(s < t && s / SUB == t / SUB) && !(s < SUB && t >= SUB)) pdg[s * ldp + t] = 0.f;
    }
  }
  __syncthreads();   // every tile's Q
  {
    // tile Z's jobs, in order: its 2 Z tiles of A, its factored block, its
    // 2 Z + 2 tiles of dA
    const int live_tiles = (n + TILE - 1) / TILE;
    int jobs = 0;
    for (int Z = 0; Z < live_tiles; ++Z) jobs += 4 * Z + 3;
    for (int z = warp; z < jobs; z += nt / 32) {
      int Z = 0, q = z;
      while (q >= 4 * Z + 3) q -= 4 * Z + 3, ++Z;
      const int z0 = Z * TILE;
      const float* rhoZ = bz + z0 * ldk;
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      if (q < 2 * Z) {
        const int s0 = 8 * q, s = s0 + g;
        for (int k0 = 0; k0 < kp; k0 += 8) {
          const int ka = k0 + tq, kb = ka + 4;
          const float bv[2] = {to_f32(kt[s * ldkt + ka]) * ex2(rhoZ[ka] - bz[(s + 1) * ldk + ka]),
                               to_f32(kt[s * ldkt + kb]) * ex2(rhoZ[kb] - bz[(s + 1) * ldk + kb])};
          M::mma(d, M::load_a(qb + z0 * ldk + k0, ldk, lane), make_b(bv));
        }
        store_frag(pA + Z * TILE * ldc + s0, ldc, d, g, tq);
      } else if (q == 2 * Z) {
        const float* rho8 = bz + (z0 + SUB) * ldk;
        const Tin* ks = kt + (z0 + g) * ldkt;         // rows s = g of A^T
        const float* bs = bz + (z0 + g + 1) * ldk;    // b[s]
        const Tin* rs = rt + (z0 + SUB + g) * ldkt;   // columns t = 8 + g
        const float* bt = bz + (z0 + SUB + g) * ldk;  // b_prev[t]
        for (int k0 = 0; k0 < kp; k0 += 8) {
          const int ka = k0 + tq, kb = ka + 4;
          const float av[4] = {to_f32(ks[ka]) * ex2(rho8[ka] - bs[ka]), 0.f,
                               to_f32(ks[kb]) * ex2(rho8[kb] - bs[kb]), 0.f};
          const float bv[2] = {to_f32(rs[ka]) * ex2(bt[ka] - rho8[ka]),
                               to_f32(rs[kb]) * ex2(bt[kb] - rho8[kb])};
          M::mma(d, make_a(av), make_b(bv));
        }
        float* pdz = reinterpret_cast<float*>(smc + L.pd) + Z * TILE * ldp;
        pdz[g * ldp + SUB + 2 * tq] = d[0];
        pdz[g * ldp + SUB + 2 * tq + 1] = d[1];
      } else {
        const int s0 = 8 * (q - 2 * Z - 1);
        for (int k0 = 0; k0 < vp; k0 += 8)
          mma_x<XI, XI>(d, frag_a<XI>(dt + z0 * ldvt + k0, ldvt, g, tq),
                        frag_bt<XI>(vt + s0 * ldvt + k0, ldvt, g, tq));
        store_frag(pa + Z * TILE * ldc + s0, ldc, d, g, tq);
      }
    }
  }
  cp_async_wait<0>();   // S_c, G'
  __syncthreads();      // every tile's Q and blocks are in place
  // into L2, the rows that the block `ahead` places on in launch order
  // copies: the one that takes this SM's next turn, as blocks start in
  // order and take about the same time
  {
    const long long next = blockIdx.x + (long long)blockIdx.y * gridDim.x + ahead;
    if (ahead > 0 && next < (long long)gridDim.x * gridDim.y) {
      const long long bh2 = next % gridDim.x;
      const int c2 = (int)(next / gridDim.x), n2 = min(C, T - c2 * C);
      const long long r2 = bh2 * T + (long long)c2 * C, st = (bh2 * n_chunks + c2) * K * V;
      const int wsz = logw_code == 0 ? 4 : 2;
      prefetch_l2(r + r2 * K, (long long)n2 * K * sizeof(Tin), tid, nt);
      prefetch_l2(k + r2 * K, (long long)n2 * K * sizeof(Tin), tid, nt);
      prefetch_l2(v + r2 * V, (long long)n2 * V * sizeof(Tin), tid, nt);
      prefetch_l2(dout + r2 * V, (long long)n2 * V * sizeof(Tin), tid, nt);
      prefetch_l2(static_cast<const char*>(logw) + r2 * K * wsz, (long long)n2 * K * wsz, tid, nt);
      prefetch_l2(sws + st, (long long)K * V * 4, tid, nt);
      prefetch_l2(gws + st, (long long)K * V * 4, tid, nt);
    }
  }

  // 4-6. the group's dr', dk', dv in the accumulators: warp wg owns the n8
  // column tiles wg and wg + GW of K (dr', dk') and of V (dv); each product
  // is summed from zero and added with its scale
  float ar[WJ][4], ak[WJ][4], av[WJ][4];
#pragma unroll
  for (int i = 0; i < WJ; ++i) zero(ar[i]), zero(ak[i]), zero(av[i]);
  int nk[WJ];
  bool okk[WJ], okv[WJ];
#pragma unroll
  for (int i = 0; i < WJ; ++i) {
    nk[i] = 8 * (wg + GW * i);
    okk[i] = nk[i] < kp;
    okv[i] = nk[i] < vp;
  }
  // the accumulator element (i, h, e): row 8 h + g of the tile, column
  // nk[i] + 2 tq + e
  auto scale_add = [&](float (&acc)[WJ][4], const float (&d)[WJ][4], auto&& f) {
#pragma unroll
    for (int i = 0; i < WJ; ++i)
      if (okk[i])
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            acc[i][2 * h + e] += f(SUB * h + g, nk[i] + 2 * tq + e) * d[i][2 * h + e];
  };
  if (live > 0) {
    // 4. the diagonal block.  Its two exact blocks, a column a thread:
    // thread (block h, column col) keeps the block's r, k, b_prev and b of
    // its column in registers and takes each of the block's live terms with
    // one exp2, adding to dr' of the later row and dk' of the earlier one;
    // the sums meet the accumulators through the group's scratch
    static_assert(GT == 2 * 8 * GW * WJ, "a group's threads: two blocks of 8 GW WJ columns");
    {
      const int h = gt / (GT / 2), col = gt - h * (GT / 2), a0 = j0 + SUB * h;
      if (col < kp) {
        float rv[SUB], kv[SUB], bpv[SUB], bv[SUB], sr[SUB], sk[SUB];
#pragma unroll
        for (int q = 0; q < SUB; ++q) {
          rv[q] = to_f32(rt[(a0 + q) * ldkt + col]);
          kv[q] = to_f32(kt[(a0 + q) * ldkt + col]);
          bpv[q] = bz[(a0 + q) * ldk + col];
          bv[q] = bz[(a0 + q + 1) * ldk + col];
          sr[q] = sk[q] = 0.f;
        }
        const float* dA = pag + SUB * h * ldc + a0;   // dA[t][s] of the block's rows
#pragma unroll
        for (int t = 1; t < SUB; ++t)
#pragma unroll
          for (int q = 0; q < t; ++q) {
            const float w = dA[t * ldc + q] * ex2(bpv[t] - bv[q]);
            sr[t] += w * kv[q];
            sk[q] += w * rv[t];
          }
#pragma unroll
        for (int q = 0; q < SUB; ++q) {
          xdr[(SUB * h + q) * ldk + col] = sr[q];
          xdk[(SUB * h + q) * ldk + col] = sk[q];
        }
      }
    }
    group_sync();
#pragma unroll
    for (int i = 0; i < WJ; ++i) {
      if (!okk[i]) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = (SUB * h + g) * ldk + nk[i] + 2 * tq + e;
          ar[i][2 * h + e] = xdr[o];
          ak[i][2 * h + e] = xdk[o];
        }
    }
    // the block below the first, about rho8: dr' of rows 8..15 +=
    // 2^{b_prev - rho8} (dA[8:16, 0:8] (k 2^{rho8 - b})), dk' of rows 0..7 +=
    // 2^{rho8 - b} (dA[8:16, 0:8]^T (r 2^{b_prev - rho8}))
    {
      const float* rho8 = bz + (j0 + SUB) * ldk;
      const float xr[4] = {0.f, pag[(SUB + g) * ldc + j0 + tq], 0.f,
                           pag[(SUB + g) * ldc + j0 + tq + 4]};
      const float xk[4] = {pag[(SUB + tq) * ldc + j0 + g], 0.f,
                           pag[(SUB + tq + 4) * ldc + j0 + g], 0.f};
      const M::A Ar = make_a(xr), Ak = make_a(xk);
      float d1[WJ][4], d2[WJ][4];
#pragma unroll
      for (int i = 0; i < WJ; ++i) {
        zero(d1[i]), zero(d2[i]);
        if (!okk[i]) continue;
        const int col = nk[i] + g;
        const float kv[2] = {
            to_f32(kt[(j0 + tq) * ldkt + col]) * ex2(rho8[col] - bz[(j0 + tq + 1) * ldk + col]),
            to_f32(kt[(j0 + tq + 4) * ldkt + col]) * ex2(rho8[col] - bz[(j0 + tq + 5) * ldk + col])};
        const float qv[2] = {
            to_f32(rt[(j0 + SUB + tq) * ldkt + col]) *
                ex2(bz[(j0 + SUB + tq) * ldk + col] - rho8[col]),
            to_f32(rt[(j0 + SUB + tq + 4) * ldkt + col]) *
                ex2(bz[(j0 + SUB + tq + 4) * ldk + col] - rho8[col])};
        M::mma(d1[i], Ar, make_b(kv));
        M::mma(d2[i], Ak, make_b(qv));
      }
      scale_add(ar, d1, [&](int t, int col) {
        return t >= SUB ? ex2(bz[(j0 + t) * ldk + col] - rho8[col]) : 0.f;
      });
      scale_add(ak, d2, [&](int t, int col) {
        return t < SUB ? ex2(rho8[col] - bz[(j0 + t + 1) * ldk + col]) : 0.f;
      });
    }
    // dv += A_JJ^T dout
    {
      float d[WJ][4];
#pragma unroll
      for (int i = 0; i < WJ; ++i) zero(d[i]);
#pragma unroll
      for (int k0 = 0; k0 < TILE; k0 += 8) {
        const M::A a = M::load_a(pdg + k0, ldp, lane);
#pragma unroll
        for (int i = 0; i < WJ; ++i)
          if (okv[i])
            mma_x<false, XI>(d[i], a, frag_b<XI>(dt + (j0 + k0) * ldvt + nk[i], ldvt, g, tq));
      }
#pragma unroll
      for (int i = 0; i < WJ; ++i) add(av[i], d[i]);
    }

    // 5. the chunk's states: dr' += 2^{b_prev} (dout S_c^T), dk' += 2^{b_C -
    // b} (v G'^T), dv += (k 2^{b_C - b}) G'
    {
      float d1[WJ][4], d2[WJ][4], d3[WJ][4];
#pragma unroll
      for (int i = 0; i < WJ; ++i) zero(d1[i]), zero(d2[i]), zero(d3[i]);
      for (int k0 = 0; k0 < vp; k0 += 8) {
        const M::A a1 = frag_a<XI>(dt + j0 * ldvt + k0, ldvt, g, tq);
        const M::A a2 = frag_a<XI>(vt + j0 * ldvt + k0, ldvt, g, tq);
#pragma unroll
        for (int i = 0; i < WJ; ++i)
          if (okk[i]) {
            mma_x<XI, false>(d1[i], a1, M::load_bt(ss + nk[i] * ldv + k0, ldv, lane));
            mma_x<XI, false>(d2[i], a2, M::load_bt(sg + nk[i] * ldv + k0, ldv, lane));
          }
      }
      for (int k0 = 0; k0 < kp; k0 += 8) {
        const int ka = k0 + tq, kb = ka + 4;
        const Tin* k1 = kt + (j0 + g) * ldkt;
        const Tin* k2 = kt + (j0 + g + 8) * ldkt;
        const float* b1 = bz + (j0 + g + 1) * ldk;
        const float* b2 = bz + (j0 + g + 9) * ldk;
        const float x[4] = {to_f32(k1[ka]) * ex2(bC[ka] - b1[ka]), to_f32(k2[ka]) * ex2(bC[ka] - b2[ka]),
                            to_f32(k1[kb]) * ex2(bC[kb] - b1[kb]), to_f32(k2[kb]) * ex2(bC[kb] - b2[kb])};
        const M::A a = make_a(x);
#pragma unroll
        for (int i = 0; i < WJ; ++i)
          if (okv[i]) M::mma(d3[i], a, M::load_b(sg + k0 * ldv + nk[i], ldv, lane));
      }
      scale_add(ar, d1, [&](int t, int col) { return ex2(bz[(j0 + t) * ldk + col]); });
      scale_add(ak, d2, [&](int t, int col) { return ex2(bC[col] - bz[(j0 + t + 1) * ldk + col]); });
#pragma unroll
      for (int i = 0; i < WJ; ++i) add(av[i], d3[i]);
    }

    // 6. the other tiles.  The earlier rows, one product about rho: dr' +=
    // 2^{b_prev - rho} (dA[:, 0:j0] (k 2^{rho - b}))
    if (J > 0) {
      float d[WJ][4];
#pragma unroll
      for (int i = 0; i < WJ; ++i) zero(d[i]);
      for (int s0 = 0; s0 < j0; s0 += 8) {
        const M::A a = M::load_a(pag + s0, ldc, lane);
        const int sa = s0 + tq, sb = sa + 4;
#pragma unroll
        for (int i = 0; i < WJ; ++i) {
          if (!okk[i]) continue;
          const int col = nk[i] + g;
          const float bv[2] = {
              to_f32(kt[sa * ldkt + col]) * ex2(rho[col] - bz[(sa + 1) * ldk + col]),
              to_f32(kt[sb * ldkt + col]) * ex2(rho[col] - bz[(sb + 1) * ldk + col])};
          M::mma(d[i], a, make_b(bv));
        }
      }
      scale_add(ar, d, [&](int t, int col) { return ex2(bz[(j0 + t) * ldk + col] - rho[col]); });
    }
    // each later live tile L, about its rho_L, from its blocks (read
    // transposed: rows s of this tile, columns t of L): dv += A_{L,J}^T
    // dout_L, dk' += 2^{rho_L - b} (dA_{L,J}^T Q_L)
    for (int Lt = J + 1; Lt * TILE < n; ++Lt) {
      const int m0 = Lt * TILE;
      const float* paL = pa + Lt * TILE * ldc + j0;
      const float* pAL = pA + Lt * TILE * ldc + j0;
      const float* rhoL = bz + m0 * ldk;
      float d1[WJ][4], d2[WJ][4];
#pragma unroll
      for (int i = 0; i < WJ; ++i) zero(d1[i]), zero(d2[i]);
#pragma unroll
      for (int k0 = 0; k0 < TILE; k0 += 8) {
        const int ta = (k0 + tq) * ldc, tb = (k0 + tq + 4) * ldc;
        const float x1[4] = {pAL[ta + g], pAL[ta + g + 8], pAL[tb + g], pAL[tb + g + 8]};
        const float x2[4] = {paL[ta + g], paL[ta + g + 8], paL[tb + g], paL[tb + g + 8]};
        const M::A a1 = make_a(x1), a2 = make_a(x2);
#pragma unroll
        for (int i = 0; i < WJ; ++i) {
          if (okv[i])
            mma_x<false, XI>(d1[i], a1, frag_b<XI>(dt + (m0 + k0) * ldvt + nk[i], ldvt, g, tq));
          if (okk[i]) M::mma(d2[i], a2, M::load_b(qb + (m0 + k0) * ldk + nk[i], ldk, lane));
        }
      }
#pragma unroll
      for (int i = 0; i < WJ; ++i) add(av[i], d1[i]);
      scale_add(ak, d2, [&](int t, int col) { return ex2(rhoL[col] - bz[(j0 + t + 1) * ldk + col]); });
    }
  }

  // 7. dlogw within the chunk, the suffix sum of x = r dr' - k dk' less
  // r dr' of the row itself: within the tile by shuffles (lane g holds rows
  // g and g + 8 of its columns), then the later tiles' totals; the chunk's
  // totals of x and of du's terms, one partial row a chunk
  float sx[WJ][2][2], sxr[WJ][2][2];   // [i][e][h]
  if (live > 0) {
#pragma unroll
    for (int i = 0; i < WJ; ++i) {
      if (!okk[i]) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = nk[i] + 2 * tq + e;
        float x[2], du_t = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = SUB * h + g;
          const float rv = to_f32(rt[(j0 + t) * ldkt + col]), kv = to_f32(kt[(j0 + t) * ldkt + col]);
          sxr[i][e][h] = rv * ar[i][2 * h + e];
          x[h] = sxr[i][e][h] - kv * ak[i][2 * h + e];
          du_t += rv * kv * bon[j0 + t];
        }
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int d = 1; d < SUB; d <<= 1) {
            const float y = __shfl_down_sync(FULL, x[h], 4 * d);
            if (g + d < SUB) x[h] += y;
          }
        x[0] += __shfl_sync(FULL, x[1], tq);
        sx[i][e][0] = x[0], sx[i][e][1] = x[1];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) du_t += __shfl_xor_sync(FULL, du_t, o);
        if (g == 0) xt[J * kp + col] = x[0], ut[J * kp + col] = du_t;
      }
    }
  } else {
    for (int kk = gt; kk < kp; kk += GT) xt[J * kp + kk] = ut[J * kp + kk] = 0.f;
  }
  __syncthreads();   // every tile's totals
  if (live <= 0) return;
#pragma unroll
  for (int i = 0; i < WJ; ++i) {
    const int col = nk[i] + 2 * tq;
    if (!okk[i] || col >= K) continue;
    float carry[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 2; ++e)
      for (int Lt = L.groups - 1; Lt > J; --Lt) carry[e] += xt[Lt * kp + col + e];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (SUB * h + g < live)
        put_pair(dlw + (row0 + j0 + SUB * h + g) * K + col,
                 (sx[i][0][h] - sxr[i][0][h]) + carry[0], (sx[i][1][h] - sxr[i][1][h]) + carry[1],
                 K % 2 == 0, col + 1 < K);
    if (J == 0 && g == 0)
#pragma unroll
      for (int e = 0; e < 2 && col + e < K; ++e) {
        float us = 0.f;
        for (int Lt = 0; Lt < L.groups; ++Lt) us += ut[Lt * kp + col + e];
        xpart[(bh * n_chunks + c) * K + col + e] = sx[i][e][0] + carry[e];
        upart[(bh * n_chunks + c) * K + col + e] = us;
      }
  }

  // 8. dr, dk, dv with the u terms, once, from the accumulators, in the
  // inputs' type
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = SUB * h + g;
    if (t >= live) continue;
    const long long o = row0 + j0 + t;
    const float bn = bon[j0 + t], rk = rkb[j0 + t];
#pragma unroll
    for (int i = 0; i < WJ; ++i) {
      const int col = nk[i] + 2 * tq;
      if (okk[i] && col < K) {
        const Tin* rr = rt + (j0 + t) * ldkt + col;
        const Tin* kr = kt + (j0 + t) * ldkt + col;
        const bool pair = K % 2 == 0, second = col + 1 < K;
        put_pair(dr + o * K + col, ar[i][2 * h] + uf[col] * to_f32(kr[0]) * bn,
                 ar[i][2 * h + 1] + uf[col + 1] * to_f32(kr[1]) * bn, pair, second);
        put_pair(dk + o * K + col, ak[i][2 * h] + uf[col] * to_f32(rr[0]) * bn,
                 ak[i][2 * h + 1] + uf[col + 1] * to_f32(rr[1]) * bn, pair, second);
      }
      if (okv[i] && col < V) {
        const Tin* dd = dt + (j0 + t) * ldvt + col;
        put_pair(dv + o * V + col, av[i][2 * h] + rk * to_f32(dd[0]),
                 av[i][2 * h + 1] + rk * to_f32(dd[1]), V % 2 == 0, col + 1 < V);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 3. the finishing pass
// ---------------------------------------------------------------------------

// dlogw of a part's rows = its in-chunk value + the dS_T term + the later
// parts' totals (added last part first); du = the parts' terms in order
// (the blocks of part 0).  A part is R rows of a chunk, P parts a chunk: a
// chunk (R = C, P = 1) or a tile (R = TILE).  Threads: FIN_X columns times
// FIN_ROWS slices of the rows.  dlw may be dlogw itself (float32 logw):
// each element is read and then written by one thread.
__global__ void __launch_bounds__(FIN_X * FIN_ROWS)
wkv_finish_kernel(const float* dlw, void* dlogw, int logw_code, const float* __restrict__ xpart,
                  const float* __restrict__ upart, void* __restrict__ du, int u_code,
                  const float* __restrict__ dstate, const float* __restrict__ state, int T, int K,
                  int V, int C, int R, int P) {
  const long long bh = blockIdx.x;
  const int part = blockIdx.y, n_parts = gridDim.y;
  const int c = part / P, J = part - c * P;
  const int n = min(C, T - c * C), lo = J * R, hi = min(n, lo + R);
  const int tx = threadIdx.x % FIN_X, ty = threadIdx.x / FIN_X;
  for (int kk = tx; kk < K; kk += FIN_X) {
    float carry = 0.f;
    if (dstate != nullptr)
      for (int vv = 0; vv < V; ++vv) {
        const long long o = (bh * K + kk) * V + vv;
        carry += dstate[o] * state[o];
      }
    for (int m = n_parts - 1; m > part; --m) carry += xpart[(bh * n_parts + m) * K + kk];
    for (int t = lo + ty; t < hi; t += FIN_ROWS) {
      const long long o = (bh * T + (long long)c * C + t) * K + kk;
      const float x = dlw[o] + carry;
      store_any(dlogw, o, logw_code, x);
    }
    if (part == 0 && ty == 0) {
      float s = 0.f;
      for (int m = 0; m < n_parts; ++m) s += upart[(bh * n_parts + m) * K + kk];
      store_any(du, bh * K + kk, u_code, s);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

constexpr int MAX_DEVICES = 64;

// A row of PLAN: the gradients pass's instance (0: one block a chunk, its
// tiles resident; 1: one block a tile) for chunks of up to `c_max` rows (C
// rounded up to TILE) at K up to `k_max` and V up to `v_max` (0: any).  A
// call takes the first row that holds its (C, K, V) and whose block's
// shared memory is within SMEM_LIMIT; none: the call is refused.  Mirrored
// by PLAN in kernels/rwkv_chunk_bwd.py, which a CPU test holds equal to
// this table.
struct PlanRow {
  int instance, c_max, k_max, v_max;
};
constexpr PlanRow PLAN[] = {
    // instance, c_max, k_max, v_max
    {0, 64, 64, 64},
    {1, 0, 0, 0},
};
constexpr int PLAN_ROWS = sizeof(PLAN) / sizeof(PLAN[0]);
static_assert(PLAN[0].instance == 0 && PLAN[0].c_max <= TILE * MAX_GROUPS &&
                  PLAN[0].k_max <= 8 * GW * WJ && PLAN[0].v_max <= 8 * GW * WJ,
              "the chunk instance is built for up to MAX_GROUPS tiles and 8 GW WJ columns");

int grads_smem(int instance, int C, int K, int V, int isz) {
  return instance == 0 ? chunk_layout(C, K, V, isz).total : grad_layout(C, K, V).total;
}

// the instance PLAN gives (C, K, V) at inputs of `isz` bytes, or -1
int plan_instance(int C, int K, int V, int isz) {
  const int cp = (C + TILE - 1) / TILE * TILE;
  for (int i = 0; i < PLAN_ROWS; ++i) {
    const PlanRow& p = PLAN[i];
    if ((p.c_max && cp > p.c_max) || (p.k_max && K > p.k_max) || (p.v_max && V > p.v_max))
      continue;
    if (grads_smem(p.instance, C, K, V, isz) <= SMEM_LIMIT) return p.instance;
  }
  return -1;
}

struct Args {
  const void *r, *k, *v, *logw, *u, *dout, *dstate, *state, *sws;
  void *gws, *dr, *dk, *dv, *dlogw, *du, *dlw, *xpart, *upart, *ds0;
  long long BH;
  int T, K, V, C, logw_code, u_code, instance, grads_smem;
};

// raise the instance's dynamic shared memory to the whole limit, once per
// device, not per launch
template <typename F>
cudaError_t opt_in(F kern, bool (&done)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return err;
}

// the current device's SMs (0 where they cannot be read), once per device
int sm_count() {
  static int count[MAX_DEVICES] = {};
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= MAX_DEVICES) return 0;
  if (!count[dev] && cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess)
    count[dev] = n;
  return count[dev];
}

template <typename Tin>
cudaError_t launch_all(const Args& a, cudaStream_t s) {
  const dim3 sgrid((unsigned)a.BH, (unsigned)((a.K + KT - 1) / KT),
                   (unsigned)((a.V + BVS - 1) / BVS));
  wkv_rstates_kernel<Tin><<<sgrid, 32, 0, s>>>((const Tin*)a.r, (const Tin*)a.dout, a.logw,
                                               a.logw_code, (const float*)a.dstate,
                                               (float*)a.gws, (float*)a.ds0, a.T, a.K, a.V,
                                               a.C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_chunks = (a.T + a.C - 1) / a.C, tpc = (a.C + TILE - 1) / TILE;
  // a part of the finishing pass: the chunk, or a tile of it
  const int R = a.instance == 0 ? a.C : TILE, P = a.instance == 0 ? 1 : tpc;
  if (a.instance == 0) {
    static bool done[MAX_DEVICES] = {};
    auto kern = wkv_grads_chunk_kernel<Tin>;
    err = opt_in(kern, done);
    if (err != cudaSuccess) return err;
    kern<<<dim3((unsigned)a.BH, (unsigned)n_chunks), GT * tpc, a.grads_smem, s>>>(
        (const Tin*)a.r, (const Tin*)a.k, (const Tin*)a.v, a.logw, a.logw_code, a.u, a.u_code,
        (const Tin*)a.dout, (const float*)a.sws, (const float*)a.gws, (Tin*)a.dr, (Tin*)a.dk,
        (Tin*)a.dv, (float*)a.dlw, (float*)a.xpart, (float*)a.upart, a.T, a.K, a.V, a.C,
        sm_count());
  } else {
    static bool done[MAX_DEVICES] = {};
    auto kern = wkv_grads_tile_kernel<Tin>;
    err = opt_in(kern, done);
    if (err != cudaSuccess) return err;
    kern<<<dim3((unsigned)a.BH, (unsigned)(n_chunks * tpc)), 32 * NW, a.grads_smem, s>>>(
        (const Tin*)a.r, (const Tin*)a.k, (const Tin*)a.v, a.logw, a.logw_code, a.u, a.u_code,
        (const Tin*)a.dout, (const float*)a.sws, (const float*)a.gws, (Tin*)a.dr, (Tin*)a.dk,
        (Tin*)a.dv, (float*)a.dlw, (float*)a.xpart, (float*)a.upart, a.T, a.K, a.V, a.C);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wkv_finish_kernel<<<dim3((unsigned)a.BH, (unsigned)(n_chunks * P)), FIN_X * FIN_ROWS, 0, s>>>(
      (const float*)a.dlw, a.dlogw, a.logw_code, (const float*)a.xpart, (const float*)a.upart,
      a.du, a.u_code, (const float*)a.dstate, (const float*)a.state, a.T, a.K, a.V, a.C, R, P);
  return cudaGetLastError();
}

}  // namespace

// r, k, logw, dr, dk, dlogw: [BH, T, K]; v, dout, dv: [BH, T, V]; u, du:
// [BH, K]; dstate (null for zero) and state (the forward's final state,
// read only with dstate): [BH, K, V] float32; sws (the forward's states
// entering each chunk, read) and gws (written): [BH, ceil(T / C), K, V]
// float32; dlw: [BH, T, K] float32 scratch (may be dlogw when logw is
// float32); xpart, upart: [BH, ceil(T / C) * P, K] float32 scratch, P = 1
// where PLAN gives the chunk instance, ceil(C / 16) where it gives the tile
// one.  All dense.  dtype is the type of r, k, v, dout, dr, dk, dv;
// logw_dtype (of logw and dlogw) and u_dtype (of u and du) are each 0 =
// float32 or 1 = bfloat16.  ds0: [BH, K, V] float32, the initial state's
// gradient, written where it is not null.  1 <= C <= T.  Launches the reverse states, the
// gradients and the finishing pass on `stream`; returns the first error (an
// invalid value where PLAN has no instance for (C, K, V)).
extern "C" int repro_wkv_chunked_bwd(const void* r, const void* k, const void* v,
                                     const void* logw, const void* u, const void* dout,
                                     const void* dstate, const void* state, const void* sws,
                                     void* gws, void* dr, void* dk, void* dv, void* dlogw,
                                     void* du, void* dlw, void* xpart, void* upart, void* ds0,
                                     long long BH,
                                     int T, int K, int V, int C, int dtype, int logw_dtype,
                                     int u_dtype, void* stream) {
  if (BH <= 0 || BH > INT_MAX || T <= 0 || K <= 0 || V <= 0 || C <= 0 || C > T ||
      (dtype != 0 && dtype != 1) || (logw_dtype != 0 && logw_dtype != 1) ||
      (u_dtype != 0 && u_dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int isz = dtype == 0 ? 4 : 2;
  const int instance = plan_instance(C, K, V, isz);
  const long long n_chunks = (T + C - 1) / C, tpc = (C + TILE - 1) / TILE;
  if (instance < 0 || n_chunks * tpc > 65535 || (K + KT - 1) / KT > 65535 ||
      (V + BVS - 1) / BVS > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{r,  k,  v,     logw, u,   dout,  dstate, state, sws,
               gws, dr, dk, dv, dlogw, du, dlw, xpart, upart, ds0,
               BH, T, K, V, C, logw_dtype, u_dtype, instance,
               grads_smem(instance, C, K, V, isz)};
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(dtype == 0 ? launch_all<float>(a, s) : launch_all<__nv_bfloat16>(a, s));
}
