// Backward of the chunked RWKV-6 WKV recurrence from a zero state, for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel: it is the VJP that `jax.grad` takes of the jnp
// `wkv_chunked` of src/repro/models/rwkv6.py:100 (the reference trains
// through that form, never through its Pallas kernel).  The forward is
// csrc/wkv_chunked.cu; per token t, S_0 = 0:
//
//   out[t] = r[t]^T (S[t-1] + diag(u) k[t] v[t]^T),   S[t] = diag(e^{logw[t]}) S[t-1] + k[t] v[t]^T
//
// Given dout and an optional dS_T (null: zero), it returns dr, dk, dv (in
// the type of r, k, v), dlogw (logw's type) and du (u's type).  Per chunk
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
// 2. The gradients pass (`wkv_grads_kernel`), grid (bh, chunk x tile of
//    TILE = 16 rows), NW warps a block: every tile of every chunk at once.
//    A block holds its chunk's cumsum b (log2 units) and its own tile's r,
//    k, v and dout in float32 shared memory, and stages one other tile of
//    the chunk at a time.  Its tile's diagonal block is exact: one exp2 of
//    b_prev[t] - b[s] a term.  Every other product is factored about a
//    tile's first row, rho = b_prev[j0] of the later tile of the pair, so
//    both factors' exponents are <= 0 at any decay (a chunk's decay passes
//    e^88 at RWKV-6's, where a reference at the chunk's start overflows):
//    dr from each earlier tile I, (dout v_I^T) (k_I 2^{rho - b_I}) scaled by
//    2^{b_prev - rho}; dk and dv from each later tile L, with
//    Q_L = r_L 2^{b_prev - rho_L} and k 2^{rho_L - b}.  The inter-chunk terms
//    read S_c and G' into shared memory.  Products are warp tiles of
//    mma.sync m16n8k8 in 3xTF32 (`mma.cuh`), summed into float32 shared
//    accumulators; dr, dk and dv are written once, in the inputs' types;
//    each tile's dlogw is written without the later tiles' totals (float32),
//    and its totals of the suffix sum and of du go to small partials.
// 3. The finishing pass (`wkv_finish_kernel`), grid (bh, tile): adds to each
//    row's dlogw the later tiles' totals and the dS_T term, in the output's
//    type, and sums du over the tiles.
//
// Repeatability: no atomics; every sum runs in a fixed order, so two calls
// give the same bits.  Rows past T are neither read nor written; C is a
// run-time argument (the chunk's cumsum must fit in shared memory).
//
// Bound on this card: bytes.  At RWKV-6's trained shape (BH = 128, T = 512,
// K = V = 64, C = 64, bf16 r/k/v/dout, float32 logw) the inputs and outputs
// are ~92 MB (~28 us at 3.35 TB/s) against ~5 GFLOP of products (~10 us at
// TF32's 495 TFLOP/s).  The two float32 workspaces (entering states and G')
// add ~34 MB read and ~17 MB written, and every tile-block re-reads its
// chunk's logw, S_c and G' (through L2).  This first kernel is simple: its
// exact diagonal blocks' exponentials, its shared-memory round trips and
// the serial reverse pass bound it before the bytes do (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

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
constexpr int NW = 4;                // warps of a gradients-pass block
constexpr int FIN_THREADS = 64;      // threads of a finishing block
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
                   const float* __restrict__ dstate, float* __restrict__ gws, int T, int K, int V,
                   int C) {
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
}

// ---------------------------------------------------------------------------
// 2. the gradients pass
// ---------------------------------------------------------------------------

// Float offsets of a gradients-pass block's shared memory, all float32.
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
wkv_grads_kernel(const Tin* __restrict__ r, const Tin* __restrict__ k, const Tin* __restrict__ v,
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
// 3. the finishing pass
// ---------------------------------------------------------------------------

// dlogw of the tile's rows = its in-tile value + the dS_T term + the later
// tiles' totals (added last tile first); du = the tiles' terms in order
// (the blocks of tile 0).  dlw may be dlogw itself (float32 logw): each
// element is read and then written by one thread.
__global__ void __launch_bounds__(FIN_THREADS)
wkv_finish_kernel(const float* dlw, void* dlogw, int logw_code, const float* __restrict__ xpart,
                  const float* __restrict__ upart, void* __restrict__ du, int u_code,
                  const float* __restrict__ dstate, const float* __restrict__ state, int T, int K,
                  int V, int C, int tpc) {
  const long long bh = blockIdx.x;
  const int tile = blockIdx.y, n_tiles = gridDim.y;
  const int c = tile / tpc, J = tile - c * tpc;
  const int n = min(C, T - c * C), lo = J * TILE, hi = min(n, lo + TILE);
  for (int kk = threadIdx.x; kk < K; kk += blockDim.x) {
    float carry = 0.f;
    if (dstate != nullptr)
      for (int vv = 0; vv < V; ++vv) {
        const long long o = (bh * K + kk) * V + vv;
        carry += dstate[o] * state[o];
      }
    for (int m = n_tiles - 1; m > tile; --m) carry += xpart[(bh * n_tiles + m) * K + kk];
    for (int t = lo; t < hi; ++t) {
      const long long o = (bh * T + (long long)c * C + t) * K + kk;
      const float x = dlw[o] + carry;
      store_any(dlogw, o, logw_code, x);
    }
    if (tile == 0) {
      float s = 0.f;
      for (int m = 0; m < n_tiles; ++m) s += upart[(bh * n_tiles + m) * K + kk];
      store_any(du, bh * K + kk, u_code, s);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

constexpr int MAX_DEVICES = 64;

struct Args {
  const void *r, *k, *v, *logw, *u, *dout, *dstate, *state, *sws;
  void *gws, *dr, *dk, *dv, *dlogw, *du, *dlw, *xpart, *upart;
  long long BH;
  int T, K, V, C, logw_code, u_code, grads_smem;
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

template <typename Tin>
cudaError_t launch_all(const Args& a, cudaStream_t s) {
  const dim3 sgrid((unsigned)a.BH, (unsigned)((a.K + KT - 1) / KT),
                   (unsigned)((a.V + BVS - 1) / BVS));
  wkv_rstates_kernel<Tin><<<sgrid, 32, 0, s>>>((const Tin*)a.r, (const Tin*)a.dout, a.logw,
                                               a.logw_code, (const float*)a.dstate,
                                               (float*)a.gws, a.T, a.K, a.V, a.C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  static bool done[MAX_DEVICES] = {};
  auto kern = wkv_grads_kernel<Tin>;
  err = opt_in(kern, done);
  if (err != cudaSuccess) return err;
  const int n_chunks = (a.T + a.C - 1) / a.C, tpc = (a.C + TILE - 1) / TILE;
  const dim3 ggrid((unsigned)a.BH, (unsigned)(n_chunks * tpc));
  kern<<<ggrid, 32 * NW, a.grads_smem, s>>>(
      (const Tin*)a.r, (const Tin*)a.k, (const Tin*)a.v, a.logw, a.logw_code, a.u, a.u_code,
      (const Tin*)a.dout, (const float*)a.sws, (const float*)a.gws, (Tin*)a.dr, (Tin*)a.dk,
      (Tin*)a.dv, (float*)a.dlw, (float*)a.xpart, (float*)a.upart, a.T, a.K, a.V, a.C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wkv_finish_kernel<<<ggrid, FIN_THREADS, 0, s>>>(
      (const float*)a.dlw, a.dlogw, a.logw_code, (const float*)a.xpart, (const float*)a.upart,
      a.du, a.u_code, (const float*)a.dstate, (const float*)a.state, a.T, a.K, a.V, a.C, tpc);
  return cudaGetLastError();
}

}  // namespace

// r, k, logw, dr, dk, dlogw: [BH, T, K]; v, dout, dv: [BH, T, V]; u, du:
// [BH, K]; dstate (null for zero) and state (the forward's final state,
// read only with dstate): [BH, K, V] float32; sws (the forward's states
// entering each chunk, read) and gws (written): [BH, ceil(T / C), K, V]
// float32; dlw: [BH, T, K] float32 scratch (may be dlogw when logw is
// float32); xpart, upart: [BH, ceil(T / C) * ceil(C / 16), K] float32
// scratch.  All dense.  dtype is the type of r, k, v, dout, dr, dk, dv;
// logw_dtype (of logw and dlogw) and u_dtype (of u and du) are each 0 =
// float32 or 1 = bfloat16.  1 <= C <= T.  Launches the reverse states, the
// gradients and the finishing pass on `stream`; returns the first error.
extern "C" int repro_wkv_chunked_bwd(const void* r, const void* k, const void* v,
                                     const void* logw, const void* u, const void* dout,
                                     const void* dstate, const void* state, const void* sws,
                                     void* gws, void* dr, void* dk, void* dv, void* dlogw,
                                     void* du, void* dlw, void* xpart, void* upart, long long BH,
                                     int T, int K, int V, int C, int dtype, int logw_dtype,
                                     int u_dtype, void* stream) {
  if (BH <= 0 || BH > INT_MAX || T <= 0 || K <= 0 || V <= 0 || C <= 0 || C > T ||
      (dtype != 0 && dtype != 1) || (logw_dtype != 0 && logw_dtype != 1) ||
      (u_dtype != 0 && u_dtype != 1))
    return (int)cudaErrorInvalidValue;
  const long long n_chunks = (T + C - 1) / C, tpc = (C + TILE - 1) / TILE;
  const long long smem = grad_layout(C, K, V).total;
  if (n_chunks * tpc > 65535 || (K + KT - 1) / KT > 65535 || (V + BVS - 1) / BVS > 65535 ||
      smem > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const Args a{r,  k,  v,     logw, u,   dout,  dstate, state, sws,
               gws, dr, dk, dv, dlogw, du, dlw, xpart, upart,
               BH, T, K, V, C, logw_dtype, u_dtype, (int)smem};
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(dtype == 0 ? launch_all<float>(a, s) : launch_all<__nv_bfloat16>(a, s));
}
