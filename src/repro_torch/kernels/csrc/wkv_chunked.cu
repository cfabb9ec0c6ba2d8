// Chunked RWKV-6 WKV recurrence from a given state (or zero), for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `wkv_chunked` (`_wkv_kernel`) of
// src/repro/kernels/rwkv_chunk.py.  Per chunk of C tokens, with
// b = cumsum(logw) over the chunk and b_prev = b - logw (the cumsum up to
// t - 1), S the state entering the chunk:
//
//   out[t] = (r[t] * e^{b_prev[t]}) @ S + sum_{s<t} A[t,s] v[s] + (sum_k r u k)[t] v[t]
//   A[t,s] = sum_k r[t,k] k[s,k] e^{b_prev[t,k] - b[s,k]}                     (s < t)
//   S     <- e^{b_C} * S + (k * e^{b_C - b})^T @ v
//
// On the TPU one grid step runs one (bh, chunk) in order and carries S in
// VMEM across the chunk axis.  Here blocks run in no order, so the work
// is split in two passes, both launched by one call on one stream:
//
// 1. The states pass (`wkv_states_kernel`), grid (bh, K tile of 16 rows,
//    V tile of BVS = 32 columns), one warp a block.  Only the [K, V] state
//    carries across chunks, and its rows and columns are independent, so a
//    warp owns one 16 x BVS tile of it, in mma accumulators, and walks the
//    sequence in order from the initial state (zero where none is given:
//    a sequence shard starts from the state its predecessor left), SLAB
//    rows at a time, the next
//    STAGES - 1 slabs' k, logw and v in flight by cp.async (zero-filled
//    past T).  Per slab: b = cumsum(logw * log2 e) by a two-level warp
//    scan; the slab is cut at chunk boundaries into segments; at each
//    chunk start the state entering the chunk is written to a float32
//    workspace [BH, n_chunks, K, V]; then S <- 2^{b_e - b_a} S +
//    (k * 2^{b_e - b})^T v over the segment [a, e], the decayed k built in
//    the A fragments, the product on 3xTF32 tensor cores.
// 2. The outputs pass (`wkv_outputs_kernel`), grid (bh, chunk x row tile,
//    V tile of BV = 32 wv columns): every chunk at once.  A block copies
//    its chunk's k, logw and v (the rows up to its tile's end) and its
//    r rows by cp.async, in their input type, takes b in log2 units, and
//    hands its tiles of TILE = 16 rows (one m16 tile) to groups of wv
//    warps (in a zigzag, so that the groups' work evens out); warp h of a
//    group owns 32 columns of the V tile and shares the scores.  For a
//    tile with first row j0 and reference rho = b[j0 - 1] = b_prev[j0]:
//    - its two diagonal blocks of SUB = 8 rows are exact: one exp2 of
//      b_prev[t] - b[s] per live term (s < t), the masked terms skipped,
//      and the bonus sum_k r u k on their diagonal; the block below the
//      first (rows 8-15, columns 0-7) is one product factored about b_prev
//      of row 8;
//    - q = r * 2^{b_prev - rho};
//    - each earlier tile i gives one product
//      A_{j,i} = q @ (k_i * 2^{rho - b_i})^T.  Both exponents are <= 0 for
//      every t in the tile and every s before j0, so no factor can
//      overflow at any decay; a factor that underflows to 0 stands for a
//      product below 2^-126.  A reference at the chunk's start (e^{-b[s]}
//      on k) overflows float32 once a chunk's decay passes e^88, which
//      RWKV-6 decays reach.
//    - A @ v for the tile's own block and each A_{j,i}, through a
//      per-group TILE x TILE buffer (the accumulator layout is not the
//      operand layout);
//    - inter = (q * 2^rho) @ S last, S the state entering the chunk read
//      from the workspace (through L2).  The outputs pass is a
//      programmatic dependent launch: it starts while the states pass
//      runs and waits for it (griddepcontrol.wait) only here.
//    Every product (inter, A_{j,i}, A @ v, the block below the first) runs on the
//    tensor cores in 3xTF32 (`mma.cuh`), for float32 and bfloat16 inputs
//    alike: after the factoring the operands are float32 values.  out is
//    written once, in r's type.
//
// Repeatability: every sum runs in a fixed order (no atomics), so two calls
// give the same bits.  wv, and the warps and rows an outputs-pass block
// owns come from the wrapper's plan(); this file refuses values it is not
// built for.
//
// Bound on this card: bytes.  At RWKV-6's served shape (BH = 128, T = 512,
// K = V = 64, C = 64, bf16 r/k/v, float32 logw and u) the inputs and
// outputs are ~52 MB (~16 us at 3.35 TB/s) against ~2 GFLOP of products.
// The workspace adds 16.8 MB written once and read once (~10 us), and the
// states pass reads k, logw and v again.  Both passes are bound by
// latency and by the exact diagonal's exponentials and shared-memory
// loads before they are bound by bytes (PERF.md has the phases).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "mma.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int SMEM_LIMIT = 232448;   // bytes of shared memory a block may have
constexpr int KT = 16;               // state rows a states-pass warp owns: one m16 tile
constexpr int KTP = KT + 8;          // row pitch of staged k and of b: the A^T loads hit 32 banks
constexpr int NJ = 4;                // n8 tiles of the V columns a warp owns, in either pass
constexpr int BVS = 8 * NJ;          // the states pass's V tile
constexpr int SLAB = 32;             // rows a states-pass warp stages at a time
constexpr int STAGES = 2;            // slabs of a states-pass warp in flight: one ahead
constexpr int MAX_WARPS = 8;         // warps of an outputs-pass block
constexpr int SUB = 8;               // rows of an exact diagonal block of the outputs pass
constexpr int TILE = 16;             // rows of an outputs-pass tile: one m16 tile, two SUBs
constexpr unsigned FULL = 0xffffffffu;
using M = Mma<float>;

// logw and u: 0 = float32, 1 = bfloat16 (the code is uniform over the grid)
__device__ __forceinline__ float load_any(const void* p, long long i, int code) {
  return code == 0 ? static_cast<const float*>(p)[i]
                   : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

// 2^x in one MUFU instruction (relative error about 2^-22; a result below
// 2^-126 is flushed to 0, which stands for a term below the tolerance)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// eight consecutive values from a 16-byte aligned address, as float32
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w, x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    x[2 * e] = f.x, x[2 * e + 1] = f.y;
  }
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

// d[j] += a @ b[j] in 3xTF32, term by term across the tiles, so that no mma
// waits on the one issued just before it
template <int N>
__device__ __forceinline__ void mma3(float (&d)[N][4], const M::A& a, const M::B (&b)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) M::mma1(d[j], a.big, b[j].small);
#pragma unroll
  for (int j = 0; j < N; ++j) M::mma1(d[j], a.small, b[j].big);
#pragma unroll
  for (int j = 0; j < N; ++j) M::mma1(d[j], a.big, b[j].big);
}

// ---------------------------------------------------------------------------
// 1. the states pass
// ---------------------------------------------------------------------------

// Bytes of a states-pass block (one warp): STAGES stages of raw k (16
// columns, rows padded to KTP), logw (16 columns) and v (BVS columns, rows
// padded by 8 elements) rows, so that the fragment loads of a warp hit
// distinct banks, and the slab's cumsum [SLAB][KTP] in float32.
struct StatesLayout {
  int kpitch, wpitch, vpitch, stage, bs, total;
};

__host__ __device__ inline StatesLayout states_layout(int isz, int wsz) {
  StatesLayout L;
  L.kpitch = KTP * isz;
  L.wpitch = KT * wsz;
  L.vpitch = (BVS + 8) * isz;
  L.stage = SLAB * (L.kpitch + L.wpitch + L.vpitch);
  L.bs = STAGES * L.stage;
  L.total = L.bs + SLAB * KTP * 4;
  return L;
}

// `rows` rows of `cols` elements (a multiple of 16 bytes) from row `row0`,
// column `col0` of a [., ld] array to shared memory with row pitch `pitch`
// bytes: 16-byte cp.async copies where the rows are 16-byte aligned, else
// scalars; zero past `live` rows and past `valid` columns.
template <typename R>
__device__ __forceinline__ void copy_rows(unsigned char* dst, int pitch, const R* src,
                                          long long row0, int ld, int col0, int cols, int valid,
                                          int rows, int live, int tid, int nt) {
  constexpr int VE = 16 / sizeof(R);
  const int per_row = cols / VE, dr = nt / per_row, dc = nt - dr * per_row;
  const bool vec = (uintptr_t)src % 16 == 0 && ((long long)ld * sizeof(R)) % 16 == 0;
  if (!vec) {   // plain loads, eight in flight a thread, stored at once
    for (int i0 = tid; i0 < rows * cols; i0 += 8 * nt) {
      R x[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int i = i0 + q * nt, row = i / cols, col = i - row * cols;
        x[q] = i < rows * cols && row < live && col < valid ? src[(row0 + row) * ld + col0 + col]
                                                           : R(0.f);
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int i = i0 + q * nt, row = i / cols, col = i - row * cols;
        if (i < rows * cols) reinterpret_cast<R*>(dst + row * pitch)[col] = x[q];
      }
    }
    return;
  }
  for (int row = tid / per_row, c = tid % per_row; row < rows;) {
    const long long n = row < live ? (long long)valid - c * VE : 0;
    const R* p = n > 0 ? src + (row0 + row) * ld + col0 + c * VE : src;
    copy_chunk<R, VE>(dst + row * pitch + c * 16, p, n, vec, src);
    row += dr, c += dc;
    if (c >= per_row) c -= per_row, ++row;
  }
}

// the accumulator tile S (rows k0 + g, k0 + g + 8; columns v0 + 8 j + 2 tq,
// + 1) to a [K, V] float32 array
__device__ __forceinline__ void store_state(float* dst, const float (&S)[NJ][4], int K, int V,
                                            int k0, int v0, int g, int tq) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = k0 + g + 8 * h;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = v0 + 8 * j + 2 * tq + e;
        if (row < K && col < V) dst[(long long)row * V + col] = S[j][2 * h + e];
      }
    }
}

template <typename Tin>
__global__ void __launch_bounds__(32)
wkv_states_kernel(const Tin* __restrict__ k, const Tin* __restrict__ v,
                  const void* __restrict__ logw, int logw_code,
                  const float* __restrict__ state0, float* __restrict__ ws,
                  float* __restrict__ state, int T, int K, int V, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int isz = sizeof(Tin);
  const StatesLayout L = states_layout(isz, logw_code == 0 ? 4 : 2);
  const int lane = threadIdx.x, g = lane >> 2, tq = lane & 3;
  float* bs = reinterpret_cast<float*>(smem + L.bs);
  const long long bh = blockIdx.x;
  const int k0 = blockIdx.y * KT, v0 = blockIdx.z * BVS;
  const int n_chunks = (T + C - 1) / C, n_slabs = (T + SLAB - 1) / SLAB;
  const int vp = L.vpitch / isz;
  // the outputs pass may start now: it reads the workspace only after
  // griddepcontrol.wait, which returns once this grid has completed
  asm volatile("griddepcontrol.launch_dependents;");

  auto issue = [&](int si) {
    unsigned char* st = smem + (si % STAGES) * L.stage;
    const int live = min(SLAB, T - si * SLAB);
    const long long row0 = bh * T + (long long)si * SLAB;
    copy_rows<Tin>(st, L.kpitch, k, row0, K, k0, KT, K - k0, SLAB, live, lane, 32);
    unsigned char* wst = st + SLAB * L.kpitch;
    if (logw_code == 0)
      copy_rows<float>(wst, L.wpitch, static_cast<const float*>(logw), row0, K, k0, KT, K - k0,
                       SLAB, live, lane, 32);
    else
      copy_rows<__nv_bfloat16>(wst, L.wpitch, static_cast<const __nv_bfloat16*>(logw), row0, K,
                               k0, KT, K - k0, SLAB, live, lane, 32);
    copy_rows<Tin>(st + SLAB * (L.kpitch + L.wpitch), L.vpitch, v, row0, V, v0, BVS, V - v0,
                   SLAB, live, lane, 32);
  };

  // the state from state0, or from a zero start
  float S[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = k0 + g + 8 * h, col = v0 + 8 * j + 2 * tq + e;
        S[j][2 * h + e] = state0 != nullptr && row < K && col < V
                              ? state0[(bh * K + row) * (long long)V + col]
                              : 0.f;
      }

  for (int si = 0; si < STAGES - 1; ++si) {
    if (si < n_slabs) issue(si);
    cp_async_commit();
  }
  for (int si = 0; si < n_slabs; ++si) {
    if (si + STAGES - 1 < n_slabs) issue(si + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();   // slab si has landed
    __syncwarp();
    const unsigned char* st = smem + (si % STAGES) * L.stage;
    const Tin* k_st = reinterpret_cast<const Tin*>(st);
    const unsigned char* w_st = st + SLAB * L.kpitch;
    const Tin* v_st = reinterpret_cast<const Tin*>(st + SLAB * (L.kpitch + L.wpitch));
    const int r0 = si * SLAB, n = min(SLAB, T - r0);

    // b: the slab's cumsum of logw * log2 e, a two-level warp scan: lane
    // (c, h) sums column c over half h of the rows in order (eight rows
    // loaded ahead), then half 1 adds half 0's total, one shuffle
    {
      const int c = lane & (KT - 1), lo = (lane / KT) * (SLAB / 2);
      const int hi = min(n, lo + SLAB / 2);
      float run = 0.f;
      for (int row = lo; row < hi; row += 8) {
        float x[8];
#pragma unroll
        for (int q = 0; q < 8; ++q)
          x[q] = row + q >= hi ? 0.f
                 : logw_code == 0
                     ? reinterpret_cast<const float*>(w_st)[(row + q) * KT + c]
                     : __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(w_st)[(row + q) * KT + c]);
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (row + q < hi) bs[(row + q) * KTP + c] = run += x[q] * LOG2E;
      }
      const float half0 = __shfl_sync(FULL, run, c);
      if (lo)
        for (int row = lo; row < hi; row += 8) {
          float x[8];
#pragma unroll
          for (int q = 0; q < 8; ++q) x[q] = row + q < hi ? bs[(row + q) * KTP + c] : 0.f;
#pragma unroll
          for (int q = 0; q < 8; ++q)
            if (row + q < hi) bs[(row + q) * KTP + c] = x[q] + half0;
        }
    }
    __syncwarp();
    // the segments [a, e) of the slab, cut at chunk boundaries
    for (int a = 0; a < n;) {
      const int ga = r0 + a;
      const int e = min(n, ga / C * C + C - r0);
      if (ga % C == 0)   // the state entering chunk ga / C
        store_state(ws + ((bh * n_chunks + ga / C) * K) * (long long)V, S, K, V, k0, v0, g, tq);
      // S <- 2^{b_e - b_a} S + (k * 2^{b_e - b})^T v, b_e the segment's last
      // row, the decayed k built in the A fragments
      const float* be = bs + (e - 1) * KTP;
      const float eg = be[g], eg8 = be[g + 8];
      float d[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.f;
#pragma unroll 2
      for (int s0 = a & ~7; s0 < e; s0 += 8) {
        const int sa = s0 + tq, sb = sa + 4;
        const bool la = sa >= a && sa < e, lb = sb >= a && sb < e;
        const Tin* ka = k_st + sa * KTP;
        const Tin* kb = k_st + sb * KTP;
        const float* ba_ = bs + sa * KTP;
        const float* bb_ = bs + sb * KTP;
        const float av[4] = {la ? to_f32(ka[g]) * ex2(eg - ba_[g]) : 0.f,
                             la ? to_f32(ka[g + 8]) * ex2(eg8 - ba_[g + 8]) : 0.f,
                             lb ? to_f32(kb[g]) * ex2(eg - bb_[g]) : 0.f,
                             lb ? to_f32(kb[g + 8]) * ex2(eg8 - bb_[g + 8]) : 0.f};
        const M::A A = make_a(av);
        M::B B[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float bv[2] = {to_f32(v_st[sa * vp + 8 * j + g]), to_f32(v_st[sb * vp + 8 * j + g])};
          B[j] = make_b(bv);
        }
        mma3(d, A, B);
      }
      const float* bpre = bs + (a - 1) * KTP;
      const float l0 = eg - (a ? bpre[g] : 0.f), l1 = eg8 - (a ? bpre[g + 8] : 0.f);
      const float e0 = ex2(l0), e1 = ex2(l1);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        S[j][0] = e0 * S[j][0] + d[j][0];
        S[j][1] = e0 * S[j][1] + d[j][1];
        S[j][2] = e1 * S[j][2] + d[j][2];
        S[j][3] = e1 * S[j][3] + d[j][3];
      }
      a = e;
    }
    __syncwarp();   // before the next slab's copies reuse this stage
  }
  cp_async_wait<0>();
  store_state(state + bh * K * (long long)V, S, K, V, k0, v0, g, tq);
}

// ---------------------------------------------------------------------------
// 2. the outputs pass
// ---------------------------------------------------------------------------

// Byte offsets of an outputs-pass block's shared memory.  k, r and v stay
// in their input type (copied by cp.async, converted on read); b, q, u,
// the cumsum's partial totals and each group's block of A are
// float32 (the state tile is read from the workspace, L2).  Row
// pitches, in elements: K values padded to kp + 4 float32 or kp + 8 bf16
// (kp = K rounded up to 8), the V tile (BV = 32 wv columns) to BV + 8
// float32 or BV + 16 bf16, so that every row is whole 16-byte chunks and
// the fragment loads of a warp hit distinct banks; cp = C rounded up to a
// TILE.  A group is the wv warps that share a tile.
struct OutLayout {
  int kp, ldk, ldkt, ldvt, cp, ldp;
  int kt, bz, wraw, rt, qb, vt, uf, tot, pb, total;
};

__host__ __device__ inline OutLayout out_layout(int C, int K, int wv, int warps, int rows,
                                                int isz, int wsz) {
  OutLayout L;
  const int bv = 8 * NJ * wv, groups = warps / wv;
  L.kp = (K + 7) / 8 * 8;
  L.ldk = L.kp + 4;
  L.ldkt = L.kp + 16 / isz;
  L.ldvt = bv + 32 / isz;
  L.cp = (C + TILE - 1) / TILE * TILE;
  L.ldp = TILE + 4;
  int o = 0;
  L.kt = o; o += L.cp * L.ldkt * isz;              // k of the chunk's rows
  L.bz = o; o += (L.cp + 1) * L.ldk * 4;           // bz[0] = 0, bz[s + 1] = b[s] (log2 units)
  L.wraw = o; o += wsz == 4 ? 0 : L.cp * L.kp * 2;  // bf16 logw (float32 logw lands in bz)
  L.rt = o; o += rows * L.ldkt * isz;              // r of the tile's rows
  L.qb = o; o += groups * TILE * L.ldk * 4;        // a group's q
  L.vt = o; o += L.cp * L.ldvt * isz;              // the V tile of v
  L.uf = o; o += L.kp * 4;
  L.tot = o; o += 32 * warps * 4;                  // the cumsum's partial totals
  L.pb = o; o += groups * TILE * L.ldp * 4;        // a group's block of A
  L.total = o;
  return L;
}

// a B fragment of a row-major [k][n] tile in the input type
template <typename Tin>
__device__ __forceinline__ M::B load_b_in(const Tin* s, int ld, int g, int tq) {
  const float v[2] = {to_f32(s[tq * ld + g]), to_f32(s[(tq + 4) * ld + g])};
  return make_b(v);
}

// acc += P @ v_rows for the group's TILE-wide block P of A (in pb) and
// TILE rows of the warp's columns of the V tile
template <typename Tin>
__device__ __forceinline__ void a_times_v(float (&acc)[NJ][4], const float* pb, int ldp,
                                          const Tin* vrows, int ldv, int lane) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int ks = 0; ks < TILE / 8; ++ks) {
    M::B B[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) B[j] = load_b_in(vrows + ks * 8 * ldv + 8 * j, ldv, g, tq);
    mma3(acc, M::load_a(pb + ks * 8, ldp, lane), B);
  }
}

template <typename Tin>
__global__ void __launch_bounds__(32 * MAX_WARPS)
wkv_outputs_kernel(const Tin* __restrict__ r, const Tin* __restrict__ k,
                   const Tin* __restrict__ v, const void* __restrict__ logw, int logw_code,
                   const void* __restrict__ u, int u_code, const float* __restrict__ ws,
                   Tin* __restrict__ out, int T, int K, int V, int C, int rows, int wv) {
  constexpr int TRI = SUB * (SUB + 1) / 2;         // live terms of a diagonal block
  extern __shared__ __align__(16) unsigned char sm[];
  const int nt = blockDim.x, nw = nt / 32, BV = 8 * NJ * wv;
  const int isz = sizeof(Tin);
  const OutLayout L = out_layout(C, K, wv, nw, rows, isz, logw_code == 0 ? 4 : 2);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, tq = lane & 3;
  const int kp = L.kp, ldk = L.ldk, ldkt = L.ldkt, ldvt = L.ldvt, ldp = L.ldp;
  const long long bh = blockIdx.x;
  const int tpc = (C + rows - 1) / rows;          // row tiles a chunk
  const int c = blockIdx.y / tpc, t0 = blockIdx.y % tpc * rows;
  const int c0 = c * C, n = min(C, T - c0);       // live rows of the chunk
  if (t0 >= n) return;
  const int src = min(L.cp, t0 + rows);           // rows of the chunk the tile reads
  const int v0 = blockIdx.z * BV;
  const int n_chunks = (T + C - 1) / C;
  const long long row0 = bh * T + c0;
  Tin* kt = reinterpret_cast<Tin*>(sm + L.kt);
  float* bz = reinterpret_cast<float*>(sm + L.bz);
  const __nv_bfloat16* wraw = reinterpret_cast<const __nv_bfloat16*>(sm + L.wraw);
  Tin* rt = reinterpret_cast<Tin*>(sm + L.rt);
  Tin* vt = reinterpret_cast<Tin*>(sm + L.vt);
  float* uf = reinterpret_cast<float*>(sm + L.uf);

  // 1. copies, all in flight at once, zero past the live rows and columns
  copy_rows<Tin>(sm + L.kt, ldkt * isz, k, row0, K, 0, kp, K, src, n, tid, nt);
  if (logw_code == 0)
    copy_rows<float>(sm + L.bz + ldk * 4, ldk * 4, static_cast<const float*>(logw), row0, K, 0,
                     kp, K, src, n, tid, nt);
  else
    copy_rows<__nv_bfloat16>(sm + L.wraw, kp * 2, static_cast<const __nv_bfloat16*>(logw), row0,
                             K, 0, kp, K, src, n, tid, nt);
  copy_rows<Tin>(sm + L.rt, ldkt * isz, r, row0 + t0, K, 0, kp, K, rows, n - t0, tid, nt);
  copy_rows<Tin>(sm + L.vt, ldvt * isz, v, row0, V, v0, BV, V - v0, src, n, tid, nt);
  cp_async_commit();
  for (int kk = tid; kk < kp; kk += nt) {
    bz[kk] = 0.f;
    uf[kk] = kk < K ? load_any(u, bh * K + kk, u_code) : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();
  // 2. b = cumsum of logw * log2 e over the chunk: thread (column kk,
  // group q of rows) sums its rows in order, eight loaded ahead; then each
  // adds the totals of the groups before its own
  {
    const int ng = kp >= nt ? 1 : nt / kp, per = (src + ng - 1) / ng;
    float* tot = reinterpret_cast<float*>(sm + L.tot);
    for (int i = tid; i < kp * ng; i += nt) {
      const int kk = i % kp, q = i / kp, lo = q * per, hi = min(src, lo + per);
      float run = 0.f;
      for (int s = lo; s < hi; s += 8) {
        float x[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          x[e] = s + e >= hi ? 0.f
                 : logw_code == 0 ? bz[(s + e + 1) * ldk + kk]
                                  : __bfloat162float(wraw[(s + e) * kp + kk]);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (s + e < hi) bz[(s + e + 1) * ldk + kk] = run += x[e] * LOG2E;
      }
      tot[q * kp + kk] = run;
    }
    __syncthreads();
    for (int i = tid; i < kp * ng; i += nt) {
      const int kk = i % kp, q = i / kp, lo = q * per, hi = min(src, lo + per);
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
  __syncthreads();

  // 3. the tiles, in a zigzag over the groups of wv warps; warp h of
  // a group owns columns h * 8 NJ .. of the V tile and shares the scores
  const int groups = nw / wv, grp = warp / wv, h = warp - grp * wv;
  float* qb = reinterpret_cast<float*>(sm + L.qb) + grp * TILE * ldk;
  float* pb = reinterpret_cast<float*>(sm + L.pb) + grp * TILE * ldp;
  const int vc = h * 8 * NJ;                       // the warp's first column of the V tile
  const float* S_in = ws + (bh * n_chunks + c) * K * (long long)V;   // the state entering the chunk
  auto group_sync = [&]() {
    if (wv == 1) __syncwarp();
    else asm volatile("bar.sync %0, %1;" ::"r"(1 + grp), "r"(32 * wv) : "memory");
  };
  const int nsb = rows / TILE;
  for (int q = 0;; ++q) {
    const int l = q & 1 ? (q + 1) * groups - 1 - grp : q * groups + grp;
    const int j0 = t0 + l * TILE;                  // first row of the tile
    if (l >= nsb || j0 >= n) break;
    const int live = min(TILE, n - j0);
    const Tin* rl = rt + l * TILE * ldkt;
    const float* rho = bz + j0 * ldk;              // b_prev of row j0
    float acc[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

    // 3a. the tile's block of A.  Its two SUB-row diagonal blocks are
    // exact, with the bonus on their diagonal, the terms shared out over
    // the group's lanes; the block below the first is one product about
    // b_prev of row SUB, q8 @ kd8^T, both factors' exponents <= 0
    for (int i = h * 32 + lane; i < TILE * ldp; i += 32 * wv) pb[i] = 0.f;
    group_sync();
    if (h == wv - 1 && live > SUB) {
      const float* rho8 = bz + (j0 + SUB) * ldk;
      float d[1][4] = {{0.f, 0.f, 0.f, 0.f}};
      const int t = SUB + g;                        // the A rows g + 8
      for (int ks = 0; ks < kp / 8; ++ks) {
        const int ca = ks * 8 + tq, cb = ca + 4;
        const bool in = t < live;
        const float av[4] = {
            0.f, in ? to_f32(rl[t * ldkt + ca]) * ex2(bz[(j0 + t) * ldk + ca] - rho8[ca]) : 0.f,
            0.f, in ? to_f32(rl[t * ldkt + cb]) * ex2(bz[(j0 + t) * ldk + cb] - rho8[cb]) : 0.f};
        const float bv[2] = {
            to_f32(kt[(j0 + g) * ldkt + ca]) * ex2(rho8[ca] - bz[(j0 + g + 1) * ldk + ca]),
            to_f32(kt[(j0 + g) * ldkt + cb]) * ex2(rho8[cb] - bz[(j0 + g + 1) * ldk + cb])};
        const M::B B[1] = {make_b(bv)};
        mma3(d, make_a(av), B);
      }
      pb[(SUB + g) * ldp + 2 * tq] = d[0][2];
      pb[(SUB + g) * ldp + 2 * tq + 1] = d[0][3];
    }
    for (int p = h * 32 + lane; p < 2 * TRI; p += 32 * wv) {
      const int blk = p / TRI, p1 = p - blk * TRI;
      int t = (int)((sqrtf(8.f * p1 + 1.f) - 1.f) * 0.5f);
      while (t * (t + 1) / 2 > p1) --t;
      while ((t + 1) * (t + 2) / 2 <= p1) ++t;
      const int s = p1 - t * (t + 1) / 2 + blk * SUB;
      t += blk * SUB;
      if (t >= live) continue;
      const Tin* rr = rl + t * ldkt;
      const Tin* ks = kt + (j0 + s) * ldkt;
      float sum[4] = {0.f, 0.f, 0.f, 0.f};   // four sums, so that no add waits on the last
      if (s == t) {
        for (int k8 = 0; k8 < kp; k8 += 8) {
          float x[8], y[8], w[8];
          load8(rr + k8, x);
          load8(ks + k8, y);
          load8(uf + k8, w);
#pragma unroll
          for (int e = 0; e < 8; ++e) sum[e & 3] += x[e] * w[e] * y[e];
        }
      } else {
        const float* bt = bz + (j0 + t) * ldk;       // b_prev[t]
        const float* b_s = bz + (j0 + s + 1) * ldk;  // b[s]
#pragma unroll 2
        for (int k8 = 0; k8 < kp; k8 += 8) {
          float x[8], y[8], p1[8], p2[8];
          load8(rr + k8, x);
          load8(ks + k8, y);
          load8(bt + k8, p1);
          load8(b_s + k8, p2);
#pragma unroll
          for (int e = 0; e < 8; ++e) sum[e & 3] += x[e] * y[e] * ex2(p1[e] - p2[e]);
        }
      }
      pb[t * ldp + s] = (sum[0] + sum[1]) + (sum[2] + sum[3]);
    }
    group_sync();
    a_times_v(acc, pb, ldp, vt + j0 * ldvt + vc, ldvt, lane);

    // 3b. q = r * 2^{b_prev - rho}, the group's columns shared out
    for (int kk = h * 32 + lane; kk < kp; kk += 32 * wv)
      for (int t0q = 0; t0q < TILE; t0q += 8) {   // eight rows loaded ahead
        const float rk = rho[kk];
        float x[8], b[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {   // rows past the live ones: 0 * 2^0
          const bool in = t0q + q < live;
          x[q] = in ? to_f32(rl[(t0q + q) * ldkt + kk]) : 0.f;
          b[q] = in ? bz[(j0 + t0q + q) * ldk + kk] : rk;
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) qb[(t0q + q) * ldk + kk] = x[q] * ex2(b[q] - rk);
      }
    group_sync();   // q is whole, and the diagonal block is consumed

    // 3c. each earlier tile i: A_{j,i} = q @ (k_i * 2^{rho - b_i})^T
    // (its 8-column tiles shared out over the group), then @ v_i
    for (int s0 = 0; s0 < j0; s0 += TILE) {
      for (int ns = h; ns < TILE / 8; ns += wv) {
        // two sums (even and odd k-steps), so that no mma waits on the last
        float pacc[2][4];
#pragma unroll
        for (int e = 0; e < 4; ++e) pacc[0][e] = pacc[1][e] = 0.f;
        const int s = s0 + 8 * ns + g;
        const float* bs1 = bz + (s + 1) * ldk;     // b[s]
        const Tin* ksr = kt + s * ldkt;
        auto step = [&](int ks, int x) {
          const int ca = ks * 8 + tq, cb = ca + 4;
          const float bv[2] = {to_f32(ksr[ca]) * ex2(rho[ca] - bs1[ca]),
                               to_f32(ksr[cb]) * ex2(rho[cb] - bs1[cb])};
          M::mma(pacc[x], M::load_a(qb + ks * 8, ldk, lane), make_b(bv));
        };
        int ks = 0;
        for (; ks + 2 <= kp / 8; ks += 2) {
          step(ks, 0);
          step(ks + 1, 1);
        }
        if (ks < kp / 8) step(ks, 0);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float* p = pb + (g + 8 * hh) * ldp + 8 * ns + 2 * tq;
          p[0] = pacc[0][2 * hh] + pacc[1][2 * hh];
          p[1] = pacc[0][2 * hh + 1] + pacc[1][2 * hh + 1];
        }
      }
      group_sync();
      a_times_v(acc, pb, ldp, vt + s0 * ldvt + vc, ldvt, lane);
      group_sync();   // the block of A is consumed before the next one
    }

    // 3d. inter = (q * 2^rho) @ S, the warp's columns, S the state entering
    // the chunk, read from the workspace (through L2) once the states pass
    // has completed
    asm volatile("griddepcontrol.wait;" ::: "memory");
    // four k-steps of S loaded at once, so that their L2 latencies overlap
    for (int ks0 = 0; ks0 < kp / 8; ks0 += 4) {
      float sv[4][NJ][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ka = (ks0 + i) * 8 + tq, kb = ka + 4;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = v0 + vc + 8 * j + g;
          const bool in = col < V && ks0 + i < kp / 8;
          sv[i][j][0] = in && ka < K ? __ldcg(S_in + (long long)ka * V + col) : 0.f;
          sv[i][j][1] = in && kb < K ? __ldcg(S_in + (long long)kb * V + col) : 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ks = ks0 + i;
        if (ks >= kp / 8) break;
        const float e0 = ex2(rho[ks * 8 + tq]), e1 = ex2(rho[ks * 8 + tq + 4]);
        M::B B[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) B[j] = make_b(sv[i][j]);
        const float* s = qb + ks * 8;
        const float av[4] = {s[g * ldk + tq] * e0, s[(g + 8) * ldk + tq] * e0,
                             s[g * ldk + tq + 4] * e1, s[(g + 8) * ldk + tq + 4] * e1};
        mma3(acc, make_a(av), B);
      }
    }

    // 3e. out, once, in r's type: the warp's columns
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = g + 8 * hh;
        if (t >= live) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = v0 + vc + 8 * j + 2 * tq + e;
          if (col < V) from_f32(acc[j][2 * hh + e], out + (row0 + j0 + t) * V + col);
        }
      }
    group_sync();   // pb and qb are rewritten for the next tile
  }
  // this grid ends after the states pass (a block with no live rows, too):
  // what follows on the stream may read the final state
  if (tid == 0) asm volatile("griddepcontrol.wait;" ::: "memory");
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

constexpr int MAX_DEVICES = 64;

struct Args {
  const void *r, *k, *v, *logw, *u, *state0;
  void *out, *state, *ws;
  long long BH;
  int T, K, V, C, logw_code, u_code, warps, rows, wv, states_smem, outputs_smem;
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
cudaError_t launch_states(const Args& a, cudaStream_t s) {
  static bool done[MAX_DEVICES] = {};
  auto kern = wkv_states_kernel<Tin>;
  cudaError_t err = opt_in(kern, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)a.BH, (unsigned)((a.K + KT - 1) / KT),
                  (unsigned)((a.V + BVS - 1) / BVS));
  kern<<<grid, 32, a.states_smem, s>>>((const Tin*)a.k, (const Tin*)a.v, a.logw, a.logw_code,
                                       (const float*)a.state0, (float*)a.ws, (float*)a.state,
                                       a.T, a.K, a.V, a.C);
  return cudaGetLastError();
}

template <typename Tin>
cudaError_t launch_outputs(const Args& a, cudaStream_t s) {
  static bool done[MAX_DEVICES] = {};
  auto kern = wkv_outputs_kernel<Tin>;
  cudaError_t err = opt_in(kern, done);
  if (err != cudaSuccess) return err;
  const int n_chunks = (a.T + a.C - 1) / a.C, tpc = (a.C + a.rows - 1) / a.rows;
  const int bv = 8 * NJ * a.wv;
  // a programmatic dependent launch: the blocks may start while the states
  // pass still runs, and wait for it (griddepcontrol.wait) only before they
  // read the workspace
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)a.BH, (unsigned)(n_chunks * tpc), (unsigned)((a.V + bv - 1) / bv));
  cfg.blockDim = dim3(32 * a.warps);
  cfg.dynamicSmemBytes = a.outputs_smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, (const Tin*)a.r, (const Tin*)a.k, (const Tin*)a.v, a.logw,
                           a.logw_code, a.u, a.u_code, (const float*)a.ws, (Tin*)a.out, a.T, a.K,
                           a.V, a.C, a.rows, a.wv);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename Tin>
cudaError_t launch_all(const Args& a, cudaStream_t s) {
  const cudaError_t err = launch_states<Tin>(a, s);
  if (err != cudaSuccess) return err;
  return launch_outputs<Tin>(a, s);
}

}  // namespace

// r, k, logw: [BH, T, K]; v, out: [BH, T, V]; u: [BH, K]; state0 (the
// initial state, null for zero) and state (the final one): [BH, K, V]
// float32; ws: [BH, ceil(T / C), K, V] float32 scratch, chunk 0's entry
// state0.  All dense.  dtype
// is the type of r, k, v and out; logw_dtype and u_dtype are each 0 =
// float32 or 1 = bfloat16.  1 <= C <= T.  The outputs pass's plan: `wv`
// warps (1 or 2) sharing a tile, each with 32 columns of the V tile of
// 32 wv, `warps` (1..8, a multiple of wv, at most wv rows / TILE) and
// `rows` a block (a multiple of TILE, at most C rounded up to it).  Launches the states pass, then the outputs pass, on `stream`;
// returns the first error.
extern "C" int repro_wkv_chunked(const void* r, const void* k, const void* v, const void* logw,
                                 const void* u, const void* state0, void* out, void* state,
                                 void* ws, long long BH,
                                 int T, int K, int V, int C, int dtype, int logw_dtype,
                                 int u_dtype, int wv, int warps, int rows, void* stream) {
  if (BH <= 0 || BH > INT_MAX || T <= 0 || K <= 0 || V <= 0 || C <= 0 || C > T ||
      (dtype != 0 && dtype != 1) || (logw_dtype != 0 && logw_dtype != 1) ||
      (u_dtype != 0 && u_dtype != 1) || (wv != 1 && wv != 2) ||
      warps < 1 || warps > MAX_WARPS || warps % wv)
    return (int)cudaErrorInvalidValue;
  if (rows < TILE || rows % TILE || rows > (C + TILE - 1) / TILE * TILE ||
      warps / wv > rows / TILE)
    return (int)cudaErrorInvalidValue;
  const long long n_chunks = (T + C - 1) / C, tpc = (C + rows - 1) / rows;
  const int isz = dtype == 0 ? 4 : 2, wsz = logw_dtype == 0 ? 4 : 2;
  const long long outputs_smem = out_layout(C, K, wv, warps, rows, isz, wsz).total;
  if (n_chunks * tpc > 65535 || (K + KT - 1) / KT > 65535 ||
      (V + BVS * wv - 1) / (BVS * wv) > 65535 || (V + BVS - 1) / BVS > 65535 ||
      outputs_smem > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const Args a{r, k, v, logw, u, state0, out, state, ws, BH, T, K, V, C, logw_dtype, u_dtype, warps,
               rows, wv, states_layout(isz, wsz).total, (int)outputs_smem};
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(dtype == 0 ? launch_all<float>(a, s) : launch_all<__nv_bfloat16>(a, s));
}
