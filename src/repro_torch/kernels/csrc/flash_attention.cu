// Flash attention, forward only, for Hopper (sm_90a), in two regimes.
//
// Replaces the TPU kernel `flash_attention` / `_flash_kernel` of
// src/repro/kernels/flash_attention.py.  There the KV axis is a sequential
// grid dimension and the running (m, l, acc) are three scratches that
// survive from one grid step to the next.  Semantics, both regimes: scores
// in float32 as (q . k) * scale; masks `causal` (q_pos >= k_pos), `window`
// (q_pos - k_pos < window) and k_pos < Sk; NEG_INF = -1e30 is finite, so a
// row whose every key is masked averages uniformly over the Sk keys, as the
// plain version does; p is rounded to v's type before P @ V; l == 0
// divides by 1; any Sq, Sk and D; float32 and bfloat16.  The wrapper's
// plan() picks the regime and its splits.
//
// 1. Whole rows (rows_kernel), for Sk <= S_MAX.  EdgeNeXt's XCA calls
//    attention with the 24..76 channels of a head as the sequence and the
//    tokens as the head dim D (up to 1024): few keys, wide rows.  Bound on
//    this card: bytes (q, k, v read once, out written once; 1.5-7.5 us at
//    the B = 16 shapes).  So a (b, h) is owned by a thread-block cluster of
//    P <= 8 blocks, and each block by one slice of D: the column units (8
//    float32 / 16 bf16, one mma depth) shared out as evenly as they go.
//    The grid may also split the query rows, in 16-row tiles, over
//    blockIdx.y (where BH * P leaves the card idle or Sq is long); k and v
//    are then read again from L2, not recomputed.  A block
//      * copies its q, k and v slices into shared memory once (cp.async,
//        zero-filled past the bounds; v lands while the scores are made);
//      * computes its partial scores Q_slice K_slice^T (its rows x Sk) on
//        the tensor cores (mma.cuh: 3xTF32 for float32, one bf16 term),
//        each 32-deep slab summed from zero and added in float32;
//      * after cluster.sync(), sums the P partials of each score through
//        distributed shared memory in rank order 0..P-1 (one coalesced
//        pass, every load in flight), so every block of the cluster gets
//        the same scores to the bit, and no atomics: two calls give the
//        same bits;
//      * applies the masks and an exact softmax over whole rows (one exp a
//        score, no running rescale; eight lanes a row, four rows a warp at
//        once), p rounded to v's type;
//      * computes O_slice = P V_slice on the same mma helpers (32-key slabs
//        summed from zero), divides by l and stores once.
//    A cluster barrier, arrived at once the partials are read and waited
//    for before the block leaves, keeps every block's partials alive while
//    the others still read them.  No score is computed twice and no [Sq,
//    Sk] matrix reaches device memory.  256 threads a block and at most
//    128 registers a thread, so two blocks share a SM where their shared
//    memory allows: the phases are latency-bound, and 8-16 warps a SM hide
//    more of it than 4-12 did with 128 threads.  What bounds it at the XCA
//    shapes (PERF.md, `python -m repro_torch.profile_flash_attention`):
//    the launch's fixed cost, the loads, and the latency of the Q K^T and
//    P V loops where D is wide.
//
// 2. Online softmax over KV tiles (flash_kernel), for Sk > S_MAX: one block
//    owns a tile of BQ query rows of one (batch, head) and loops over the
//    KV tiles itself, with m and l in registers and acc spread over the
//    threads' registers; float32 multiply-adds on the CUDA cores:
//      * Q K^T loops D in slabs of DS columns staged in shared memory; warp
//        w owns query rows w and w + 8, lane i owns key i of the KV tile
//        (BK = 32 = one warp), so the row max and row sum are warp shuffles;
//      * the output's D is spread over the block: thread t owns columns
//        t, t + 256, ... (NJ of them) of all BQ rows, reads each v element
//        straight from device memory and p from shared memory;
//      * D wider than 256 * NJ is split over blockIdx.z; each such block
//        recomputes the scores.  KV tiles that causal/window masking
//        empties for the whole query tile are skipped, unless a row of the
//        tile has no unmasked key at all (it then needs every tile for its
//        uniform average).
//    This regime is not redesigned yet: no model path runs it.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "cp_async.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float NEG_INF = -1e30f;

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

// ---------------------------------------------------------------------------
// 1. whole rows
// ---------------------------------------------------------------------------

constexpr int S_MAX = 128;               // keys a whole-row launch takes
constexpr int RT = 16;                   // rows of an mma tile: the row split's unit
constexpr int NTR = 256;                 // threads a block: 8 warps, two blocks a SM
constexpr int NWR = NTR / 32;
constexpr int SLAB = 32;                 // depth of a product summed from zero
constexpr int QJ = 2;                    // 8-key tiles of a Q K^T job
constexpr int MAX_CLUSTER = 8;           // the portable cluster size
constexpr int SMEM_OPT_IN = 220 * 1024;  // dynamic shared memory a block may take

// Shared memory of a whole-row block for bq query rows, nk keys (Sk padded
// to 16) and a slice of at most wmax columns, byte offsets from its start:
// q [bq][ldq], k [nk][ldq], v [nk][ldv], p [bq][ldp] (all of T), then the
// partial scores [bq][lds], the cluster's sums of them [bq][lds] and l [bq]
// (float).  The strides keep the fragment loads free of bank conflicts
// (mma.cuh): q, k (the transposed B operand) and p as A rows, v as B rows
// (8 mod 32 words for float32, 8 mod 64 halves for bf16), the scores'
// float2 stores 8 mod 16 words.  plan() in the wrapper computes the same
// sum.
struct RowShape {
  int ldq, ldv, ldp, lds;
  size_t off_k, off_v, off_p, off_part, off_sc, off_l, bytes;
};

template <typename T>
__host__ __device__ inline RowShape row_shape(int bq, int nk, int wmax) {
  constexpr int es = (int)sizeof(T), pad_a = es == 4 ? 4 : 8;
  RowShape s;
  s.ldq = wmax + pad_a;
  s.ldv = es == 4 ? wmax + (40 - wmax % 32) % 32 : wmax + (72 - wmax % 64) % 64;
  s.ldp = nk + pad_a;
  s.lds = nk + 8;
  s.off_k = (size_t)bq * s.ldq * es;
  s.off_v = s.off_k + (size_t)nk * s.ldq * es;
  s.off_p = s.off_v + (size_t)nk * s.ldv * es;
  s.off_part = s.off_p + (size_t)bq * s.ldp * es;
  s.off_sc = s.off_part + (size_t)bq * s.lds * 4;
  s.off_l = s.off_sc + (size_t)bq * s.lds * 4;
  s.bytes = s.off_l + (size_t)bq * 4;
  return s;
}

// two neighbouring outputs of a row; `pair` where both exist and the
// address is aligned for one store of both
__device__ __forceinline__ void store2(float a, float b, float* p, bool pair) {
  if (pair) *reinterpret_cast<float2*>(p) = make_float2(a, b);
  else *p = a;
}
__device__ __forceinline__ void store2(float a, float b, __nv_bfloat16* p, bool pair) {
  if (pair) *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  else *p = __float2bfloat16(a);
}

// grid (P * BH, row splits), clusters of (P, 1, 1); bq: the most query rows
// a block takes, wmax: the widest slice (both as row_shape's)
template <typename T>
__global__ void __launch_bounds__(NTR, 2)
rows_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            T* __restrict__ out, int Sq, int Sk, int D, float scale, int causal,
            int has_window, int window, int bq, int wmax) {
  using MM = Mma<T>;
  using S = typename MM::S;
  using R = std::conditional_t<sizeof(T) == 4, uint32_t, uint16_t>;  // raw bits
  constexpr int U = MM::K;           // column unit of a slice: one mma depth
  constexpr int V = 16 / sizeof(T);  // elements of a 16-byte copy
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nk = RT * ((Sk + RT - 1) / RT);
  const RowShape L = row_shape<T>(bq, nk, wmax);
  S* qs = reinterpret_cast<S*>(smem_raw);
  S* ks = reinterpret_cast<S*>(smem_raw + L.off_k);
  S* vs = reinterpret_cast<S*>(smem_raw + L.off_v);
  S* ps = reinterpret_cast<S*>(smem_raw + L.off_p);
  float* part = reinterpret_cast<float*>(smem_raw + L.off_part);
  float* sc = reinterpret_cast<float*>(smem_raw + L.off_sc);
  float* ls = reinterpret_cast<float*>(smem_raw + L.off_l);

  cg::cluster_group cluster = cg::this_cluster();
  const int nblk = (int)cluster.num_blocks(), z = (int)cluster.block_rank();
  const long long bh = blockIdx.x / nblk;
  // this block's columns [c0, c1) of D: whole units shared out evenly (sizes
  // differ by one unit at most), the last clipped to D; wp pads w to a unit
  const int units = (D + U - 1) / U;
  const int c0 = min(D, U * (int)((long long)z * units / nblk));
  const int c1 = min(D, U * (int)((long long)(z + 1) * units / nblk));
  const int w = c1 - c0, wp = U * ((w + U - 1) / U);
  // its query rows [r0, r1): whole 16-row tiles shared out evenly; mt tiles
  const int tiles = (Sq + RT - 1) / RT;
  const int t0 = (int)((long long)blockIdx.y * tiles / gridDim.y);
  const int t1 = (int)((long long)(blockIdx.y + 1) * tiles / gridDim.y);
  const int r0 = RT * t0, r1 = min(Sq, RT * t1), mt = t1 - t0;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;

  // ---- the slices to shared memory, each byte read once: q and k, then v ----
  const R* qr = reinterpret_cast<const R*>(q) + (bh * Sq + r0) * D;
  const R* kr = reinterpret_cast<const R*>(k) + bh * Sk * D;
  const R* vr = reinterpret_cast<const R*>(v) + bh * Sk * D;
  const bool vec = D % V == 0 &&
                   (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  const int cpr = wp / V;  // 16-byte chunks a row
  // rows [0, n) of src (rows past `valid` zero) into dst [n][ld]
  auto stage = [&](S* dst, int ld, const R* src, int n, int valid) {
    for (int i = tid; i < n * cpr; i += NTR) {
      const int r = i / cpr, c = (i % cpr) * V;
      copy_chunk<R, V>(dst + r * ld + c, src + (long long)r * D + c0 + c,
                       r < valid ? (long long)(w - c) : 0, vec, src);
    }
  };
  stage(qs, L.ldq, qr, RT * mt, r1 - r0);
  stage(ks, L.ldq, kr, nk, Sk);
  cp_async_commit();
  stage(vs, L.ldv, vr, nk, Sk);
  cp_async_commit();
  cp_async_wait<1>();  // q and k have landed
  __syncthreads();

  // ---- partial scores Q_slice K_slice^T: a warp takes one row tile and QJ
  //      8-key tiles (they share the A fragment), jobs round-robin ----
  {
    const int groups = nk / (8 * QJ);
    for (int job = warp; job < mt * groups; job += NWR) {
      const int mi = job / groups, n0 = (job % groups) * 8 * QJ;
      float acc[QJ][4];
#pragma unroll
      for (int j = 0; j < QJ; ++j) zero(acc[j]);
      for (int k0 = 0; k0 < wp; k0 += SLAB) {
        float ds[QJ][4], db[QJ][4];
#pragma unroll
        for (int j = 0; j < QJ; ++j) zero(ds[j]), zero(db[j]);
#pragma unroll
        for (int kk = 0; kk < SLAB; kk += MM::K) {
          if (k0 + kk >= wp) break;
          const typename MM::A a = MM::load_a(qs + mi * RT * L.ldq + k0 + kk, L.ldq, lane);
          typename MM::B b[QJ];
#pragma unroll
          for (int j = 0; j < QJ; ++j)
            b[j] = MM::load_bt(ks + (n0 + 8 * j) * L.ldq + k0 + kk, L.ldq, lane);
          MM::mma_row(ds, db, a, b);
        }
#pragma unroll
        for (int j = 0; j < QJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] += ds[j][e] + db[j][e];
      }
#pragma unroll
      for (int j = 0; j < QJ; ++j) {
        float* dst = part + (mi * RT + g) * L.lds + n0 + 8 * j + 2 * t;
        *reinterpret_cast<float2*>(dst) = make_float2(acc[j][0], acc[j][1]);
        *reinterpret_cast<float2*>(dst + 8 * L.lds) = make_float2(acc[j][2], acc[j][3]);
      }
    }
  }
  cluster.sync();  // every block's partial scores are written

  // ---- the P partials of each score summed in rank order 0..P-1 (every
  //      block of the cluster gets the same bits), all loads in flight:
  //      a thread every NTR-th score of the block's rows ----
  if (nblk > 1) {
    const float* remote[MAX_CLUSTER];
#pragma unroll
    for (int p = 0; p < MAX_CLUSTER; ++p)
      remote[p] = p < nblk ? cluster.map_shared_rank(part, p) : part;
#pragma unroll 4
    for (int i = tid; i < RT * mt * L.lds; i += NTR) {
      float v[MAX_CLUSTER], sum = 0.f;
#pragma unroll
      for (int p = 0; p < MAX_CLUSTER; ++p)
        if (p < nblk) v[p] = remote[p][i];
#pragma unroll
      for (int p = 0; p < MAX_CLUSTER; ++p)
        if (p < nblk) sum += v[p];
      sc[i] = sum;
    }
  } else {
    sc = part;
  }
  // this block has read the others' partials; it waits for them to have
  // read its own before it leaves
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  __syncthreads();

  // ---- masks and an exact softmax over whole rows: eight lanes a row
  //      (four rows a warp at once), a lane every 8th key ----
  {
    constexpr int NC = S_MAX / 8;
    const int sub = lane % 8;
    for (int r = warp * 4 + lane / 8; r < RT * mt; r += 4 * NWR) {
      const int qp = r0 + r;
      float s[NC], mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int j = sub + 8 * c;
        if (j >= nk) break;
        const bool ok = j < Sk && (!causal || qp >= j) && (!has_window || qp - j < window);
        s[c] = ok ? sc[r * L.lds + j] * scale : NEG_INF;
        if (j < Sk) mx = fmaxf(mx, s[c]);
      }
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      float l = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int j = sub + 8 * c;
        if (j >= nk) break;
        const float p = j < Sk ? expf(s[c] - mx) : 0.f;  // keys past Sk do not exist
        l += p;
        from_f32(p, ps + r * L.ldp + j);                  // rounded to v's type
      }
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
      if (sub == 0) ls[r] = l;
    }
  }
  cp_async_wait<0>();  // v has landed
  __syncthreads();     // and p and l are written

  // ---- O_slice = P V_slice / l: a warp takes one row tile and up to four
  //      8-column tiles (only those inside the slice), jobs round-robin ----
  {
    const int ntiles = (wp + 7) / 8, groups = (ntiles + 3) / 4;
    const bool pairs = D % 2 == 0;  // c0 and the fragment's columns are even
    T* ob = out + (bh * Sq + r0) * D + c0;
    for (int job = warp; job < mt * groups; job += NWR) {
      const int mi = job / groups, n0 = (job % groups) * 32;
      with_count<4>(min(4, ntiles - n0 / 8), [&](auto nvc) {
        constexpr int NV = decltype(nvc)::value;
        float acc[NV][4];
#pragma unroll
        for (int j = 0; j < NV; ++j) zero(acc[j]);
        for (int k0 = 0; k0 < nk; k0 += SLAB) {
          float ds[NV][4], db[NV][4];
#pragma unroll
          for (int j = 0; j < NV; ++j) zero(ds[j]), zero(db[j]);
#pragma unroll
          for (int kk = 0; kk < SLAB; kk += MM::K) {
            if (k0 + kk >= nk) break;
            const typename MM::A a = MM::load_a(ps + mi * RT * L.ldp + k0 + kk, L.ldp, lane);
            typename MM::B b[NV];
#pragma unroll
            for (int j = 0; j < NV; ++j)
              b[j] = MM::load_b(vs + (k0 + kk) * L.ldv + n0 + 8 * j, L.ldv, lane);
            MM::mma_row(ds, db, a, b);
          }
#pragma unroll
          for (int j = 0; j < NV; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j][e] += ds[j][e] + db[j][e];
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = mi * RT + g + 8 * h;
          if (r >= r1 - r0) continue;
          const float l = ls[r] == 0.f ? 1.f : ls[r];
#pragma unroll
          for (int j = 0; j < NV; ++j) {
            const int col = n0 + 8 * j + 2 * t;
            if (col < w)
              store2(acc[j][2 * h] / l, acc[j][2 * h + 1] / l, ob + (long long)r * D + col,
                     pairs && col + 1 < w);
          }
        }
      });
    }
  }
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// 2. online softmax over KV tiles
// ---------------------------------------------------------------------------

constexpr int BQ = 16;    // query rows per block (2 per warp)
constexpr int BK = 32;    // keys per KV tile (1 per lane)
constexpr int DS = 128;   // slab of D per step of Q K^T
constexpr int NT = 256;   // threads

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

constexpr int MAX_DEVICES = 64;

template <typename T>
int launch_rows(const void* q, const void* k, const void* v, void* out, long long BH, int Sq,
                int Sk, int D, float scale, int causal, int has_window, int window, int splits,
                int row_splits, cudaStream_t s) {
  constexpr int U = Mma<T>::K;
  const int units = (D + U - 1) / U, tiles = (Sq + RT - 1) / RT;
  if (Sk > S_MAX || splits < 1 || splits > MAX_CLUSTER || splits > units || row_splits < 1 ||
      row_splits > tiles || row_splits > 65535 || BH * splits > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const int wmax = U * ((units + splits - 1) / splits);
  const int bq = RT * ((tiles + row_splits - 1) / row_splits);
  const int nk = RT * ((Sk + RT - 1) / RT);
  const size_t smem = row_shape<T>(bq, nk, wmax).bytes;
  if (smem > (size_t)SMEM_OPT_IN) return (int)cudaErrorInvalidValue;
  auto kern = rows_kernel<T>;
  // shared memory past the 48 KiB a launch gets without asking: opt in once
  // per instance and device
  static bool opted_in[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES || !opted_in[dev]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_OPT_IN);
    if (err != cudaSuccess) return (int)err;
    if (dev < MAX_DEVICES) opted_in[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(BH * splits), (unsigned)row_splits, 1);
  cfg.blockDim = dim3(NTR, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, (const T*)q, (const T*)k, (const T*)v, (T*)out, Sq, Sk, D,
                           scale, causal, has_window, window, bq, wmax);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_online(const void* q, const void* k, const void* v, void* out, long long BH, int Sq,
                  int Sk, int D, float scale, int causal, int has_window, int window,
                  cudaStream_t s) {
  const int nj = D <= NT ? 1 : (D <= 2 * NT ? 2 : 4);
  const unsigned gy = (Sq + BQ - 1) / BQ, gz = (D + NT * nj - 1) / (NT * nj);
  if (BH > 2147483647LL || gy > 65535u || gz > 65535u) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)BH, gy, gz);
#define REPRO_FLASH_LAUNCH(NJ)                                                            \
  flash_kernel<T, NJ><<<grid, NT, 0, s>>>((const T*)q, (const T*)k, (const T*)v, (T*)out, \
                                          Sq, Sk, D, scale, causal, has_window, window)
  if (nj == 1) REPRO_FLASH_LAUNCH(1);
  else if (nj == 2) REPRO_FLASH_LAUNCH(2);
  else REPRO_FLASH_LAUNCH(4);
#undef REPRO_FLASH_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// q: [BH, Sq, D], k, v: [BH, Sk, D], out: [BH, Sq, D], all dense.  dtype:
// 0 = float32, 1 = bfloat16.  regime 1: whole rows (Sk <= 128), D split
// over a cluster of `splits` blocks (1..8, at most the column units) and
// the query rows over `row_splits` (at most the 16-row tiles), within the
// shared-memory budget; regime 0: online softmax over KV tiles (splits and
// row_splits unused).  Returns cudaGetLastError().
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     long long BH, int Sq, int Sk, int D, float scale, int causal,
                                     int has_window, int window, int regime, int splits,
                                     int row_splits, int dtype, void* stream) {
  if (BH <= 0 || Sq <= 0 || Sk <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (regime == 1 && dtype == 0)
    return launch_rows<float>(q, k, v, out, BH, Sq, Sk, D, scale, causal, has_window, window,
                              splits, row_splits, s);
  if (regime == 1 && dtype == 1)
    return launch_rows<__nv_bfloat16>(q, k, v, out, BH, Sq, Sk, D, scale, causal, has_window,
                                      window, splits, row_splits, s);
  if (regime == 0 && dtype == 0)
    return launch_online<float>(q, k, v, out, BH, Sq, Sk, D, scale, causal, has_window, window, s);
  if (regime == 0 && dtype == 1)
    return launch_online<__nv_bfloat16>(q, k, v, out, BH, Sq, Sk, D, scale, causal, has_window,
                                        window, s);
  return (int)cudaErrorInvalidValue;
}
