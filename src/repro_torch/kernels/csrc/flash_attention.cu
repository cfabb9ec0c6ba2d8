// Flash attention, forward only, for Hopper (sm_90a), in two regimes.
//
// Replaces the TPU kernel `flash_attention` / `_flash_kernel` of
// src/repro/kernels/flash_attention.py.  There the KV axis is a sequential
// grid dimension and the running (m, l, acc) are three scratches that
// survive from one grid step to the next.  Semantics, both regimes: scores
// in float32 as (q . k) * scale; masks `causal` (q_pos >= k_pos), `window`
// (q_pos - k_pos < window) and k_pos < Sk, where q_pos = q_offset + the
// query's row (a sequence shard's queries against the keys from the
// sequence's start; 0 otherwise) and k_pos the key's row; NEG_INF = -1e30 is finite, so a
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
// 2. Online softmax over KV tiles (online_kernel), for Sk > S_MAX: the
//    prefill attention of the LM stack (causal, windowed, GQA heads
//    expanded by the caller; D = 64..256).  Bound on this card: bytes at
//    the served 4 x 512 prompts, operations at long windowed prompts (only
//    the unmasked q.k pairs count).  A block of 4 warps owns 64 query rows
//    of one (batch, head), a warp 16 of them, and loops over the KV tiles
//    itself:
//      * K and V tiles of 64 keys come into shared memory by cp.async
//        (cp_async.cuh), double-buffered (the next tile lands while this
//        one is used), zero-filled past Sk and D; q is staged once and
//        read as mma fragments at each step (held in registers it cost a
//        block a SM, which was slower);
//      * both products run on the tensor cores (mma.cuh): one bf16 term
//        with float32 accumulation, or 3xTF32 for float32 in slabs summed
//        from zero; bf16 operands come by ldmatrix (V transposed on the
//        way), from row strides that keep it free of bank conflicts;
//      * the online softmax runs on the score fragments: a row's 64 scores
//        lie on the 4 lanes of a quad, so its max and sum are two shuffles;
//        exp2 of the scores scaled by scale * log2(e); p is rounded to v's
//        type in registers and is the A operand of P V as it stands (the
//        float32 path reads V's rows in the order of the score fragment's
//        columns: key 2t, then 2t + 1);
//      * the KV loop is bounded by `causal` and `window`: tiles masked for
//        the whole query tile are never loaded, unless a row of the tile
//        has no unmasked key at all (it then needs every key for its
//        uniform average); the heaviest query tiles are scheduled first.
//    D <= 256 (128 in float32) is one chunk, held in registers; a wider D
//    is cut into chunks: the output columns over blockIdx.z, each such
//    block recomputing the scores over all chunks (q and K chunks staged
//    per tile).  One pass, no atomics: two calls give the same bits.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "cp_async.cuh"
#include "ldmatrix.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float NEG_INF = -1e30f;

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
            T* __restrict__ out, float* __restrict__ lse, int Sq, int Sk, int D, float scale,
            int causal, int has_window, int window, int q_offset, int bq, int wmax) {
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
      const int qp = q_offset + r0 + r;   // the row's position
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
      // the row's log-sum-exp of the scaled scores, for the backward: every
      // block of the cluster holds the whole row; rank 0 writes it
      if (lse != nullptr && sub == 0 && z == 0 && r < r1 - r0)
        lse[bh * Sq + r0 + r] = mx + logf(l == 0.f ? 1.f : l);
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
// 2. online softmax over KV tiles, on the tensor cores
// ---------------------------------------------------------------------------

constexpr int OQ = 64;    // query rows of a block: 16 a warp
constexpr int OKT = 64;   // keys of a KV tile
constexpr int NTO = 128;  // threads: 4 warps
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Columns of D a block takes at once (a compiled instance each): a chunk of
// the score product's depth, and the output columns a block owns
// (blockIdx.z).  D <= 256 is one chunk (128 for float32, whose 3xTF32
// temporaries need the registers), in the narrowest instance that holds it
// (bf16 rows a multiple of the 16-deep mma step, float32 of 32 columns, the
// P V group); a wider D is cut into chunks and its scores recomputed by
// every output chunk.  The registers a thread keeps grow with the chunk.
template <typename T>
__host__ __device__ inline int online_chunk(int D) {
  if (sizeof(T) == 2) return D <= 64 ? 64 : D <= 80 ? 80 : D <= 128 ? 128 : 256;
  return D <= 64 ? 64 : D <= 96 ? 96 : 128;
}
// Row stride (elements) of a staged tile of a chunk: bf16 rows that ldmatrix
// reads free of bank conflicts (ld / 8 odd), float32 rows that the scalar
// fragment loads read free of them (ld = 4 mod 32).
template <typename T>
__host__ __device__ constexpr int online_ld(int dc) {
  return sizeof(T) == 2 ? dc + 8 : dc + 4;
}
// Dynamic shared memory: with one chunk, q resident and a ring of RING K / V
// tiles; with several, a ring of RING (q chunk, K chunk) / V tiles.
constexpr int RING = 3;
template <typename T>
__host__ __device__ inline size_t online_smem(int D) {
  const int dc = online_chunk<T>(D), nc = (D + dc - 1) / dc;
  return sizeof(T) * (size_t)online_ld<T>(dc) * OQ * (nc == 1 ? 1 + RING : 2 * RING);
}
// Blocks a SM should hold at once (the registers' bound passed to ptxas):
// four for bf16 chunks up to 80 columns (128 registers a thread), three up to
// 128 (168); wider chunks and float32 take what they need.  Tighter bounds
// spill at D = 128 and were slower there.
template <typename T, int DC>
constexpr int online_min_blocks = sizeof(T) != 2 ? 1 : DC <= 80 ? 4 : DC <= 128 ? 3 : 1;

// grid (BH, query tiles, output chunks); DC = online_chunk<T>(D)
template <typename T, int DC>
__global__ void __launch_bounds__(NTO, online_min_blocks<T, DC>)
online_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              T* __restrict__ out, float* __restrict__ lse, int Sq, int Sk, int D,
              float scale, int causal, int has_window, int window, int q_offset) {
  using MM = Mma<T>;
  using S = typename MM::S;
  using R = std::conditional_t<sizeof(T) == 4, uint32_t, uint16_t>;  // raw bits
  constexpr bool BF = sizeof(T) == 2;
  constexpr int U = MM::K;                    // depth of an mma step
  constexpr int V = 16 / sizeof(T);           // elements of a 16-byte copy
  constexpr int NKS = DC / U;                 // mma steps of a chunk's depth
  constexpr int NO = DC / 8;                  // 8-column output tiles of a chunk
  constexpr int CPR = DC * (int)sizeof(T) / 16;  // 16-byte copies a staged row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* smem = reinterpret_cast<S*>(smem_raw);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const long long bh = blockIdx.x;
  // the last query tiles (the most keys under `causal`) are scheduled first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * OQ;
  const int nc = (D + DC - 1) / DC, z = blockIdx.z;
  constexpr int ld = online_ld<T>(DC), tile = OQ * ld;
  // one chunk: q [OQ][ld], then the ring; several: the ring alone, each
  // buffer a q chunk and a K chunk, or a V tile.  A unit (a K, q/K or V
  // stage) is issued two units ahead of its use, a whole KV tile's work.
  S* qres = smem;
  S* ring = smem + (nc == 1 ? tile : 0);
  const int buf = nc == 1 ? tile : 2 * tile;

  const R* qb = reinterpret_cast<const R*>(q) + bh * Sq * D;
  const R* kb = reinterpret_cast<const R*>(k) + bh * Sk * D;
  const R* vb = reinterpret_cast<const R*>(v) + bh * Sk * D;
  const bool vec = D % V == 0 &&
                   (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  // rows [row0, row0 + 64) of src (those past `rows` zero), chunk c's
  // columns (those past D zero), into dst [64][ld]
  auto stage = [&](S* dst, const R* src, int row0, int rows, int c) {
    const int c0 = c * DC, c1 = min(D, c0 + DC);
#pragma unroll
    for (int j = 0; j < (OQ * CPR + NTO - 1) / NTO; ++j) {
      const int i = tid + j * NTO;
      if (i >= OQ * CPR) break;
      const int r = i / CPR, col = (i % CPR) * V;
      copy_chunk<R, V>(dst + r * ld + col, src + (long long)(row0 + r) * D + c0 + col,
                       row0 + r < rows ? (long long)(c1 - c0 - col) : 0, vec, src);
    }
  };

  // KV range this query tile can see; all of it if some row sees nothing
  // (that row then averages every key, as NEG_INF is finite).  The row at
  // position p = q_offset + its row (q_offset >= 0) sees keys
  // [max(0, p - window + 1), causal ? min(Sk - 1, p) : Sk - 1]: with a
  // window that is empty for p >= Sk + window - 1, and for every row under
  // `causal` with window <= 0; without one, never.
  const int q_last = min(q0 + OQ, Sq) - 1;
  const long long p0 = (long long)q_offset + q0, p_last = (long long)q_offset + q_last;
  int k_begin = has_window ? (int)max(0LL, p0 - window + 1) : 0;
  int k_end = causal ? (int)min((long long)Sk, p_last + 1) : Sk;
  const bool some_row_empty =
      k_begin >= k_end ||
      (has_window && (p_last >= (long long)Sk + window - 1 || (causal && window <= 0)));
  if (some_row_empty) { k_begin = 0; k_end = Sk; }
  const int kt0 = k_begin / OKT, kt1 = (k_end + OKT - 1) / OKT;
  const int parts = nc + 1;                  // nc q.k chunks, then V
  const int units = (kt1 - kt0) * parts;

  auto issue = [&](int u) {
    const int key0 = (kt0 + u / parts) * OKT, p = u % parts;
    S* b = ring + (u % RING) * buf;
    if (p == nc) {
      stage(b, vb, key0, Sk, z);
    } else {
      if (nc > 1) stage(b, qb, q0, Sq, p);
      stage(b + (nc > 1 ? tile : 0), kb, key0, Sk, p);
    }
  };

  // this warp's rows g and g + 8 of its 16: scores of the KV tile, the
  // running max (log2 domain) and sum, the output chunk
  float s[8][4], o[NO][4];
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NO; ++j) zero(o[j]);
  const int wz = min(D, (z + 1) * DC) - z * DC;   // this block's output columns
  const float sl = scale * LOG2E;

  if (nc == 1) stage(qres, qb, q0, Sq, 0);
  issue(0);
  cp_async_commit();
  if (units > 1) issue(1);
  cp_async_commit();
  for (int u = 0; u < units; ++u) {
    cp_async_wait<1>();  // unit u (and q) landed; unit u + 1 may be in flight
    // every warp is done with unit u - 1, whose buffer unit u + 2 takes
    __syncthreads();
    if (u + 2 < units) issue(u + 2);
    cp_async_commit();
    const int kt = kt0 + u / parts, p = u % parts;
    const S* b = ring + (u % RING) * buf;
    if (p < nc) {
      // ---- s (+)= Q_c K_c^T over chunk p ----
      const S* qs = (nc == 1 ? qres : b) + warp * 16 * ld;
      const S* ks = b + (nc > 1 ? tile : 0);
      const int nks = (min(D, (p + 1) * DC) - p * DC + U - 1) / U;
      if (p == 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j) zero(s[j]);
      }
      if constexpr (BF) {
        // this lane's row addresses for ldmatrix (bytes): q's A tiles, K's
        // B tiles; every fragment is one of them plus a constant
        const uint32_t qa = smem_u32(qs) + 2 * (((lane >> 3 & 1) * 8 + (lane & 7)) * ld +
                                                (lane >> 4) * 8);
        const uint32_t ka = smem_u32(ks) + 2 * (((lane >> 4) * 8 + (lane & 7)) * ld +
                                                (lane >> 3 & 1) * 8);
#pragma unroll
        for (int ks_ = 0; ks_ < NKS; ++ks_) {
          if (ks_ >= nks) break;
          typename MM::A a;
          ldsm_x4(a.r, qa + 32 * ks_);
          // the step's K fragments first, then its products: the loads are
          // in flight together
          uint32_t r[4][4];
#pragma unroll
          for (int np = 0; np < 4; ++np) ldsm_x4(r[np], ka + 2 * (np * 16 * ld + ks_ * 16));
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            MM::mma(s[2 * np], a, typename MM::B{{r[np][0], r[np][1]}});
            MM::mma(s[2 * np + 1], a, typename MM::B{{r[np][2], r[np][3]}});
          }
        }
      } else {
        // 3xTF32: each 32-deep slab summed from zero, then added
#pragma unroll
        for (int grp = 0; grp < 2; ++grp) {
          for (int k0 = 0; k0 < nks * U; k0 += 32) {
            float ds[4][4], db[4][4];
#pragma unroll
            for (int j = 0; j < 4; ++j) zero(ds[j]), zero(db[j]);
#pragma unroll
            for (int kk = 0; kk < 32; kk += U) {
              if (k0 + kk >= nks * U) break;
              const typename MM::A a = MM::load_a(qs + k0 + kk, ld, lane);
              typename MM::B bb[4];
#pragma unroll
              for (int j = 0; j < 4; ++j)
                bb[j] = MM::load_bt(ks + (grp * 32 + 8 * j) * ld + k0 + kk, ld, lane);
              MM::mma_row(ds, db, a, bb);
            }
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) s[grp * 4 + j][e] += ds[j][e] + db[j][e];
          }
        }
      }
      if (p == nc - 1) {
        // ---- masks and the online softmax on the fragments: a row's 64
        //      scores lie on the 4 lanes of a quad ----
        // (only a tile that crosses Sk, the diagonal or the window's edge
        // for this warp's rows tests each score: the test is warp-uniform)
        // r_lo: the position of this warp's first row
        const int key0 = kt * OKT, r_lo = q_offset + q0 + warp * 16;
        const bool tail = key0 + OKT > Sk;
        const bool edge = tail || (causal && key0 + OKT - 1 > r_lo) ||
                          (has_window && r_lo + 15 - key0 >= window);
        float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][e] *= sl;
            if (edge) {
              const int qp = r_lo + g + (e >> 1) * 8;
              const int kp = key0 + 8 * j + 2 * t + (e & 1);
              if (!(kp < Sk && (!causal || qp >= kp) && (!has_window || qp - kp < window)))
                s[j][e] = NEG_INF;
            }
            mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
          }
        float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          const float m_new = fmaxf(m_run[h], mx[h]);
          alpha[h] = ex2(m_run[h] - m_new);
          m_run[h] = m_new;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][e] = ex2(s[j][e] - m_run[e >> 1]);
            // keys past Sk do not exist
            if (tail && key0 + 8 * j + 2 * t + (e & 1) >= Sk) s[j][e] = 0.f;
            sum[e >> 1] += s[j][e];
          }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
          sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
          l_run[h] = l_run[h] * alpha[h] + sum[h];
        }
#pragma unroll
        for (int j = 0; j < NO; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];
      }
    } else {
      // ---- o += P V_z, p from the score fragments (rounded to v's type) ----
      if constexpr (BF) {
        const int nvp = (wz + 15) / 16;
        const uint32_t va = smem_u32(b) + 2 * (((lane >> 3 & 1) * 8 + (lane & 7)) * ld +
                                               (lane >> 4) * 8);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const typename MM::A a{{pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                  pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                  pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                  pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])}};
          // V fragments of up to four column pairs in flight, then their
          // products
#pragma unroll
          for (int n0 = 0; n0 < NO / 2; n0 += 4) {
            uint32_t r[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (n0 + i < NO / 2 && n0 + i < nvp)
                ldsm_x4_t(r[i], va + 2 * (kk * 16 * ld + (n0 + i) * 16));
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (n0 + i < NO / 2 && n0 + i < nvp) {
                MM::mma(o[2 * (n0 + i)], a, typename MM::B{{r[i][0], r[i][1]}});
                MM::mma(o[2 * (n0 + i) + 1], a, typename MM::B{{r[i][2], r[i][3]}});
              }
          }
        }
      } else {
        // the A fragment's column t holds key 2t and t + 4 key 2t + 1 (the
        // C layout of the scores); V's rows are read in the same order
        const int nvg = (wz + 31) / 32;
#pragma unroll
        for (int grp = 0; grp < NO / 4; ++grp) {
          if (grp >= nvg) break;
          float ds[4][4], db[4][4];
#pragma unroll
          for (int j = 0; j < 4; ++j) zero(ds[j]), zero(db[j]);
#pragma unroll
          for (int kk = 0; kk < 8; ++kk) {
            const float av[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
            typename MM::A a;
            MM::split(av, a.big, a.small);
            typename MM::B bb[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const S* vp = b + (kk * 8 + 2 * t) * ld + grp * 32 + 8 * j + g;
              const float vv[2] = {vp[0], vp[ld]};
              MM::split(vv, bb[j].big, bb[j].small);
            }
            MM::mma_row(ds, db, a, bb);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[grp * 4 + j][e] += ds[j][e] + db[j][e];
        }
      }
    }
  }

  // ---- o / l, stored once ----
  const bool pairs = D % 2 == 0;
  T* ob = out + bh * Sq * D + z * DC;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + warp * 16 + g + 8 * h;
    if (r >= Sq) continue;
    const float l = l_run[h] == 0.f ? 1.f : l_run[h];
    // the row's log-sum-exp of the scaled scores (m_run is in the log2
    // domain; a row with no key keeps NEG_INF, as the reference's does),
    // for the backward: from the first output chunk's blocks
    if (lse != nullptr && z == 0 && t == 0)
      lse[bh * Sq + r] = (m_run[h] == NEG_INF ? NEG_INF : m_run[h] * LN2) + logf(l);
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int col = 8 * j + 2 * t;
      if (col < wz)
        store2(o[j][2 * h] / l, o[j][2 * h + 1] / l, ob + (long long)r * D + col,
               pairs && col + 1 < wz);
    }
  }
}

constexpr int MAX_DEVICES = 64;

template <typename T>
int launch_rows(const void* q, const void* k, const void* v, void* out, float* lse, long long BH,
                int Sq, int Sk, int D, float scale, int causal, int has_window, int window,
                int q_offset, int splits, int row_splits, cudaStream_t s) {
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
  err = cudaLaunchKernelEx(&cfg, kern, (const T*)q, (const T*)k, (const T*)v, (T*)out, lse, Sq,
                           Sk, D, scale, causal, has_window, window, q_offset, bq, wmax);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, int DC>
int launch_online_at(const void* q, const void* k, const void* v, void* out, float* lse,
                     long long BH, int Sq, int Sk, int D, float scale, int causal, int has_window,
                     int window, int q_offset, cudaStream_t s) {
  const unsigned gy = (Sq + OQ - 1) / OQ, gz = (D + DC - 1) / DC;
  if (BH > 2147483647LL || gy > 65535u || gz > 65535u) return (int)cudaErrorInvalidValue;
  const size_t smem = online_smem<T>(D);
  if (smem > (size_t)SMEM_OPT_IN) return (int)cudaErrorInvalidValue;
  auto kern = online_kernel<T, DC>;
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
  kern<<<dim3((unsigned)BH, gy, gz), NTO, smem, s>>>((const T*)q, (const T*)k, (const T*)v,
                                                     (T*)out, lse, Sq, Sk, D, scale, causal,
                                                     has_window, window, q_offset);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_online(const void* q, const void* k, const void* v, void* out, float* lse,
                  long long BH, int Sq, int Sk, int D, float scale, int causal, int has_window,
                  int window, int q_offset, cudaStream_t s) {
  const int dc = online_chunk<T>(D);
#define REPRO_ONLINE(DC)                                                                     \
  if (dc == DC)                                                                              \
    return launch_online_at<T, DC>(q, k, v, out, lse, BH, Sq, Sk, D, scale, causal,       \
                                   has_window, window, q_offset, s);
  REPRO_ONLINE(64)
  REPRO_ONLINE(128)
  if constexpr (sizeof(T) == 2) {
    REPRO_ONLINE(80)
    REPRO_ONLINE(256)
  } else {
    REPRO_ONLINE(96)
  }
#undef REPRO_ONLINE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q: [BH, Sq, D], k, v: [BH, Sk, D], out: [BH, Sq, D], all dense; lse:
// [BH, Sq] float32, each row's log-sum-exp of the scaled scores (m + log l,
// as the reference's forward returns it for its backward), or nullptr (the
// served forward: nothing written).  dtype: 0 = float32, 1 = bfloat16.  regime 1: whole rows (Sk <= 128), D split
// over a cluster of `splits` blocks (1..8, at most the column units) and
// the query rows over `row_splits` (at most the 16-row tiles), within the
// shared-memory budget; regime 0: online softmax over KV tiles (splits and
// row_splits unused).  q_offset (>= 0): the position of query row 0 less
// that of key row 0, which the masks read.  Returns cudaGetLastError().
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     void* lse, long long BH, int Sq, int Sk, int D, float scale,
                                     int causal, int has_window, int window, int q_offset,
                                     int regime,
                                     int splits, int row_splits, int dtype, void* stream) {
  if (BH <= 0 || Sq <= 0 || Sk <= 0 || D <= 0 || q_offset < 0 ||
      (long long)q_offset + Sq > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* l = (float*)lse;
  if (regime == 1 && dtype == 0)
    return launch_rows<float>(q, k, v, out, l, BH, Sq, Sk, D, scale, causal, has_window, window,
                              q_offset, splits, row_splits, s);
  if (regime == 1 && dtype == 1)
    return launch_rows<__nv_bfloat16>(q, k, v, out, l, BH, Sq, Sk, D, scale, causal, has_window,
                                      window, q_offset, splits, row_splits, s);
  if (regime == 0 && dtype == 0)
    return launch_online<float>(q, k, v, out, l, BH, Sq, Sk, D, scale, causal, has_window, window,
                                q_offset, s);
  if (regime == 0 && dtype == 1)
    return launch_online<__nv_bfloat16>(q, k, v, out, l, BH, Sq, Sk, D, scale, causal, has_window,
                                        window, q_offset, s);
  return (int)cudaErrorInvalidValue;
}
