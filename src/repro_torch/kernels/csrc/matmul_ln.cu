// Matmul with a LayerNorm epilogue  out = LN(x @ w + b) * gamma + beta
// for Hopper (sm_90a): the paper's C2 "writeback line buffer".
//
// Replaces the TPU kernel `matmul_ln` (`_matmul_ln_kernel`) of
// src/repro/kernels/matmul_ln.py.  There a (bm, N) float32 accumulator
// lives in VMEM across a sequential K grid axis and the row statistics
// are taken on the last K step.  Here a thread-block cluster of S blocks
// (S in {1, 2, 4, 8}, the wrapper's plan()) owns BM rows, and each block of
// it a contiguous slice of N: the 8-column groups of N are shared out as
// evenly as they go (sizes differ by one group at most) and the ragged last
// group is masked by bounds.  The grid is (S, row tiles) with cluster
// dimension (S, 1, 1), so the blocks of a cluster are the slices of one
// row tile.
//
// A block walks its slice in BN-column steps and K in 32-deep slabs (every
// block_k runs on that slab).  The x and w slabs go to shared memory by
// cp.async two slabs ahead of the products that read them (three buffers;
// two where the row buffer leaves no room for three), 16 bytes a copy
// where the rows are aligned, zero-filled past the bounds, and
// bounds-checked scalars otherwise (any M, K, N).  The 8-column mma tiles
// of a step fall on the warps round-robin, so a slice narrower than a step
// leaves no warp with more than its share.  The products run on the tensor
// cores (mma.cuh): float32 as 3xTF32 on mma.m16n8k8, bfloat16 as one
// mma.m16n8k16 term, both accumulating in float32; each slab sums from zero
// and is added to the accumulator in float32, which holds the float32
// tolerance (3e-5 (1 + |b|)) where one accumulator over the whole K does
// not.  The bias is added on the accumulator fragments and y + b goes to
// the slice's row buffer in shared memory (BM x slice float32).
//
// Row statistics across the cluster through distributed shared memory, in
// a fixed order: each block writes the partial sums of its slice's rows to
// its own shared memory, cluster.sync(), and every block reads the S
// partials of ranks 0..S-1 in that order (map_shared_rank), so every block
// gets the same mean to the bit; the same again for the squared deviations
// about that mean (the biased variance as the mean of squared deviations,
// not E[y^2] - E[y]^2).  A last cluster.sync() keeps every block's shared
// memory alive until all have read it.  Then each block normalises its
// slice with rsqrt(var + eps), scales, offsets and stores every output
// element once.  No atomics: two calls give the same bits.  No [M, N]
// intermediate reaches device memory.
//
// Bound on this card: a row costs 2*K*N operations against (K + N) * 4
// bytes of x and out.  At the three EdgeNeXt-S B = 16 shapes (16384 x 96
// -> 96, 4096 x 160 -> 160, 1024 x 304 -> 304) that is bytes: 0.0062 ms
// summed at 3.35 TB/s.  512 x 2048 -> 2048 (4.29 GFLOP, 0.0087 ms at 495
// TFLOP/s TF32) and 448 x 2560 -> 2560 (5.87 GFLOP, 0.0119 ms) are bound by
// operations, and 3xTF32 reaches a third of that rate at most.  The
// wrapper's plan() doubles S until the grid covers the card (16 row tiles
// at 1024 x 304, 28-32 at the LM widths) and further while a slice keeps a
// whole BN-column step.  What bounds the kernel as it is (PERF.md): the
// latency of each slab step with one or two blocks an SM, and at the LM
// widths w read again from L2 by every 16-row tile.
//
// Left for later: TMA, with x multicast to the blocks of a cluster (each
// reads the same rows), warpgroup `wgmma`, and more rows a cluster at the
// LM widths (block_m is the lowering's).

#include <cooperative_groups.h>

#include <type_traits>

#include "cp_async.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;                    // threads a block: 8 warps
constexpr int KS = 32;                     // K slab
constexpr int SMEM_BUDGET = 160 * 1024;    // block_m * N * 4: the whole row, over the cluster
constexpr int SMEM_OPT_IN = 220 * 1024;    // dynamic shared memory a block may take
constexpr int MAX_CLUSTER = 8;

// The block's shape for BM rows: MR rows of mma tiles (BM = 8 runs one
// 16-row tile with rows 8-15 zero), WR warps down the rows and WC across,
// each warp NJ 8-column mma tiles of a BN-column step.
template <typename T, int BM>
struct Layout {
  using S = typename Mma<T>::S;
  using R = std::conditional_t<sizeof(T) == 4, uint32_t, uint16_t>;  // raw bits
  static constexpr int MR = BM < 16 ? 16 : BM;
  static constexpr int WR = MR / 16, WC = 8 / WR;
  static constexpr int NJ = BM == 64 ? 4 : 128 / (8 * WC);
  static constexpr int BN = 8 * WC * NJ;  // 64 at BM = 64, else 128
  static constexpr int LDX = KS + Mma<T>::PAD_A, LDW = BN + Mma<T>::PAD_B;
  static constexpr int V = 16 / sizeof(T);  // elements of a 16-byte load
  static constexpr int XCH = MR * KS / V, WCH = KS * BN / V;  // 16-byte chunks of a slab
  static constexpr int XQ = (XCH + NT - 1) / NT, WQ = (WCH + NT - 1) / NT;  // chunks a thread
  static constexpr int XS = MR * LDX;        // elements of an x slab
  static constexpr int SLAB = XS + KS * LDW;  // elements of one x + w buffer
  // shared memory: the STAGES buffers, then the row buffer [BM][ldy]
  static size_t bytes(int stages, int ldy) {
    return (size_t)stages * SLAB * sizeof(S) + (size_t)BM * ldy * sizeof(float);
  }
};

template <typename T, int BM, int STAGES>
__global__ void __launch_bounds__(NT)
matmul_ln_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
                 const T* __restrict__ gamma, const T* __restrict__ beta, T* __restrict__ out,
                 int M, int K, int N, float eps, int ldy) {
  using L = Layout<T, BM>;
  using MM = Mma<T>;
  using S = typename MM::S;
  using R = typename L::R;
  constexpr int NJ = L::NJ, BN = L::BN, LDX = L::LDX, LDW = L::LDW, V = L::V;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* slabs = reinterpret_cast<S*>(smem_raw);  // STAGES buffers of [MR][LDX] x, [KS][LDW] w
  float* ybuf = reinterpret_cast<float*>(slabs + STAGES * L::SLAB);  // [BM][ldy]
  __shared__ float part_sum[BM], part_sq[BM], mean_s[BM], rstd_s[BM];

  cg::cluster_group cluster = cg::this_cluster();
  const int nblk = (int)cluster.num_blocks(), z = (int)cluster.block_rank();
  // this block's slice [s0, s1) of N: groups of 8 columns shared out evenly
  const int groups = (N + 7) / 8;
  const int s0 = min(N, 8 * (int)((long long)z * groups / nblk));
  const int s1 = min(N, 8 * (int)((long long)(z + 1) * groups / nblk));
  const int ns = s1 - s0;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // the warps of a row slab sit on different schedulers (warp % 4)
  const int wr = warp % L::WR, wc = warp / L::WR;
  const int g = lane / 4, t = lane % 4;
  const R* xr = reinterpret_cast<const R*>(x);
  const R* wrw = reinterpret_cast<const R*>(w);
  const bool vec_x = K % V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_w = N % V == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;

  const int kt = (K + KS - 1) / KS, nt = (ns + BN - 1) / BN, steps = kt * nt;
  const long long row_tiles = ((long long)M + BM - 1) / BM;
  for (long long rt = blockIdx.y; rt < row_tiles; rt += gridDim.y) {
    const long long m0 = rt * BM;

    // step i: columns n0 = (i / kt) * BN of the slice, K slab k0 = (i % kt) * KS,
    // copied into buffer i % STAGES
    auto issue = [&](int i) {
      const int n0 = (i / kt) * BN, k0 = (i % kt) * KS;
      S* xs = slabs + (i % STAGES) * L::SLAB;
      S* ws = xs + L::XS;
#pragma unroll
      for (int q = 0; q < L::XQ; ++q) {
        const int c = tid + q * NT, r = c / (KS / V), k = (c % (KS / V)) * V;
        const long long gm = m0 + r;
        if (c < L::XCH)
          copy_chunk<R, V>(xs + r * LDX + k, xr + gm * K + k0 + k,
                           r < BM && gm < M ? (long long)K - k0 - k : 0, vec_x, xr);
      }
#pragma unroll
      for (int q = 0; q < L::WQ; ++q) {
        const int c = tid + q * NT, r = c / (BN / V), n = (c % (BN / V)) * V;
        const int gk = k0 + r, gn = s0 + n0 + n;
        if (c < L::WCH)
          copy_chunk<R, V>(ws + r * LDW + n, wrw + (long long)gk * N + gn, gk < K ? s1 - gn : 0,
                           vec_w, wrw);
      }
    };

    float acc[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) zero(acc[j]);
    // STAGES - 1 slabs in flight ahead of the products that read them
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) {
      if (i < steps) issue(i);
      cp_async_commit();
    }
    for (int i = 0; i < steps; ++i) {
      const int buf = i % STAGES, n0 = (i / kt) * BN, k0 = (i % kt) * KS;
      cp_async_wait<STAGES - 2>();  // slab i has landed
      __syncthreads();              // for every thread; and slab i - 1 is read
      if (i + STAGES - 1 < steps) issue(i + STAGES - 1);
      cp_async_commit();
      // the slab's products: each of the warp's 8-column tiles summed from
      // zero (its small terms and big . big apart, so that the tiles' mma
      // interleave), then added.  Tile j of a warp is columns (j WC + wc) 8
      // of the step, so the tiles inside the slice fall evenly on the warps;
      // a warp runs only those (NV, an instance each), with no branch
      // between them.  Branch-free where the slab is whole (FULL); past K
      // the last slab is zero and stops at the mma depth.
      auto slab = [&](auto full, auto nv) {
        constexpr int NV = decltype(nv)::value;
        const S* xs = slabs + buf * L::SLAB;
        const S* ws = xs + L::XS;
        float ds[NV][4], db[NV][4];
#pragma unroll
        for (int j = 0; j < NV; ++j) zero(ds[j]), zero(db[j]);
#pragma unroll
        for (int kk = 0; kk < KS; kk += MM::K) {
          if (!decltype(full)::value && kk >= K - k0) break;
          const typename MM::A a = MM::load_a(xs + wr * 16 * LDX + kk, LDX, lane);
          typename MM::B bf[NV];
#pragma unroll
          for (int j = 0; j < NV; ++j)
            bf[j] = MM::load_b(ws + kk * LDW + (j * L::WC + wc) * 8, LDW, lane);
          MM::mma_row(ds, db, a, bf);
        }
#pragma unroll
        for (int j = 0; j < NV; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] += ds[j][e] + db[j][e];
      };
      const int tiles = (min(ns - n0, BN) + 7) / 8;  // 8-column tiles of the step in the slice
      const int nv = tiles > wc ? min(NJ, (tiles - wc + L::WC - 1) / L::WC) : 0;
      with_count<NJ>(nv, [&](auto nvc) {
        if (k0 + KS <= K) slab(std::true_type{}, nvc);
        else slab(std::false_type{}, nvc);
      });
      if (i % kt == kt - 1) {  // the step's columns are done: y + b to the row buffer
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = wr * 16 + g + (e / 2) * 8, c = n0 + (j * L::WC + wc) * 8 + 2 * t + e % 2;
            if (r < BM && c < ns) ybuf[r * ldy + c] = acc[j][e] + to_f32(b[s0 + c]);
          }
          zero(acc[j]);
        }
      }
    }
    __syncthreads();  // the row buffer is whole

    // ---- statistics: a warp takes rows warp, warp + NW, ..., all at once
    //      (their loads and shuffles interleave), a lane every 32nd column ----
    constexpr int NW = NT / 32, RW = (BM + NW - 1) / NW;  // rows a warp
    // the slice's sums of f(row r, y) for the warp's rows, to part[r]
    auto row_sums = [&](float* part, auto f) {
      float s[RW];
#pragma unroll
      for (int i = 0; i < RW; ++i) s[i] = 0.f;
      for (int c = lane; c < ns; c += 32)
#pragma unroll
        for (int i = 0; i < RW; ++i)
          if (warp + i * NW < BM) s[i] += f(warp + i * NW, ybuf[(warp + i * NW) * ldy + c]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int i = 0; i < RW; ++i) s[i] += __shfl_xor_sync(0xffffffffu, s[i], o);
#pragma unroll
      for (int i = 0; i < RW; ++i)
        if (lane == 0 && warp + i * NW < BM) part[warp + i * NW] = s[i];
    };
    // the cluster's partials, all loads in flight at once, added in rank
    // order: the same sum in every block
    auto cluster_sum = [&](float* part) {
      float v[MAX_CLUSTER], s = 0.f;
#pragma unroll
      for (int q = 0; q < MAX_CLUSTER; ++q)
        if (q < nblk) v[q] = cluster.map_shared_rank(part, q)[tid];
#pragma unroll
      for (int q = 0; q < MAX_CLUSTER; ++q)
        if (q < nblk) s += v[q];
      return s;
    };
    row_sums(part_sum, [](int, float y) { return y; });
    cluster.sync();
    if (tid < BM) mean_s[tid] = cluster_sum(part_sum) / (float)N;
    __syncthreads();
    row_sums(part_sq, [&](int r, float y) {
      const float d = y - mean_s[r];
      return d * d;
    });
    cluster.sync();
    if (tid < BM) rstd_s[tid] = rsqrtf(cluster_sum(part_sq) / (float)N + eps);
    // every block has read the others' partials: none is overwritten (next
    // row tile) or leaves while another still reads it; rstd_s is visible
    cluster.sync();

    // ---- normalise, scale, offset: one store of the slice, the warp's
    //      rows a column at a time (gamma and beta loaded once) ----
    for (int c = lane; c < ns; c += 32) {
      const float gc = to_f32(gamma[s0 + c]), bc = to_f32(beta[s0 + c]);
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const int r = warp + i * NW;
        if (r < BM && m0 + r < M)
          from_f32((ybuf[r * ldy + c] - mean_s[r]) * rstd_s[r] * gc + bc, out + (m0 + r) * N + s0 + c);
      }
    }
  }
}

constexpr int MAX_DEVICES = 64;

template <typename T, int BM, int STAGES>
cudaError_t launch_(const void* x, const void* w, const void* b, const void* g, const void* be,
                    void* out, long long M, int K, int N, int S, float eps, int ldy,
                    cudaStream_t s) {
  auto kern = matmul_ln_kernel<T, BM, STAGES>;
  // shared memory past the 48 KiB a launch gets without asking: opt in once
  // per instance and device
  static bool opted_in[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES || !opted_in[dev]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_OPT_IN);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES) opted_in[dev] = true;
  }
  const long long row_tiles = (M + BM - 1) / BM;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)S, (unsigned)(row_tiles < 65535 ? row_tiles : 65535), 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = Layout<T, BM>::bytes(STAGES, ldy);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, (const T*)x, (const T*)w, (const T*)b, (const T*)g,
                           (const T*)be, (T*)out, (int)M, K, N, eps, ldy);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// three slab buffers where the row buffer leaves room for them, else two
template <typename T, int BM>
int launch(const void* x, const void* w, const void* b, const void* g, const void* be,
           void* out, long long M, int K, int N, int S, float eps, cudaStream_t s) {
  // the widest slice, and a row-buffer stride of 8 (mod 32) floats (the
  // accumulator fragments' stores free of bank conflicts)
  const int groups = (N + 7) / 8;
  const int ns_max = 8 * ((groups + S - 1) / S);
  const int ldy = ns_max + (40 - ns_max % 32) % 32;
  if (Layout<T, BM>::bytes(3, ldy) <= (size_t)SMEM_OPT_IN)
    return (int)launch_<T, BM, 3>(x, w, b, g, be, out, M, K, N, S, eps, ldy, s);
  return (int)launch_<T, BM, 2>(x, w, b, g, be, out, M, K, N, S, eps, ldy, s);
}

template <typename T>
int launch_bm(int bm, const void* x, const void* w, const void* b, const void* g, const void* be,
              void* out, long long M, int K, int N, int S, float eps, cudaStream_t s) {
  switch (bm) {
    case 8: return launch<T, 8>(x, w, b, g, be, out, M, K, N, S, eps, s);
    case 16: return launch<T, 16>(x, w, b, g, be, out, M, K, N, S, eps, s);
    case 32: return launch<T, 32>(x, w, b, g, be, out, M, K, N, S, eps, s);
    case 64: return launch<T, 64>(x, w, b, g, be, out, M, K, N, S, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; block_m in {8, 16, 32, 64} rows a
// cluster, block_m * N * 4 <= 160 KiB; splits (the cluster size) in
// {1, 2, 4, 8} and at most ceil(N / 8).  Returns cudaGetLastError().
extern "C" int repro_matmul_ln(const void* x, const void* w, const void* b, const void* gamma,
                               const void* beta, void* out, long long M, int K, int N,
                               int block_m, int splits, float eps, int dtype, void* stream) {
  if (M <= 0 || M > 2147483647LL || K <= 0 || N <= 0 ||
      (long long)block_m * N * 4 > SMEM_BUDGET ||
      (splits != 1 && splits != 2 && splits != 4 && splits != 8) || splits > (N + 7) / 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_bm<float>(block_m, x, w, b, gamma, beta, out, M, K, N, splits, eps, s);
  if (dtype == 1)
    return launch_bm<__nv_bfloat16>(block_m, x, w, b, gamma, beta, out, M, K, N, splits, eps, s);
  return (int)cudaErrorInvalidValue;
}
