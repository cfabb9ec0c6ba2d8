// Fused inverted bottleneck  out = act(x @ w1) @ w2  (gated:
// (act(x @ wg) * (x @ w1)) @ w2)  for Hopper (sm_90a).
//
// Replaces the TPU kernel `fused_ibn` (`_ibn_kernel`, `_ibn_gated_kernel`,
// `_mask_ragged_f`) of src/repro/kernels/fused_ibn.py.  There the F axis is
// a sequential grid dimension and the output accumulator is a scratch that
// survives from one grid step to the next.  Here a block owns BM rows and
// DOT output columns and walks a contiguous share of the F tiles: a
// (BM, BF) tile of the expanded intermediate T is produced on the tensor
// cores, activated in registers, zeroed past the true F (after the
// activation, so an activation with act(0) != 0 stays right), rounded to
// the input type, stored to shared memory, reloaded as the A operand of the
// second product and dropped.  T never reaches device memory.
//
// What bounds it: operations.  At EdgeNeXt-S widths the two products cost
// more at the tensor cores' rate than x, w1, w2 and out cost at the memory
// rate.  float32 runs 3xTF32, so its ceiling is a third of the TF32 rate:
// each operand a is split into big = tf32(a) (rounded to nearest) and
// small = a - big, and small.big + big.small + big.big is accumulated in
// float32 (mma m16n8k8; the tensor cores read the top 19 bits of small).
// The dropped small.small term and that truncation cost about 2^-21 of a
// product, where one TF32 term costs 2^-11, which breaks the float32
// tolerance (3e-5 (1 + |b|)).  bfloat16 runs one term (mma m16n8k16),
// float32 accumulate.  The tensor cores round their own float32 sums
// towards zero; over thousands of steps into one accumulator that bias
// alone passes the tolerance at stage-4 and LM widths, so each slab sums
// from zero and is then added to the accumulator in float32.  The mma
// instructions are issued directly, with the PTX ISA's fragment layouts:
// the WMMA API's tf32 fragments compile here to k = 4 instructions and
// generic loads (the helpers are in mma.cuh, shared with matmul_ln.cu).
//
// Split F.  The grid is (row tiles, Do tiles, S): F is split into S shares
// over blockIdx.z (the wrapper's plan() picks S so that the grid fills the
// card when there are few row tiles, as at EdgeNeXt-S stages 3-4 or batch
// 1).  With S == 1 the block stores to out; with S > 1 it stores a float32
// partial to the workspace ws [S, M, Do], and a second kernel sums the
// partials in the fixed order s = 0..S-1 (no atomics, so the result is the
// same bits on every run) and casts to the input type.
//
// Data movement.  A block is 16 warps, one a SM.  Where D <= XMAX (the
// folded-bias D of EdgeNeXt-S: 49, 97, 161, 305) the block's x rows are
// loaded once, split into their TF32 parts, and stay in shared memory for
// all its F tiles; wider x (LM widths) and the weights stream in slabs,
// double-buffered, each loaded into registers a slab ahead of the products
// that read it (float4 where a weight's rows are 16-byte aligned).  Every
// load is bounds-checked and zero-fills past M, D, F and Do, so odd D needs
// no alignment and is padded only to the mma depth.  Do wider than one
// block (DOT = 32 * NJW columns, at most 320) is tiled over blockIdx.y;
// each such block recomputes T.
//
// Left for later: cp.async / TMA pipelines that overlap the tile loads with
// the products, warpgroup `wgmma` instead of mma.sync, and one launch
// instead of two where S > 1.

#include <type_traits>

#include "mma.cuh"

namespace {

constexpr int BM = 64;   // rows per block
constexpr int BF = 64;   // columns of T per tile
constexpr int DK = 32;   // slab of D per step of the first product
constexpr int FK = 16;   // slab of BF per step of the second product
constexpr int WC = 4;    // warps across the columns; 4 across the rows (16 each)
constexpr int NT = 32 * 4 * WC;  // 512 threads
constexpr int NH = BF / (8 * WC);  // 8-column mma tiles of T a warp computes
constexpr int XMAX = 320;  // widest D whose x block stays in shared memory

// Shared memory of one instance, in elements: the resident x block (XR), then
// the slab buffers, two of each phase (the operand slabs of the first
// product and the w2 slabs of the second are never live at once and share
// one region), then T.  XR instances pass the 48 KiB a launch gets without
// opting in (up to 220 KiB at D = 305).
template <typename T, bool GATED, int NJW, bool XR>
struct Layout {
  using S = typename Mma<T>::S;
  static constexpr int DOT = 8 * WC * NJW;  // output columns per block: NJW 8-column tiles a warp
  static constexpr int LDX = DK + Mma<T>::PAD_A, LDT = BF + Mma<T>::PAD_A;
  // the resident x block: [BM][ldxr], ldxr <= LDXR as the launch sizes it
  static constexpr int LDXR = XMAX + Mma<T>::PAD_A;
  static constexpr int LDW = BF + Mma<T>::PAD_B, LDO = DOT + Mma<T>::PAD_B;
  static constexpr int XR_ = XR ? Mma<T>::X_PARTS * BM * LDXR : 0;
  static constexpr int XS = XR ? 0 : BM * LDX, WS = DK * LDW, OS = FK * LDO;
  static constexpr int P1 = XS + WS * (GATED ? 2 : 1);  // one buffer of each phase
  static constexpr int UNION = 2 * (P1 > OS ? P1 : OS);
  static constexpr size_t BYTES = sizeof(S) * (XR_ + UNION + BM * LDT);  // the most
  static size_t bytes(int ldxr) {
    return sizeof(S) * ((XR ? Mma<T>::X_PARTS * BM * ldxr : 0) + UNION + BM * LDT);
  }
  // elements of a slab each thread loads: x, w1 (and wg), w2
  static constexpr int XQ = BM * DK / NT, WQ = DK * BF / NT, OQ = FK * DOT / NT;
  // float4s of a w2 slab each thread loads, and the registers either way takes
  static constexpr int OQ4 = (FK * DOT / 4 + NT - 1) / NT;
  static constexpr int OV = OQ > 4 * OQ4 ? OQ : 4 * OQ4;
};

// 0 = gelu (tanh form), 1 = silu, 2 = relu^2
__device__ __forceinline__ float activate(float v, int act) {
  if (act == 0) {  // 0.5 v (1 + tanh u) = v / (1 + exp(-2u))
    const float u = 0.7978845608028654f * (v + 0.044715f * v * v * v);
    return v / (1.f + expf(-2.f * u));
  }
  if (act == 1) return v / (1.f + expf(-v));
  const float r = fmaxf(v, 0.f);
  return r * r;
}

template <typename T, bool GATED, int NJW, bool XR>
__global__ void __launch_bounds__(NT, 1)
ibn_kernel(const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ wg,
           const T* __restrict__ w2, T* __restrict__ out, float* __restrict__ ws, int M, int D,
           int F, int Do, int act, int ldxr) {
  using L = Layout<T, GATED, NJW, XR>;
  using S = typename Mma<T>::S;
  using MM = Mma<T>;
  constexpr int K = MM::K;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* smem = reinterpret_cast<S*>(smem_raw);
  // XR: the block's x rows, [X_PARTS][BM][ldxr], for all its F tiles.  Two
  // buffers of each phase, the slab being read and the slab being written:
  // phase 1 [BM][LDX] x (unless XR), [DK][LDW] w1 (and wg); phase 2
  // [FK][LDO] w2.
  S* xr = smem;
  S* slabs = smem + (XR ? MM::X_PARTS * BM * ldxr : 0);
  auto xs = [&](int b) { return slabs + b * L::P1; };
  auto w1s = [&](int b) { return slabs + b * L::P1 + L::XS; };
  auto wgs = [&](int b) { return slabs + b * L::P1 + L::XS + L::WS; };
  auto w2s = [&](int b) { return slabs + b * L::OS; };
  S* tp = slabs + L::UNION;  // T: [BM][LDT]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wr = warp % 4, wc = warp / 4;  // row slab of 16, column group
  const int g = lane / 4, t = lane % 4;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * L::DOT;

  float acc[NJW][4];  // this warp's 16 rows x NJW 8-column mma tiles of the output
#pragma unroll
  for (int j = 0; j < NJW; ++j) zero(acc[j]);

  // Slabs go from device memory to registers a slab ahead of the products
  // that read them (all loads of a slab in flight at once), then to shared
  // memory.  float32 weights whose rows are 16-byte aligned (F and Do
  // multiples of 4) move as float4; x, whose rows have the odd length of a
  // folded bias, moves element by element.
  constexpr bool F32 = sizeof(T) == 4;
  const bool vec_w = F32 && F % 4 == 0 && reinterpret_cast<uintptr_t>(w1) % 16 == 0 &&
                     (!GATED || reinterpret_cast<uintptr_t>(wg) % 16 == 0);
  const bool vec_o = F32 && Do % 4 == 0 && reinterpret_cast<uintptr_t>(w2) % 16 == 0;
  float xv[L::XQ], wv[L::WQ], gv[L::WQ], ov[L::OV];  // gv: gated only
  auto load_p1 = [&](int f0, int k0) {
#pragma unroll
    for (int q = 0; q < (XR ? 0 : L::XQ); ++q) {
      const int i = tid + q * NT, gk = k0 + i % DK;
      const long long gm = m0 + i / DK;
      xv[q] = (gm < M && gk < D) ? to_f32(x[gm * D + gk]) : 0.f;
    }
    if (F32 && vec_w) {  // one float4 a thread: row tid / 16, columns 4 (tid % 16) ..
      static_assert(L::WQ == 4, "a w1 slab is one float4 a thread");
      const int gk = k0 + tid / 16, gf = f0 + 4 * (tid % 16);
      const bool ok = gk < D && gf < F;
      const long long o = (long long)gk * F + gf;
      const float4 v = ok ? *reinterpret_cast<const float4*>(w1 + o) : make_float4(0, 0, 0, 0);
      wv[0] = v.x, wv[1] = v.y, wv[2] = v.z, wv[3] = v.w;
      if (GATED) {
        const float4 u = ok ? *reinterpret_cast<const float4*>(wg + o) : make_float4(0, 0, 0, 0);
        gv[0] = u.x, gv[1] = u.y, gv[2] = u.z, gv[3] = u.w;
      }
      return;
    }
#pragma unroll
    for (int q = 0; q < L::WQ; ++q) {
      const int i = tid + q * NT, gk = k0 + i / BF, gf = f0 + i % BF;
      const bool ok = gk < D && gf < F;
      const long long o = (long long)gk * F + gf;
      wv[q] = ok ? to_f32(w1[o]) : 0.f;
      if (GATED) gv[q] = ok ? to_f32(wg[o]) : 0.f;
    }
  };
  auto store_p1 = [&](int b) {
#pragma unroll
    for (int q = 0; q < (XR ? 0 : L::XQ); ++q) {
      const int i = tid + q * NT;
      from_f32(xv[q], xs(b) + (i / DK) * L::LDX + i % DK);
    }
    if (F32 && vec_w) {
      const int o = (tid / 16) * L::LDW + 4 * (tid % 16);
      *reinterpret_cast<float4*>(w1s(b) + o) = make_float4(wv[0], wv[1], wv[2], wv[3]);
      if (GATED)
        *reinterpret_cast<float4*>(wgs(b) + o) = make_float4(gv[0], gv[1], gv[2], gv[3]);
      return;
    }
#pragma unroll
    for (int q = 0; q < L::WQ; ++q) {
      const int i = tid + q * NT, o = (i / BF) * L::LDW + i % BF;
      from_f32(wv[q], w1s(b) + o);
      if (GATED) from_f32(gv[q], wgs(b) + o);
    }
  };
  auto load_p2 = [&](int gf0) {
    if (F32 && vec_o) {  // float4 v = tid + q NT: row v / (DOT / 4), columns 4 (v % (DOT / 4)) ..
#pragma unroll
      for (int q = 0; q < L::OQ4; ++q) {
        const int v = tid + q * NT, gf = gf0 + v / (L::DOT / 4), gn = n0 + 4 * (v % (L::DOT / 4));
        const bool ok = v < FK * L::DOT / 4 && gf < F && gn < Do;
        const float4 u = ok ? *reinterpret_cast<const float4*>(w2 + (long long)gf * Do + gn)
                            : make_float4(0, 0, 0, 0);
        ov[4 * q] = u.x, ov[4 * q + 1] = u.y, ov[4 * q + 2] = u.z, ov[4 * q + 3] = u.w;
      }
      return;
    }
#pragma unroll
    for (int q = 0; q < L::OQ; ++q) {
      const int i = tid + q * NT, gf = gf0 + i / L::DOT, gn = n0 + i % L::DOT;
      ov[q] = (gf < F && gn < Do) ? to_f32(w2[(long long)gf * Do + gn]) : 0.f;
    }
  };
  auto store_p2 = [&](int b) {
    if (F32 && vec_o) {
#pragma unroll
      for (int q = 0; q < L::OQ4; ++q) {
        const int v = tid + q * NT;
        if (v < FK * L::DOT / 4)
          *reinterpret_cast<float4*>(w2s(b) + (v / (L::DOT / 4)) * L::LDO + 4 * (v % (L::DOT / 4))) =
              make_float4(ov[4 * q], ov[4 * q + 1], ov[4 * q + 2], ov[4 * q + 3]);
      }
      return;
    }
#pragma unroll
    for (int q = 0; q < L::OQ; ++q) {
      const int i = tid + q * NT;
      from_f32(ov[q], w2s(b) + (i / L::DOT) * L::LDO + i % L::DOT);
    }
  };

  // this block's contiguous share of the F tiles (gridDim.z shares, none empty)
  const int nf = (F + BF - 1) / BF;
  const int t_lo = (int)((long long)blockIdx.z * nf / gridDim.z);
  const int t_hi = (int)((long long)(blockIdx.z + 1) * nf / gridDim.z);
  // One slab of the first product into up (and gt): sums from zero, then
  // added.  Branch-free where the slab is whole (FULL); past D the last slab
  // is zero and stops at the mma depth.
  float up[NH][4], gt[NH][4];  // gt: the gate's product, gated only
  auto slab1 = [&](auto full, int b, int k0) {
    float su[NH][4], sg[NH][4];
#pragma unroll
    for (int h = 0; h < NH; ++h) zero(su[h]), zero(sg[h]);
#pragma unroll
    for (int kk = 0; kk < DK; kk += K) {
      if (!decltype(full)::value && kk >= D - k0) break;
      const typename MM::A a =
          XR ? MM::load_x(xr + wr * 16 * ldxr + k0 + kk, ldxr, BM * ldxr, lane)
             : MM::load_a(xs(b) + wr * 16 * L::LDX + kk, L::LDX, lane);
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        const int col = (wc * NH + h) * 8;
        MM::mma(su[h], a, MM::load_b(w1s(b) + kk * L::LDW + col, L::LDW, lane));
        if (GATED) MM::mma(sg[h], a, MM::load_b(wgs(b) + kk * L::LDW + col, L::LDW, lane));
      }
    }
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      add(up[h], su[h]);
      if (GATED) add(gt[h], sg[h]);
    }
  };
  // One slab of the second product into acc, each 8-column tile summed from
  // zero, then added.  Branch-free where the slab is whole (FULLK) and all
  // of this warp's columns are below Do (FULLN).
  auto slab2 = [&](auto fullk, auto fulln, int b, int fk0, int fmax) {
    typename MM::A a[FK / K];
#pragma unroll
    for (int s = 0; s < FK / K; ++s)
      a[s] = MM::load_a(tp + wr * 16 * L::LDT + fk0 + s * K, L::LDT, lane);
#pragma unroll
    for (int j = 0; j < NJW; ++j) {
      const int col = (wc * NJW + j) * 8;
      if (!decltype(fulln)::value && n0 + col >= Do) break;  // columns past Do are zero
      float sum[4];
      zero(sum);
#pragma unroll
      for (int s = 0; s < FK / K; ++s) {
        if (!decltype(fullk)::value && fk0 + s * K >= fmax) break;
        MM::mma(sum, a[s], MM::load_b(w2s(b) + s * K * L::LDO + col, L::LDO, lane));
      }
      add(acc[j], sum);
    }
  };
  const bool warp_full_n = n0 + (wc + 1) * NJW * 8 <= Do;

  load_p1(t_lo * BF, 0);
  if (XR) {  // once: the block's x rows, zero past M and from D to the slab, 8 loads in flight
    const int dr = (D + DK - 1) / DK * DK, n = BM * dr;
    for (int e0 = 0; e0 < n; e0 += 8 * NT) {
      float v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int e = e0 + q * NT + tid, r = e / dr, k = e - r * dr;
        const long long gm = m0 + r;
        v[q] = e < n && gm < M && k < D ? to_f32(x[gm * D + k]) : 0.f;
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int e = e0 + q * NT + tid, r = e / dr;
        if (e < n) MM::put_x(v[q], xr + r * ldxr + e - r * dr, BM * ldxr);
      }
    }
  }
  for (int f0 = t_lo * BF; f0 < t_hi * BF; f0 += BF) {
    // ---- first product: T tile (BM, BF); warp (wr, wc) owns its 16 x 8 * NH ----
#pragma unroll
    for (int h = 0; h < NH; ++h) zero(up[h]), zero(gt[h]);
    store_p1(0);
    __syncthreads();
    for (int k0 = 0, b = 0; k0 < D; k0 += DK, b ^= 1) {
      const bool more = k0 + DK < D;
      if (more) load_p1(f0, k0 + DK);  // in flight during the products
      if (k0 + DK <= D) slab1(std::true_type{}, b, k0);
      else slab1(std::false_type{}, b, k0);
      if (more) store_p1(b ^ 1);
      __syncthreads();
    }

    // ---- activation in registers, mask past F, round to the input type,
    //      to shared memory as the A operand of the second product ----
    load_p2(f0);  // the first w2 slab, in flight meanwhile
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = wr * 16 + g + (e / 2) * 8, c = (wc * NH + h) * 8 + 2 * t + e % 2;
        const float v = GATED ? activate(gt[h][e], act) * up[h][e] : activate(up[h][e], act);
        from_f32(f0 + c < F ? v : 0.f, tp + r * L::LDT + c);
      }
    store_p2(0);
    __syncthreads();  // T and the first w2 slab are in shared memory

    // ---- second product: acc (BM, DOT) += T tile @ w2 tile, BF in slabs ----
    const int fmax = F - f0 < BF ? F - f0 : BF;
    for (int fk0 = 0, b = 0; fk0 < fmax; fk0 += FK, b ^= 1) {
      const bool more = fk0 + FK < fmax;
      if (more) load_p2(f0 + fk0 + FK);
      else if (f0 + BF < t_hi * BF) load_p1(f0 + BF, 0);  // the next tile's first slab
      const bool full_k = fk0 + FK <= fmax;
      if (full_k && warp_full_n) slab2(std::true_type{}, std::true_type{}, b, fk0, fmax);
      else if (warp_full_n) slab2(std::false_type{}, std::true_type{}, b, fk0, fmax);
      else if (full_k) slab2(std::true_type{}, std::false_type{}, b, fk0, fmax);
      else slab2(std::false_type{}, std::false_type{}, b, fk0, fmax);
      if (more) store_p2(b ^ 1);
      __syncthreads();
    }
  }

  // ---- epilogue: to out (S == 1) or to this split's float32 partial ----
  // (a float32 partial's two neighbouring columns as one float2 where Do is even)
#pragma unroll
  for (int j = 0; j < NJW; ++j)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const long long gm = m0 + wr * 16 + g + (e / 2) * 8;
      const int gn = n0 + (wc * NJW + j) * 8 + 2 * t;
      if (gm >= M || gn >= Do) continue;
      if (gridDim.z == 1) {
        from_f32(acc[j][e], out + gm * Do + gn);
        if (gn + 1 < Do) from_f32(acc[j][e + 1], out + gm * Do + gn + 1);
      } else if (Do % 2 == 0) {
        *reinterpret_cast<float2*>(ws + ((long long)blockIdx.z * M + gm) * Do + gn) =
            make_float2(acc[j][e], acc[j][e + 1]);
      } else {
        ws[((long long)blockIdx.z * M + gm) * Do + gn] = acc[j][e];
        if (gn + 1 < Do) ws[((long long)blockIdx.z * M + gm) * Do + gn + 1] = acc[j][e + 1];
      }
    }
}

// out = the sum of the S float32 partials in ws, taken in the fixed order
// s = 0..S-1 (no atomics: the same bits on every run), cast to T
template <typename T>
__global__ void __launch_bounds__(NT)
ibn_reduce_kernel(const float* __restrict__ ws, T* __restrict__ out, long long n, int S) {
  if (n % 4 == 0) {  // four elements a step (ws is 16-byte aligned)
    const float4* w4 = reinterpret_cast<const float4*>(ws);
    for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < n / 4;
         i += (long long)gridDim.x * NT) {
      float4 sum = w4[i];
      for (int z = 1; z < S; ++z) {
        const float4 v = w4[z * (n / 4) + i];
        sum.x += v.x, sum.y += v.y, sum.z += v.z, sum.w += v.w;
      }
      from_f32(sum.x, out + 4 * i), from_f32(sum.y, out + 4 * i + 1);
      from_f32(sum.z, out + 4 * i + 2), from_f32(sum.w, out + 4 * i + 3);
    }
    return;
  }
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < n;
       i += (long long)gridDim.x * NT) {
    float sum = ws[i];
    for (int z = 1; z < S; ++z) sum += ws[z * n + i];
    from_f32(sum, out + i);
  }
}

constexpr int MAX_DEVICES = 64;

template <typename T, bool GATED, int NJW, bool XR>
cudaError_t launch_ibn_(const void* x, const void* w1, const void* wg, const void* w2, void* out,
                       void* ws, long long M, int D, int F, int Do, int S, int act,
                       cudaStream_t s) {
  using L = Layout<T, GATED, NJW, XR>;
  auto kern = ibn_kernel<T, GATED, NJW, XR>;
  // shared memory past the 48 KiB a launch gets without asking: opt in once
  // per instance and device
  static bool opted_in[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES || !opted_in[dev]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::BYTES);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES) opted_in[dev] = true;
  }
  // the x block's rows padded to the slab, and by PAD_A (no bank conflicts)
  const int ldxr = (D + DK - 1) / DK * DK + Mma<T>::PAD_A;
  kern<<<dim3((unsigned)((M + BM - 1) / BM), (Do + L::DOT - 1) / L::DOT, S), NT, L::bytes(ldxr),
         s>>>((const T*)x, (const T*)w1, (const T*)wg, (const T*)w2, (T*)out, (float*)ws, (int)M,
              D, F, Do, act, ldxr);
  return cudaGetLastError();
}

// x stays in shared memory where D allows; the gated form, which only LM
// widths use, always streams it
template <typename T, bool GATED, int NJW>
cudaError_t launch_ibn(const void* x, const void* w1, const void* wg, const void* w2, void* out,
                       void* ws, long long M, int D, int F, int Do, int S, int act,
                       cudaStream_t s) {
  if constexpr (!GATED)
    if (D <= XMAX)
      return launch_ibn_<T, false, NJW, true>(x, w1, wg, w2, out, ws, M, D, F, Do, S, act, s);
  return launch_ibn_<T, GATED, NJW, false>(x, w1, wg, w2, out, ws, M, D, F, Do, S, act, s);
}

template <typename T, bool GATED>
int launch(const void* x, const void* w1, const void* wg, const void* w2, void* out, void* ws,
           long long M, int D, int F, int Do, int S, int act, cudaStream_t s) {
  // the Do menu of block columns (DOT = 32 * NJW): 64, 96, 160, 320; the
  // wrapper's plan() mirrors it as BLOCK_DO
  cudaError_t err;
  if (Do <= 64) err = launch_ibn<T, GATED, 2>(x, w1, wg, w2, out, ws, M, D, F, Do, S, act, s);
  else if (Do <= 96) err = launch_ibn<T, GATED, 3>(x, w1, wg, w2, out, ws, M, D, F, Do, S, act, s);
  else if (Do <= 160) err = launch_ibn<T, GATED, 5>(x, w1, wg, w2, out, ws, M, D, F, Do, S, act, s);
  else err = launch_ibn<T, GATED, 10>(x, w1, wg, w2, out, ws, M, D, F, Do, S, act, s);
  if (err != cudaSuccess || S == 1) return (int)err;
  const long long n = M * Do;
  const long long blocks = (n + NT - 1) / NT;
  ibn_reduce_kernel<T><<<(unsigned)(blocks < 4096 ? blocks : 4096), NT, 0, s>>>(
      (const float*)ws, (T*)out, n, S);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; act: 0 gelu-tanh, 1 silu, 2 relu^2;
// wg == nullptr selects the ungated form.  S (splits) shares of the F tiles
// run as blockIdx.z, 1 <= S <= ceil(F / 64); S > 1 needs ws, a float32
// workspace of S * M * Do, whose partials a second kernel sums into out.
// Returns the error of the first launch that fails, else 0.
extern "C" int repro_fused_ibn(const void* x, const void* w1, const void* wg, const void* w2,
                               void* out, void* ws, long long M, int D, int F, int Do, int S,
                               int act, int dtype, void* stream) {
  if (M <= 0 || M > 2147483647LL || D <= 0 || F <= 0 || Do <= 0 || act < 0 || act > 2 ||
      (Do + 319) / 320 > 65535 || S < 1 || S > (F + BF - 1) / BF || S > 65535 ||
      (S > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return wg ? launch<float, true>(x, w1, wg, w2, out, ws, M, D, F, Do, S, act, s)
              : launch<float, false>(x, w1, wg, w2, out, ws, M, D, F, Do, S, act, s);
  if (dtype == 1)
    return wg ? launch<__nv_bfloat16, true>(x, w1, wg, w2, out, ws, M, D, F, Do, S, act, s)
              : launch<__nv_bfloat16, false>(x, w1, wg, w2, out, ws, M, D, F, Do, S, act, s);
  return (int)cudaErrorInvalidValue;
}
