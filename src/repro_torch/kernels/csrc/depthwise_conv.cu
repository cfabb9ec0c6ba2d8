// Channels-last SAME depthwise convolution + bias for Hopper (sm_90a).
//
// Replaces the TPU kernel `depthwise_conv2d` / `_dw_kernel` of
// src/repro/kernels/depthwise_conv.py.  That kernel pads the image in its
// wrapper and loads one whole padded plane per grid step.  Here nothing is
// padded in device memory: each block stages its own halo tile in shared
// memory, zero-filled outside the image.
//
// Bound on this card: bytes.  Each output needs fy*fx multiply-adds but the
// input, read once, and the output, written once, already cost more time at
// the card's memory rate than those adds cost at its float32 rate.  At the
// EdgeNeXt-S shapes a launch moves 0.2-25 MB, so a few microseconds of
// latency (the copy in, the taps, the store) weigh as much as the bytes.
//
// Design.  A block owns TH x TW output pixels x CB channels of one image; the
// wrapper's plan() picks the tile for the shape and the card and this file
// refuses one it cannot run.
// 1. The block copies the chunk's fy*fx weights and its (TH + fy - 1) x
//    (TW + fx - 1) x CB input tile to shared memory with cp.async, CV
//    channels a copy, and zero where the pixel lies outside the image: SAME
//    padding is that zero fill, so the tap loop checks no bounds.  A copy is
//    16 bytes (`.cg`) where CV = 4 float32 channels fit the alignment of the
//    rows, else 8 or 4 (`.ca`); one bf16 channel, 2 bytes, which cp.async
//    cannot copy, by a plain load.  The tile's rows are padded so that the
//    threads of a warp, which walk the channel groups and then the rows,
//    read distinct banks.
// 2. A thread owns CV channels (read from shared memory as one vector) of
//    SW neighbouring outputs of one row.  For each tap row dy it reads the
//    SW + fx - 1 inputs of its strip once and uses each for up to fx taps,
//    with the row's fx weight vectors read once.  (fy, fx) = 3x3, 5x5, 7x7
//    and 9x9, the EdgeNeXt sizes, are compile-time: the taps of a row unroll
//    and its inputs and weights stay in registers.  The rows do not unroll:
//    unrolled, the 5x5 and 7x7 instances with CV = 4 spilled 1.9-3.4 KB a
//    thread and ran 8x slower.  Every other size runs the same
//    tiled kernel with run-time fy and fx (`KY = KX = 0`), reading an input
//    for each tap.
// 3. It adds the bias and stores its SW outputs, each float32 sum rounded
//    once to the output type.
// Every output sums its taps from zero in the order dy, then dx, and then
// adds the bias: one order in every instance and on every call, so two
// calls give the same bits.
//
// The input may be a channel slice of a wider channels-last tensor: the
// caller passes the distance between two pixels (`x_pix_stride`, in
// elements), and CV must divide C and suit the alignment of the slice's
// start, of that stride and of w.  The output is always dense [B, H, W, C].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int SW = 4;                    // outputs along W a thread computes
constexpr int MAX_THREADS = 256;         // threads of a block
constexpr int MAX_TAPS = 15 * 15;
constexpr int SMEM_DEFAULT = 48 * 1024;  // dynamic shared memory without opting in
constexpr int SMEM_OPT_IN = 227 * 1024;  // the most a block may opt into
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// CV elements of T, read or written as one aligned vector
template <typename T, int CV>
struct alignas(sizeof(T) * CV) Pack {
  T v[CV];
};

template <typename T, int CV>
__device__ __forceinline__ void load_f32(const T* p, float (&out)[CV]) {
  const Pack<T, CV> pk = *reinterpret_cast<const Pack<T, CV>*>(p);
#pragma unroll
  for (int i = 0; i < CV; ++i) out[i] = to_f32(pk.v[i]);
}

// CV channels of one pixel into shared memory, or zeros where !valid
template <typename T, int CV>
__device__ __forceinline__ void stage(T* dst, const T* src, bool valid, const T* base) {
  constexpr int N = sizeof(T) * CV;
  if constexpr (N >= 4)
    copy_bytes<N>(dst, src, valid, base);
  else
    *dst = valid ? *src : from_f32<T>(0.f);
}

// Elements between two rows of a halo tile in shared memory: pw pixels of
// G vectors, padded so that the vectors of neighbouring rows fall on
// neighbouring banks (a row is G vectors further on, modulo the 128 bytes
// of a bank cycle), as if the rows were G vectors long.
template <typename T, int CV>
__device__ __forceinline__ int row_pitch(int pw, int G) {
  constexpr int NB = 128 / (int)(sizeof(T) * CV);  // vectors in a bank cycle
  const int units = pw * G;
  return CV * (units + ((G - units) % NB + NB) % NB);
}

template <typename T, int CV, int KY, int KX>
__global__ void __launch_bounds__(MAX_THREADS)
dw_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
          T* __restrict__ out, int H, int W, int C, long long ps, int fy_, int fx_, int th,
          int tw, int cb, int tiles_x) {
  constexpr bool FIXED = KY > 0;
  const int fy = FIXED ? KY : fy_, fx = FIXED ? KX : fx_;
  const int G = cb / CV;                         // channel groups of CV channels
  const int ph = th + fy - 1, pw = tw + fx - 1;  // the halo tile
  const int pitch = row_pitch<T, CV>(pw, G);
  extern __shared__ __align__(16) unsigned char smem[];
  T* sw = reinterpret_cast<T*>(smem);  // [fy * fx][cb]
  T* sx = sw + fy * fx * cb;           // [ph][pitch]: pixel q of row r at r * pitch + q * cb

  // a thread: channel group g of the strip of SW outputs at row r, strip s
  const int tid = threadIdx.x, g = tid % G, r = tid / G % th, s = tid / G / th;
  const int oy0 = (blockIdx.x / tiles_x) * th, ox0 = (blockIdx.x % tiles_x) * tw;
  const int c0 = blockIdx.y * cb, c = c0 + g * CV, bi = blockIdx.z;
  const bool c_ok = c < C;  // C % CV == 0: a group lies wholly inside C or past it
  const int py0 = (fy - 1) / 2, px0 = (fx - 1) / 2;

  // 1. the chunk's weights and the halo tile, zero past C and outside the image
  for (int i = tid; i < fy * fx * G; i += blockDim.x) {
    const int tap = i / G, cc = c0 + (i - tap * G) * CV;
    stage<T, CV>(sw + tap * cb + (cc - c0), w + (long long)tap * C + cc, cc < C, w);
  }
  const T* xb = x + (long long)bi * H * W * ps + c;
  for (int p = tid / G; p < ph * pw; p += blockDim.x / G) {
    const int pr = p / pw, q = p - pr * pw, iy = oy0 - py0 + pr, ix = ox0 - px0 + q;
    const bool ok = c_ok && iy >= 0 && iy < H && ix >= 0 && ix < W;
    stage<T, CV>(sx + pr * pitch + q * cb + g * CV,
                 ok ? xb + ((long long)iy * W + ix) * ps : x, ok, x);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // 2. the taps of SW outputs of one row, CV channels each, dy then dx
  const int oy = oy0 + r, ox = ox0 + s * SW;
  const T* in0 = sx + r * pitch + s * SW * cb + g * CV;
  const T* w0 = sw + g * CV;
  float acc[SW][CV];
#pragma unroll
  for (int o = 0; o < SW; ++o)
#pragma unroll
    for (int v = 0; v < CV; ++v) acc[o][v] = 0.f;
  if constexpr (FIXED) {
#pragma unroll 1
    for (int dy = 0; dy < KY; ++dy) {
      float in[SW + KX - 1][CV];
#pragma unroll
      for (int q = 0; q < SW + KX - 1; ++q) load_f32<T, CV>(in0 + dy * pitch + q * cb, in[q]);
#pragma unroll
      for (int dx = 0; dx < KX; ++dx) {
        float wv[CV];
        load_f32<T, CV>(w0 + (dy * KX + dx) * cb, wv);
#pragma unroll
        for (int o = 0; o < SW; ++o)
#pragma unroll
          for (int v = 0; v < CV; ++v) acc[o][v] = fmaf(in[o + dx][v], wv[v], acc[o][v]);
      }
    }
  } else {
    for (int dy = 0; dy < fy; ++dy)
      for (int dx = 0; dx < fx; ++dx) {
        float wv[CV];
        load_f32<T, CV>(w0 + (dy * fx + dx) * cb, wv);
#pragma unroll
        for (int o = 0; o < SW; ++o) {
          float iv[CV];
          load_f32<T, CV>(in0 + dy * pitch + (o + dx) * cb, iv);
#pragma unroll
          for (int v = 0; v < CV; ++v) acc[o][v] = fmaf(iv[v], wv[v], acc[o][v]);
        }
      }
  }

  // 3. the bias, one rounding to T, the store
  if (!c_ok || oy >= H) return;
  float bias[CV];
#pragma unroll
  for (int v = 0; v < CV; ++v) bias[v] = to_f32(b[c + v]);
  T* orow = out + ((long long)bi * H + oy) * W * C + c;
#pragma unroll
  for (int o = 0; o < SW; ++o) {
    if (ox + o >= W) break;
    Pack<T, CV> pk;
#pragma unroll
    for (int v = 0; v < CV; ++v) pk.v[v] = from_f32<T>(acc[o][v] + bias[v]);
    *reinterpret_cast<Pack<T, CV>*>(orow + (long long)(ox + o) * C) = pk;
  }
}

struct Args {
  const void *x, *w, *b;
  void* out;
  int B, H, W, C;
  long long ps;
  int fy, fx, th, tw, cb;
};

template <typename T, int CV, int KY, int KX>
cudaError_t launch(const Args& a, int smem, cudaStream_t s) {
  auto kern = dw_kernel<T, CV, KY, KX>;
  if (smem > SMEM_DEFAULT) {  // opt in once per instance and device
    static bool opted_in[MAX_DEVICES] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= MAX_DEVICES || !opted_in[dev]) {
      err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_OPT_IN);
      if (err != cudaSuccess) return err;
      if (dev < MAX_DEVICES) opted_in[dev] = true;
    }
  }
  const int tiles_x = (a.W + a.tw - 1) / a.tw, tiles_y = (a.H + a.th - 1) / a.th;
  const dim3 grid(tiles_x * tiles_y, (a.C + a.cb - 1) / a.cb, a.B);
  kern<<<grid, a.cb / CV * (a.tw / SW) * a.th, smem, s>>>(
      (const T*)a.x, (const T*)a.w, (const T*)a.b, (T*)a.out, a.H, a.W, a.C, a.ps, a.fy, a.fx,
      a.th, a.tw, a.cb, tiles_x);
  return cudaGetLastError();
}

template <typename T, int CV>
cudaError_t launch_taps(const Args& a, int smem, cudaStream_t s) {
  if (a.fy == 3 && a.fx == 3) return launch<T, CV, 3, 3>(a, smem, s);
  if (a.fy == 5 && a.fx == 5) return launch<T, CV, 5, 5>(a, smem, s);
  if (a.fy == 7 && a.fx == 7) return launch<T, CV, 7, 7>(a, smem, s);
  if (a.fy == 9 && a.fx == 9) return launch<T, CV, 9, 9>(a, smem, s);
  return launch<T, CV, 0, 0>(a, smem, s);
}

template <typename T>
cudaError_t launch_cv(const Args& a, int cv, int smem, cudaStream_t s) {
  if (cv == 4) return launch_taps<T, 4>(a, smem, s);
  if (cv == 2) return launch_taps<T, 2>(a, smem, s);
  return launch_taps<T, 1>(a, smem, s);
}

}  // namespace

// The tile (th, tw, cb) and the channels a thread reads as one vector (cv)
// come from the wrapper's plan().  dtype: 0 = float32, 1 = bfloat16.
// Returns cudaErrorInvalidValue for arguments or a plan the kernel cannot
// run (no launch), else cudaGetLastError() of the launch.
extern "C" int repro_depthwise_conv2d(const void* x, const void* w, const void* b, void* out,
                                      int B, int H, int W, int C, long long x_pix_stride,
                                      int fy, int fx, int th, int tw, int cb, int cv, int dtype,
                                      void* stream) {
  const int itemsize = dtype == 0 ? 4 : dtype == 1 ? 2 : 0;
  const long long vec = (long long)cv * itemsize;
  if (!itemsize || (cv != 1 && cv != 2 && cv != 4) || B <= 0 || B > 65535 || H <= 0 ||
      W <= 0 || C <= 0 || fy <= 0 || fx <= 0 || fy > MAX_TAPS || fx > MAX_TAPS ||
      fy * fx > MAX_TAPS || x_pix_stride < C || C % cv || cb <= 0 || cb % cv || th <= 0 ||
      th > H || tw <= 0 || tw % SW || (uintptr_t)x % vec || (uintptr_t)w % vec ||
      (uintptr_t)out % vec || (x_pix_stride * itemsize) % vec)
    return (int)cudaErrorInvalidValue;
  const long long threads = (long long)(cb / cv) * (tw / SW) * th;
  const long long tiles = (long long)((W + tw - 1) / tw) * ((H + th - 1) / th);
  const long long nb = 128 / vec, units = (long long)(tw + fx - 1) * (cb / cv);
  const long long pitch = cv * (units + ((cb / cv - units) % nb + nb) % nb);
  const long long smem = (long long)itemsize * ((long long)fy * fx * cb + (th + fy - 1) * pitch);
  if (threads > MAX_THREADS || smem > SMEM_OPT_IN || tiles > INT_MAX ||
      (C + cb - 1) / cb > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{x, w, b, out, B, H, W, C, x_pix_stride, fy, fx, th, tw, cb};
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(dtype == 0 ? launch_cv<float>(a, cv, (int)smem, s)
                          : launch_cv<__nv_bfloat16>(a, cv, (int)smem, s));
}
