// Channels-last SAME depthwise convolution + bias for Hopper (sm_90a).
//
// Replaces the TPU kernel `depthwise_conv2d` / `_dw_kernel` of
// src/repro/kernels/depthwise_conv.py.  That kernel pads the image in its
// wrapper and loads one whole padded plane per grid step; here nothing is
// padded or copied: the halo is a bounds check in the tap loop.
//
// Bound on this card: bytes.  Each output needs fy*fx multiply-adds but
// the input, read once, and the output, written once, already cost more
// time at the card's memory rate than those adds cost at its float32 rate.
// Design: the channel is the fastest thread index, so a warp reads 32
// neighbouring channels of one pixel in one 128-byte segment; a block owns
// a chunk of 32 channels, keeps that chunk's fy*fx weights in shared
// memory, and each thread carries TY vertically neighbouring outputs in
// registers so that a loaded input value is used for up to TY taps before
// it is dropped.  Inputs shared by neighbouring threads come from L1/L2.
// Any C is taken: lanes past C are masked, no divisor of C is needed.
//
// The input may be a channel slice of a wider channels-last tensor: the
// caller passes the distance between two pixels (`x_pix_stride`, in
// elements).  The output is always dense [B, H, W, C].

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int CX = 32;  // channels per block (one warp wide)
constexpr int PX = 8;   // output columns per block
constexpr int TY = 4;   // output rows per thread
constexpr int MAX_TAPS = 15 * 15;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* p) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(CX * PX)
dw_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
          T* __restrict__ out, int H, int W, int C, long long x_pix_stride,
          int fy, int fx, int tiles_x) {
  __shared__ float sw[MAX_TAPS * CX];

  const int lane = threadIdx.x;
  const int c = blockIdx.x * CX + lane;
  const int ox = (blockIdx.y % tiles_x) * PX + threadIdx.y;
  const int oy0 = (blockIdx.y / tiles_x) * TY;
  const int bi = blockIdx.z;
  const bool c_ok = c < C;

  // this chunk's weights: sw[tap][lane]
  for (int i = threadIdx.y * CX + lane; i < fy * fx * CX; i += CX * PX) {
    const int tap = i / CX, l = i % CX;
    const int cc = blockIdx.x * CX + l;
    sw[i] = cc < C ? to_f32(w[(long long)tap * C + cc]) : 0.f;
  }
  __syncthreads();

  if (!c_ok || ox >= W) return;

  const int py0 = (fy - 1) / 2, px0 = (fx - 1) / 2;
  float acc[TY];
#pragma unroll
  for (int r = 0; r < TY; ++r) acc[r] = 0.f;

  const T* xb = x + (long long)bi * H * W * x_pix_stride + c;
  const int iy_lo = max(oy0 - py0, 0);
  const int iy_hi = min(oy0 + TY - 1 - py0 + fy - 1, H - 1);
  for (int iy = iy_lo; iy <= iy_hi; ++iy) {
    for (int dx = 0; dx < fx; ++dx) {
      const int ix = ox + dx - px0;
      if (ix < 0 || ix >= W) continue;
      const float v = to_f32(xb[((long long)iy * W + ix) * x_pix_stride]);
#pragma unroll
      for (int r = 0; r < TY; ++r) {
        const int dy = iy - (oy0 + r) + py0;
        if (dy >= 0 && dy < fy) acc[r] += v * sw[(dy * fx + dx) * CX + lane];
      }
    }
  }

  const float bias = to_f32(b[c]);
#pragma unroll
  for (int r = 0; r < TY; ++r) {
    const int oy = oy0 + r;
    if (oy < H) from_f32(acc[r] + bias, out + (((long long)bi * H + oy) * W + ox) * C + c);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() of the launch.
extern "C" int repro_depthwise_conv2d(const void* x, const void* w, const void* b, void* out,
                                      int B, int H, int W, int C, long long x_pix_stride,
                                      int fy, int fx, int dtype, void* stream) {
  const int tiles_x = (W + PX - 1) / PX, tiles_y = (H + TY - 1) / TY;
  if (fy * fx > MAX_TAPS || B <= 0 || B > 65535 || (long long)tiles_x * tiles_y > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((C + CX - 1) / CX, tiles_x * tiles_y, B), block(CX, PX);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    dw_kernel<float><<<grid, block, 0, s>>>((const float*)x, (const float*)w, (const float*)b,
                                            (float*)out, H, W, C, x_pix_stride, fy, fx, tiles_x);
  } else if (dtype == 1) {
    dw_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (const __nv_bfloat16*)b,
        (__nv_bfloat16*)out, H, W, C, x_pix_stride, fy, fx, tiles_x);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
