// AdamW of one float32 leaf in one pass, in place, for Hopper (sm_90a).
//
// Replaces no Pallas kernel.  It is the port's counterpart of the loop that
// XLA fuses out of the reference's per-leaf update `upd`
// (src/repro/optim/adamw.py:47) under the launcher's
// `jit(train_step, donate_argnums=(0, 1))` (src/repro/launch/train.py:107),
// with the clip's scale of the gradient (src/repro/optim/clip.py) folded in.
// The port's eager composition ran 16 elementwise kernels a leaf, five of
// them into new leaf-sized tensors, and the clip's in-place scale: 156 bytes
// a float32 parameter.
//
// Bound on this card: bytes.  A parameter reads p, g, m and v and writes p, m
// and v, 28 bytes, for 16 floating-point operations and one square root:
// under one operation a byte, where the card does ~20 (67 TFLOP/s float32
// over 3.35 TB/s).  At h2o-danube-1.8b's 1,831,201,280 parameters the bound
// is 51.3 GB / 3.35 TB/s = 15.3 ms a step.
//
// Design.  Every element is independent: a grid-stride loop over float4s,
// neighbouring threads on neighbouring 16-byte words of each of the four
// arrays, THREADS a block and BLOCKS_PER_SM blocks a SM (2048 threads, the
// most a SM holds), fewer where the leaf is small.  Each thread keeps four
// 16-byte loads in flight an iteration.  Where the four base pointers share
// their offset within 16 bytes (a leaf of the caching allocator, or a slice
// of equal offset in each), the first 0-3 elements before the aligned body
// and the 0-3 after it take the scalar path; where they do not, every element
// does.  One launch a leaf, on the caller's stream, with no allocation and no
// synchronisation, so that a CUDA graph can hold it.
//
// Scalars.  lr, the bias corrections bc1 and bc2 and the clip's scale are
// read through pointers to the 0-d device tensors the step computes (the
// schedule's rate at the optimizer's count, 1 - b^count, min(1, max_norm /
// (norm + 1e-9))), never passed by value: a captured graph replays the
// launch with its arguments as captured, and would otherwise keep step 0's
// rate and bias corrections for ever.
//
// Rounding.  The same bits as the plain update (kernels/ref.py adamw_ref) on
// the card, which runs each operation as a kernel of its own and rounds each
// result to float32: every operation here is an `_rn` intrinsic, in the
// plain update's order, which nvcc never contracts into an FMA (its default
// --fmad=true would contract `a * b + c` and round once where the plain
// update rounds twice).  The plain update's divisions are true divisions
// (its divisors are device tensors, not host scalars, which PyTorch would
// take as a reciprocal product), its square root is correctly rounded, and
// its host scalars (b1, b2, 1 - b1, 1 - b2, eps, weight decay) are rounded to
// float32 once, as the wrapper rounds them.
//
//   g' = g * scale                       (the clip, rounded first)
//   m  = m * b1 + g' * (1 - b1)
//   v  = v * b2 + (g' * g') * (1 - b2)
//   p  = p - ((m / bc1) / (sqrt(v / bc2) + eps) + wd * p) * lr

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;

struct Hyper {
  float b1, b2, omb1, omb2, eps, wd;
};

struct Scalars {
  float lr, bc1, bc2, scale;
};

template <bool SCALED>
__device__ __forceinline__ void update(float& p, float g, float& m, float& v, const Scalars& s,
                                       const Hyper& h) {
  if (SCALED) g = __fmul_rn(g, s.scale);
  m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(g, h.omb1));
  v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(__fmul_rn(g, g), h.omb2));
  const float mhat = __fdiv_rn(m, s.bc1);
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), h.eps);
  const float step = __fadd_rn(__fdiv_rn(mhat, den), __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(step, s.lr));
}

// Elements [head, head + 4 * quads) as float4s (16-byte aligned in all four
// arrays), the `head` before them and the ragged tail after them one by one.
template <bool SCALED>
__global__ void __launch_bounds__(THREADS)
    adamw_kernel(float* __restrict__ p, const float* __restrict__ g, float* __restrict__ m,
                 float* __restrict__ v, const float* __restrict__ lr,
                 const float* __restrict__ bc1, const float* __restrict__ bc2,
                 const float* __restrict__ scale, long long n, long long head, long long quads,
                 Hyper h) {
  Scalars s;
  s.lr = *lr;
  s.bc1 = *bc1;
  s.bc2 = *bc2;
  s.scale = SCALED ? *scale : 1.0f;
  const long long first = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * THREADS;

  float4* p4 = reinterpret_cast<float4*>(p + head);
  const float4* g4 = reinterpret_cast<const float4*>(g + head);
  float4* m4 = reinterpret_cast<float4*>(m + head);
  float4* v4 = reinterpret_cast<float4*>(v + head);
  for (long long i = first; i < quads; i += stride) {
    float4 pp = p4[i];
    const float4 gg = g4[i];
    float4 mm = m4[i];
    float4 vv = v4[i];
    update<SCALED>(pp.x, gg.x, mm.x, vv.x, s, h);
    update<SCALED>(pp.y, gg.y, mm.y, vv.y, s, h);
    update<SCALED>(pp.z, gg.z, mm.z, vv.z, s, h);
    update<SCALED>(pp.w, gg.w, mm.w, vv.w, s, h);
    p4[i] = pp;
    m4[i] = mm;
    v4[i] = vv;
  }

  const long long body_end = head + 4 * quads;
  const long long rest = head + (n - body_end);
  for (long long i = first; i < rest; i += stride) {
    const long long j = i < head ? i : body_end + (i - head);
    float pj = p[j], mj = m[j], vj = v[j];
    update<SCALED>(pj, g[j], mj, vj, s, h);
    p[j] = pj;
    m[j] = mj;
    v[j] = vj;
  }
}

}  // namespace

// One AdamW step of the n float32 elements of p, g, m, v (dense), in place
// in p, m and v.  lr, bc1, bc2 and scale point to one float32 each in device
// memory; scale may be null (no clip).  omb1 and omb2 are 1 - b1 and 1 - b2
// as the caller rounds them.  Returns cudaGetLastError() after the launch.
extern "C" int repro_adamw(void* p, const void* g, void* m, void* v, const void* lr,
                           const void* bc1, const void* bc2, const void* scale, long long n,
                           float b1, float b2, float omb1, float omb2, float eps, float wd,
                           int sms, void* stream) {
  if (n < 0 || sms <= 0 || !p || !g || !m || !v || !lr || !bc1 || !bc2)
    return (int)cudaErrorInvalidValue;
  const uintptr_t pa = (uintptr_t)p, ga = (uintptr_t)g, ma = (uintptr_t)m, va = (uintptr_t)v;
  if ((pa | ga | ma | va) & 3) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const uintptr_t off = pa & 15;
  long long head = n, quads = 0;
  if ((ga & 15) == off && (ma & 15) == off && (va & 15) == off) {
    head = (long long)(((16 - off) & 15) / 4);
    if (head > n) head = n;
    quads = (n - head) / 4;
  }
  const long long rest = n - 4 * quads;
  const long long work = quads > rest ? quads : rest;
  long long blocks = (work + THREADS - 1) / THREADS;
  const long long most = (long long)sms * BLOCKS_PER_SM;
  if (blocks > most) blocks = most;
  const Hyper h{b1, b2, omb1, omb2, eps, wd};
  cudaStream_t s = (cudaStream_t)stream;
  float* pf = (float*)p;
  float* mf = (float*)m;
  float* vf = (float*)v;
  const float* gf = (const float*)g;
  const float *lrf = (const float*)lr, *b1f = (const float*)bc1, *b2f = (const float*)bc2;
  if (scale)
    adamw_kernel<true><<<(unsigned)blocks, THREADS, 0, s>>>(pf, gf, mf, vf, lrf, b1f, b2f,
                                                             (const float*)scale, n, head,
                                                             quads, h);
  else
    adamw_kernel<false><<<(unsigned)blocks, THREADS, 0, s>>>(pf, gf, mf, vf, lrf, b1f, b2f,
                                                              nullptr, n, head, quads, h);
  return (int)cudaGetLastError();
}
