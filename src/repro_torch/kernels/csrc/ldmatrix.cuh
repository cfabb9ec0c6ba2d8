// The bf16 fragment loads and the base-2 exponential that csrc/flash_attention.cu
// (online_kernel) and csrc/flash_attention_bwd.cu share (sm_80 and later;
// built here for sm_90a).  ldmatrix reads the A and B operands of
// mma.m16n8k16 (mma.cuh's layouts) from shared memory, one row address a
// lane; `.trans` transposes each 8x8 tile on the way, so a tile stored
// [inner][column] serves as the B operand without a copy.  Rows whose
// stride is an odd multiple of 16 bytes (8 bf16) are read free of bank
// conflicts.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ldmatrix: four 8x8 tiles of 16-bit elements, row addresses from lanes
// 8i..8i+7 for tile i (`trans`: each tile transposed on the way)
// (a shared-memory address: a lane's base plus a constant offset, so that
// the unrolled loops keep no address of their own in registers)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 2^x: one MUFU.EX2 (relative error ~2^-22; ex2(0) = 1 and ex2(-1e30) = 0
// exactly, which the masks rely on)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace
