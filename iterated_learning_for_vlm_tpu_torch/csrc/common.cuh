// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel library entry point has a plain C signature (pointers and the
// stream as void*, sizes as int) so that Python binds it with ctypes, and
// returns cudaGetLastError() right after its launch: a launch that CUDA
// refuses (too many threads, too much shared memory) never runs, and only
// this check reports it.
#pragma once

#include <stdint.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define ILVLM_API extern "C" __attribute__((visibility("default")))

namespace ilvlm {

// One warp-wide bf16 tensor-core product c += a * b (m16n8k16, fp32
// accumulators). Fragment layouts, with g = lane / 4 and t = lane % 4, each
// register holding two bf16 (the lower column in the low half):
//   a[0]: row g, cols 2t, 2t+1     a[1]: row g + 8, same cols
//   a[2]: row g, cols 2t+8, 2t+9   a[3]: row g + 8, same cols
//   b0: k rows 2t, 2t+1 of col g   b1: k rows 2t+8, 2t+9 of col g
//   c[0], c[1]: row g, cols 2t, 2t+1;  c[2], c[3]: row g + 8, same cols
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ldmatrix: four 8x8 b16 matrices from shared memory, lanes 8i .. 8i + 7
// giving the 16-byte row addresses of matrix i; register i of lane l then
// holds row l / 4, elements 2 (l % 4) and 2 (l % 4) + 1 of matrix i (of its
// transpose with .trans). These are the mma fragments above.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// An asynchronous 16-byte copy from global to shared memory; `src_bytes` of
// 0 writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}

// Close the group of the cp.async copies this thread issued since the last
// commit; wait until at most `kPending` of its groups are still in flight.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Two fp32 values rounded to bf16 and packed as an mma operand register
// (the first in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Reductions over the four lanes of a quad (the lanes holding one row of an
// mma C fragment).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

}  // namespace ilvlm
