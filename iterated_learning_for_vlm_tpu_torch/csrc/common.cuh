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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace ilvlm
