// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel library entry point has a plain C signature (pointers and the
// stream as void*, sizes as int) so that Python binds it with ctypes, and
// returns cudaGetLastError() right after its launch: a launch that CUDA
// refuses (too many threads, too much shared memory) never runs, and only
// this check reports it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define ILVLM_API extern "C" __attribute__((visibility("default")))

namespace ilvlm {

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
