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

// Attention heads are 64 wide in every tower; a head's rows are staged in
// shared memory as bf16 tiles [rows][kLd], padded to 72 elements (144 bytes)
// so that the eight 16-byte rows an ldmatrix phase reads fall in distinct
// banks.
constexpr int kHeadDim = 64;
constexpr int kLd = kHeadDim + 8;

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

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

// The same for 4 bytes (an fp32 value at a 4-byte aligned address).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(addr), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}

// Issue the copies of rows 0 .. rows - 1 of one head's 64 columns (`src` at
// row 0, rows `row_stride` elements apart) into `tile` [rows][kLd]; rows >=
// seq are zero-filled and read nothing. The block's threads split the
// 16-byte chunks (thread i takes chunks i, i + blockDim.x, ...).
__device__ __forceinline__ void stage_async(const __nv_bfloat16* __restrict__ src,
                                            long long row_stride, int rows, int seq,
                                            __nv_bfloat16* tile) {
  for (int idx = threadIdx.x; idx < rows * 8; idx += blockDim.x) {
    const int r = idx >> 3;
    const int c = (idx & 7) * 8;
    const bool live = r < seq;
    cp_async16(tile + r * kLd + c, src + (live ? r : 0) * row_stride + c, live ? 16 : 0);
  }
}

// A fragments of the 16 x 16 block at (row0, col0) of a row-major tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int ld,
                                       int row0, int col0) {
  const int l = lane_id();
  ldmatrix_x4(a, tile + (row0 + (l & 15)) * ld + col0 + (l >> 4) * 8);
}

// A fragments of the 16 x 16 block at (m0, k0) of A = T^T, for a tile T
// stored [k][m] (rows are A's columns).
__device__ __forceinline__ void load_a_t(uint32_t (&a)[4], const __nv_bfloat16* tile, int ld,
                                         int m0, int k0) {
  const int l = lane_id();
  ldmatrix_x4_trans(a, tile + (k0 + (l & 7) + ((l >> 4) & 1) * 8) * ld + m0 + ((l >> 3) & 1) * 8);
}

// B fragments (k16 at k0) of the two n8 tiles n0 and n0 + 8, for B stored
// [n][k] (a tile whose rows are B's columns, e.g. keys for q k^T):
// b[0], b[1] for tile n0; b[2], b[3] for tile n0 + 8.
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const __nv_bfloat16* tile, int ld,
                                          int n0, int k0) {
  const int l = lane_id();
  ldmatrix_x4(b, tile + (n0 + (l & 7) + ((l >> 4) << 3)) * ld + k0 + ((l >> 3) & 1) * 8);
}

// The same for B stored [k][n] (a row-major tile, e.g. values for p v).
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const __nv_bfloat16* tile, int ld,
                                          int k0, int n0) {
  const int l = lane_id();
  ldmatrix_x4_trans(b, tile + (k0 + (l & 7) + ((l >> 3) & 1) * 8) * ld + n0 + (l >> 4) * 8);
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

// Store a warp's 16 x 64 fp32 result times `mul` as bf16 into rows
// row0 .. row0 + 15 (those < seq) of a [rows][row_stride] matrix, `dst` at
// row 0 of the head's 64 columns.
__device__ __forceinline__ void store_rows(const float (&acc)[8][4], float mul,
                                           __nv_bfloat16* dst, long long row_stride, int row0,
                                           int seq) {
  const int l = lane_id();
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + (l >> 2) + 8 * half;
    if (r >= seq) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      *reinterpret_cast<__nv_bfloat162*>(dst + r * row_stride + nt * 8 + 2 * (l & 3)) =
          __floats2bfloat162_rn(acc[nt][2 * half] * mul, acc[nt][2 * half + 1] * mul);
    }
  }
}

// Raise a kernel's dynamic shared-memory cap once per device (`done` is the
// caller's per-kernel record of the devices already set).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, unsigned long long& done) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) done |= bit;
  return err;
}

// The current device's SM count, asked once per device.
inline cudaError_t sm_count(int& sms) {
  static int known[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int& slot = known[dev & 63];
  if (slot == 0) {
    err = cudaDeviceGetAttribute(&slot, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  sms = slot;
  return cudaSuccess;
}

}  // namespace ilvlm
