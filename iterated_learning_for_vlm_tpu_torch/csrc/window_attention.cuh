// Helpers shared by the K4 kernels (window_attention_fwd.cu, window_attention_bwd.cu).
//
// A block owns one head of one window (forward) or one head of a strided
// set of windows (backward). A window's N <= 144 tokens are padded to
// S16 = 16 kT rows (kT = 1 .. 9), and the block has kT warps of 16 rows. The
// head's 32 columns of q, k, v (and the output gradient) are staged in
// shared memory as bf16 tiles [S16][kLdW], rows padded to 40 elements (80
// bytes: the eight rows an ldmatrix phase reads land on distinct 16-byte
// bank groups); rows past N are zeros. Every product runs on the tensor
// cores (mma.sync m16n8k16, bf16 operands, fp32 sums) from ldmatrix
// fragments (common.cuh); the softmax is K2's (tiny_attention.cuh), with the
// window's fp32 [N, N] bias.
#pragma once

#include "tiny_attention.cuh"

namespace ilvlm {
namespace win {

constexpr int kDim = 32;        // every Swin-B stage's head width
constexpr int kLdW = kDim + 8;  // bf16 row stride of the staged tiles
constexpr int kMaxN = 144;      // 12 x 12 windows

// Start the copies of rows 0 .. rows - 1 of one head's 32 columns (`src` at
// row 0, rows `row_stride` elements apart) into `tile` [rows][kLdW]; rows >= n
// are zero-filled and read nothing. Four 16-byte chunks a row.
__device__ __forceinline__ void stage32(const __nv_bfloat16* __restrict__ src,
                                        long long row_stride, int rows, int n,
                                        __nv_bfloat16* tile) {
  for (int idx = threadIdx.x; idx < rows * 4; idx += blockDim.x) {
    const int r = idx >> 2;
    const int c = (idx & 3) * 8;
    const bool live = r < n;
    cp_async16(tile + r * kLdW + c, src + (live ? r : 0) * row_stride + c, live ? 16 : 0);
  }
}

// s[nt] = A (16 x 32, fragments a[2] over k) times the transpose of rows
// 8 nt .. 8 nt + 7 of a [.][kLdW] tile, for the tiles nt < nt_end (in
// pairs); the others are left at 0.
template <int kNt>
__device__ __forceinline__ void product32(const uint32_t (&a)[2][4], const __nv_bfloat16* tile,
                                          int nt_end, float (&s)[kNt][4]) {
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int np = 0; np < kNt / 2; ++np) {
    if (2 * np >= nt_end) continue;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t b[4];
      load_b_nk(b, tile, kLdW, np * 16, kk * 16);
      mma_bf16_16816(s[2 * np], a[kk], b[0], b[1]);
      mma_bf16_16816(s[2 * np + 1], a[kk], b[2], b[3]);
    }
  }
}

// acc (16 rows x 32 columns, 4 n8 tiles) += A (16 x 16, fragments a) times
// rows k0 .. k0 + 15 of a [.][kLdW] tile.
__device__ __forceinline__ void accumulate32(float (&acc)[4][4], const uint32_t (&a)[4],
                                             const __nv_bfloat16* tile, int k0) {
#pragma unroll
  for (int np = 0; np < 2; ++np) {
    uint32_t b[4];
    load_b_kn(b, tile, kLdW, k0, np * 16);
    mma_bf16_16816(acc[2 * np], a, b[0], b[1]);
    mma_bf16_16816(acc[2 * np + 1], a, b[2], b[3]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
}

// Store a warp's 16 x 32 fp32 result times `mul` as bf16 into rows
// row0 .. row0 + 15 (those < n) of a [rows][row_stride] matrix, `dst` at row
// 0 of the head's 32 columns.
__device__ __forceinline__ void store32(const float (&acc)[4][4], float mul, __nv_bfloat16* dst,
                                        long long row_stride, int row0, int n) {
  const int l = lane_id();
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + (l >> 2) + 8 * half;
    if (r >= n) continue;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      *reinterpret_cast<__nv_bfloat162*>(dst + r * row_stride + nt * 8 + 2 * (l & 3)) =
          __floats2bfloat162_rn(acc[nt][2 * half] * mul, acc[nt][2 * half + 1] * mul);
    }
  }
}

}  // namespace win
}  // namespace ilvlm
