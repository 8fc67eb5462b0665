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
//
// The cosine form (Swin V2) computes the logits as a per-head scale times the
// cosines of the q and k rows: the raw bf16 product q k^T in fp32, times the
// rows' fp32 inverse norms 1 / (|q| + 1e-12) and 1 / (|k| + 1e-12), which
// the block takes once from the staged tiles (inverse_norms). Its backward
// maps the gradients of the unit rows back through the normalisation
// (project32).
#pragma once

#include <type_traits>

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

// rn[r] = 1 / (|row r| + 1e-12) of the rows 0 .. rows - 1 of the q tile and,
// at rn[rows + r], of the k tile: fp32 sums of the squares of the bf16
// values. One row a thread.
__device__ __forceinline__ void inverse_norms(const __nv_bfloat16* qs, const __nv_bfloat16* ks,
                                              int rows, float* rn) {
  for (int idx = threadIdx.x; idx < 2 * rows; idx += blockDim.x) {
    const __nv_bfloat16* row = idx < rows ? qs + idx * kLdW : ks + (idx - rows) * kLdW;
    float ss = 0.f;
#pragma unroll
    for (int c = 0; c < kDim; c += 2) {
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + c));
      ss = fmaf(v.x, v.x, ss);
      ss = fmaf(v.y, v.y, ss);
    }
    rn[idx] = 1.f / (sqrtf(ss) + 1e-12f);
  }
}

// The raw products of a warp's 16 query rows from row0 (C fragments s) to
// cosines: s[nt][e] *= rq[row] * rk[col], rq and rk the inverse norms of the
// q and k rows.
template <int kNt>
__device__ __forceinline__ void cosines(float (&s)[kNt][4], const float* rq, const float* rk,
                                        int row0, int nt_end) {
  const int l = lane_id();
  const float fq[2] = {rq[row0 + (l >> 2)], rq[row0 + (l >> 2) + 8]};
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) {
    if (nt >= nt_end) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] *= fq[e >> 1] * rk[nt * 8 + 2 * (l & 3) + (e & 1)];
  }
}

// A warp's 16 x 32 fp32 result acc_i = sum_j g_ij u_j for rows row0 ..
// row0 + 15 (u the other operand's unit rows) is the gradient of the unit
// rows y_i / |y_i| of `tile`; take it back through the normalisation:
// acc_i <- rn_i (acc_i - yhat_i (yhat_i . acc_i)), yhat_i = y_i rn_i (the
// 1e-12 left out of the Jacobian). Returns this thread's share of the sum of
// yhat_i . acc_i over the rows: each row's dot product once, on the quad's
// lane 0.
__device__ __forceinline__ float project32(float (&acc)[4][4], const __nv_bfloat16* tile,
                                           const float* rn, int row0) {
  const int l = lane_id();
  float share = 0.f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + (l >> 2) + 8 * half;
    const float f = rn[r];
    float2 y[4];
    float dot = 0.f;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(tile + r * kLdW + nt * 8 + 2 * (l & 3)));
      y[nt] = make_float2(v.x * f, v.y * f);
      dot = fmaf(y[nt].x, acc[nt][2 * half], dot);
      dot = fmaf(y[nt].y, acc[nt][2 * half + 1], dot);
    }
    dot = quad_sum(dot);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      acc[nt][2 * half] = f * (acc[nt][2 * half] - y[nt].x * dot);
      acc[nt][2 * half + 1] = f * (acc[nt][2 * half + 1] - y[nt].y * dot);
    }
    if ((l & 3) == 0) share += dot;
  }
  return share;
}

// f(std::integral_constant<int, kT>) for the kT = ceil(n / 16) of a window of
// n <= 144 tokens.
template <typename F>
auto by_tiles(int n, F&& f) {
  switch ((n + 15) / 16) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    case 8: return f(std::integral_constant<int, 8>{});
    default: return f(std::integral_constant<int, 9>{});
  }
}

}  // namespace win
}  // namespace ilvlm
