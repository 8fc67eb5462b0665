// Helpers shared by the K3 flash-attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu).
//
// Layout: q, k, v and the output gradient are [B, S, H, 64] bf16 views with
// an explicit batch and token stride (in elements) and heads packed at a
// stride of 64, so the three column blocks of the packed in_proj output
// [B, S, 3D] are read in place. A block stages 64 rows of one (sample, head)
// at a time in shared memory as bf16, row-major and/or transposed, rows
// padded to 72 elements (144 bytes): the 32-bit fragment loads of a warp then
// fall in 32 distinct banks. Rows past S stage as zeros.
#pragma once

#include "common.cuh"

namespace ilvlm {
namespace flash {

constexpr int kHeadDim = 64;
constexpr int kWarps = 4;
constexpr int kChunk = kWarps * 16;  // rows a block stages at a time; rows a block owns
constexpr int kLd = kHeadDim + 8;    // padded bf16 row stride in shared memory
constexpr int kMaxSeq = 1024;        // the wrappers' bound (the kernels stage in chunks)

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Rows row0 .. row0 + 63 of one (sample, head), `base` pointing at its row 0,
// into dst [64][kLd] (row-major) and/or dst_t [64 columns][kLd] (transposed).
__device__ __forceinline__ void stage(const __nv_bfloat16* __restrict__ base,
                                      long long token_stride, int row0, int seq,
                                      __nv_bfloat16* dst, __nv_bfloat16* dst_t) {
  for (int idx = threadIdx.x; idx < kChunk * (kHeadDim / 8); idx += blockDim.x) {
    const int r = idx >> 3;
    const int c = (idx & 7) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < seq) {
      v = *reinterpret_cast<const uint4*>(base + (row0 + r) * token_stride + c);
    }
    if (dst != nullptr) *reinterpret_cast<uint4*>(dst + r * kLd + c) = v;
    if (dst_t != nullptr) {
      const __nv_bfloat16* const e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int t = 0; t < 8; ++t) dst_t[(c + t) * kLd + r] = e[t];
    }
  }
}

// A fragments of a warp's 16 rows (row0 + g, row0 + g + 8) over the 64
// columns, straight from global memory; rows past S are zeros.
__device__ __forceinline__ void load_a_rows(const __nv_bfloat16* __restrict__ base,
                                            long long token_stride, int row0, int seq,
                                            uint32_t (&a)[4][4]) {
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int r0 = row0 + g, r1 = row0 + g + 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = kk * 16 + 2 * t;
    a[kk][0] = r0 < seq ? ld32(base + r0 * token_stride + c) : 0u;
    a[kk][1] = r1 < seq ? ld32(base + r1 * token_stride + c) : 0u;
    a[kk][2] = r0 < seq ? ld32(base + r0 * token_stride + c + 8) : 0u;
    a[kk][3] = r1 < seq ? ld32(base + r1 * token_stride + c + 8) : 0u;
  }
}

// s[nt] += A (16 x 64, fragments a) times the transpose of rows
// n0 + 8 nt .. of a row-major staged chunk `rows` (64 columns deep).
template <int NT>
__device__ __forceinline__ void product_rows(const uint32_t (&a)[4][4],
                                             const __nv_bfloat16* rows, int n0,
                                             float (&s)[NT][4]) {
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const __nv_bfloat16* const p = rows + (n0 + nt * 8 + g) * kLd + kk * 16 + 2 * t;
      mma_bf16_16816(s[nt], a[kk], ld32(p), ld32(p + 8));
    }
  }
}

// Two fp32 values as three bf16 pairs whose sums give them back to fp32
// precision (each remainder is exact in fp32 and at most 2^-9 of the last).
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = x0 - hf.x, r1 = x1 - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l = __floats2bfloat162_rn(r0 - mf.x, r1 - mf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// acc[nt] (16 x 64 output, 8 n8 tiles) += P (16 x 16, fp32 C fragments of two
// n8 tiles p0, p1) times rows k0 .. k0 + 15 of the chunk staged transposed in
// `cols` ([64 columns][kLd]). P enters the tensor cores as three bf16 terms,
// so the product is an fp32 product of P with the bf16 operand.
__device__ __forceinline__ void accumulate_fp32_a(float (&acc)[8][4], const float (&p0)[4],
                                                  const float (&p1)[4],
                                                  const __nv_bfloat16* cols, int k0) {
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  uint32_t hi[4], mid[4], lo[4];
  split3(p0[0], p0[1], hi[0], mid[0], lo[0]);
  split3(p0[2], p0[3], hi[1], mid[1], lo[1]);
  split3(p1[0], p1[1], hi[2], mid[2], lo[2]);
  split3(p1[2], p1[3], hi[3], mid[3], lo[3]);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const __nv_bfloat16* const p = cols + (nt * 8 + g) * kLd + k0 + 2 * t;
    const uint32_t b0 = ld32(p), b1 = ld32(p + 8);
    mma_bf16_16816(acc[nt], hi, b0, b1);
    mma_bf16_16816(acc[nt], mid, b0, b1);
    mma_bf16_16816(acc[nt], lo, b0, b1);
  }
}

// An fp32 logit of a C tile: scale, then the bias; -inf past the end of
// either axis. (r, c) index the logits matrix (query row, key column).
__device__ __forceinline__ float logit(float acc, float scale, const float* bias, int r, int c,
                                       int seq) {
  if (r >= seq || c >= seq) return -INFINITY;
  float x = acc * scale;
  if (bias != nullptr) x += bias[static_cast<long long>(r) * seq + c];
  return x;
}

using ilvlm::quad_max;
using ilvlm::quad_sum;

// Store a warp's 16 x 64 fp32 result times `mul` as bf16 rows of a contiguous
// [B, S, H, 64] tensor (`base` at its (sample, row 0, head)).
__device__ __forceinline__ void store_rows(const float (&acc)[8][4], const float (&mul)[2],
                                           __nv_bfloat16* base, long long token_stride,
                                           int row0, int seq) {
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + g + 8 * half;
    if (r >= seq) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      *reinterpret_cast<__nv_bfloat162*>(base + r * token_stride + nt * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[nt][2 * half] * mul[half],
                                acc[nt][2 * half + 1] * mul[half]);
    }
  }
}

}  // namespace flash
}  // namespace ilvlm
