// Helpers shared by the K2 kernels (tiny_attention_fwd.cu, tiny_attention_bwd.cu).
//
// A block owns one (sample, head) of a sequence of S <= 128 tokens. S is
// padded to S16 = 16 kT (kT = 1 .. 8 tiles of 16 rows), and the block has kT
// warps, each owning 16 rows. The head's q, k, v (and the output gradient)
// are staged in shared memory as bf16 tiles [S16][kLd], rows padded to 72
// elements (144 bytes) so that the eight 16-byte rows an ldmatrix phase reads
// fall in distinct banks; rows past S are zeros. Every product runs on the
// tensor cores (mma.sync m16n8k16, bf16 operands, fp32 accumulators), with
// fragments loaded by ldmatrix (see common.cuh for the fragment layouts).
#pragma once

#include "common.cuh"

namespace ilvlm {
namespace tiny {

constexpr int kMaxSeq = 128;

// Add the head's 64 bias values to the staged rows < seq, in bf16 as the
// unfused path adds the in_proj bias. Each thread touches the chunks it
// copied itself (the loop of stage_async), once its copies have landed.
template <int kS16>
__device__ __forceinline__ void add_bias(__nv_bfloat16* tile,
                                         const __nv_bfloat16* __restrict__ bias, int seq) {
  for (int idx = threadIdx.x; idx < kS16 * 8; idx += blockDim.x) {
    const int r = idx >> 3;
    const int c = (idx & 7) * 8;
    if (r >= seq) continue;
    uint4* const p = reinterpret_cast<uint4*>(tile + r * kLd + c);
    uint4 v = *p;
    const uint4 bv = *reinterpret_cast<const uint4*>(bias + c);
    __nv_bfloat162* const x = reinterpret_cast<__nv_bfloat162*>(&v);
    const __nv_bfloat162* const y = reinterpret_cast<const __nv_bfloat162*>(&bv);
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = __hadd2(x[i], y[i]);
    *p = v;
  }
}

// acc[nt] (16 rows x 64 columns, 8 n8 tiles) += A (16 x 16, fragments a)
// times rows k0 .. k0 + 15 of a row-major [.][64] tile.
__device__ __forceinline__ void accumulate_rows(float (&acc)[8][4], const uint32_t (&a)[4],
                                                const __nv_bfloat16* tile, int k0) {
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    uint32_t b[4];
    load_b_kn(b, tile, kLd, k0, np * 16);
    mma_bf16_16816(acc[2 * np], a, b[0], b[1]);
    mma_bf16_16816(acc[2 * np + 1], a, b[2], b[3]);
  }
}

// s[nt] = A (16 x 64, fragments a[4] over k) times the transpose of rows
// 8 nt .. 8 nt + 7 of a row-major [.][64] tile, for the tiles nt < nt_end
// (in pairs); the others are left at 0.
template <int kNt>
__device__ __forceinline__ void product_rows(const uint32_t (&a)[4][4], const __nv_bfloat16* tile,
                                             int nt_end, float (&s)[kNt][4]) {
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int np = 0; np < kNt / 2; ++np) {
    if (2 * np >= nt_end) continue;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t b[4];
      load_b_nk(b, tile, kLd, np * 16, kk * 16);
      mma_bf16_16816(s[2 * np], a[kk], b[0], b[1]);
      mma_bf16_16816(s[2 * np + 1], a[kk], b[2], b[3]);
    }
  }
}

// The softmax of a warp's 16 rows in place: s holds q k^T (C fragments);
// afterwards it holds p in fp32, normalised before any rounding, and exactly
// 0 where masked (keys >= seq, keys above the diagonal when causal, the whole
// of a row >= seq, and the key tiles >= nt_end, which are masked for every
// row of the warp). The logits are taken in base 2 (scaled by log2 e) so that
// exp2f applies directly; p = 2^(x - max) times the row's 1 / sum. With
// kBias, the fp32 [seq, seq] additive bias enters the scaled logits (times
// log2 e, as K3's does) before the causal mask, read from L2 for the live
// entries only; a row whose keys the bias masks all (-inf) gets p = 0.
template <int kNt, bool kBias>
__device__ __forceinline__ void softmax_rows(float (&s)[kNt][4], int row0, int seq, bool causal,
                                             float scale, int nt_end,
                                             const float* __restrict__ bias) {
  constexpr float kLog2e = 1.4426950408889634f;
  const float scale2 = scale * kLog2e;
  const int l = lane_id();
  const int rows[2] = {row0 + (l >> 2), row0 + (l >> 2) + 8};
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) {
    if (nt >= nt_end) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = rows[e >> 1];
      const int c = nt * 8 + 2 * (l & 3) + (e & 1);
      const bool live = r < seq && c < seq && (!causal || c <= r);
      float x = -INFINITY;
      if (live) {
        x = s[nt][e] * scale2;
        if constexpr (kBias) x = fmaf(__ldg(bias + r * seq + c), kLog2e, x);
      }
      s[nt][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) mx[i] = quad_max(mx[i]);
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) {
    if (nt >= nt_end) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = s[nt][e];
      const float ex = x == -INFINITY ? 0.f : exp2f(x - mx[e >> 1]);
      s[nt][e] = ex;
      sum[e >> 1] += ex;
    }
  }
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sum[i] = quad_sum(sum[i]);
    inv[i] = sum[i] > 0.f ? 1.f / sum[i] : 0.f;  // a row >= seq has sum 0 and p 0
  }
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = nt < nt_end ? s[nt][e] * inv[e >> 1] : 0.f;
}

// The key tiles (8 keys each) a warp's 16 query rows from row0 need: none
// past the sequence, none above the diagonal when causal.
__device__ __forceinline__ int key_tiles(int row0, int seq, bool causal, int nt_max) {
  return min((seq + 7) >> 3, causal ? (row0 >> 3) + 2 : nt_max);
}

}  // namespace tiny
}  // namespace ilvlm
