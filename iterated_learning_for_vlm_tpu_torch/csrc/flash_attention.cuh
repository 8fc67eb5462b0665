// Helpers shared by the K3 flash-attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu).
//
// Layout: q, k, v and the output gradient are [B, S, H, 64] bf16 views with
// an explicit batch and token stride (in elements) and heads packed at a
// stride of 64, so the three column blocks of the packed in_proj output
// [B, S, 3D] are read in place. A block owns 16 rows a warp of one (sample,
// head) and walks the other axis in chunks of 64 rows, staged row-major as
// bf16 [64][kLd] tiles by cp.async in a two-stage ring (common.cuh): chunk
// j + 1's copies are in flight while chunk j computes, and one barrier a
// chunk separates them. Rows past S stage as zeros. Operand fragments come
// from the row-major tiles by ldmatrix (.trans where the tile is [k][n]), so
// no transposed copy is built.
//
// Numerics: logits in fp32 (bf16 products summed in fp32), taken in base 2
// (scale and bias times log2 e) so that exp2f applies; p and ds enter the
// tensor cores as two bf16 terms whose sum is their fp32 value to ~2^-17
// relative, so every product with them is an fp32 product of the bf16
// operands, as in the TPU kernel (which keeps p and ds in fp32).
#pragma once

#include "common.cuh"

namespace ilvlm {
namespace flash {

constexpr int kChunk = 64;     // rows of one ring stage
constexpr int kMaxWarps = 8;   // warps (16 rows each) a block owns at most
constexpr int kMaxSeq = 1024;  // the wrappers' bound (the kernels walk in chunks)
constexpr int kBiasPad = 4;    // fp32 padding of a staged bias row
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Warps per block for a sequence of S rows (16 rows a warp): every row
// tile in one block up to 8 tiles (S <= 128: S = 32 gets 2 warps, S = 77
// gets 5), else the fewest blocks of at most 8 warps, evened out (S = 197:
// two blocks of 7 warps, 13 of the 14 live, where 4-warp blocks leave the
// last block 1 of 4).
__host__ __device__ constexpr int block_warps(int seq) {
  const int tiles = (seq + 15) / 16;
  const int blocks = (tiles + kMaxWarps - 1) / kMaxWarps;
  return (tiles + blocks - 1) / blocks;
}

// 16-row tiles of the n rows from row0 that a chunk holds, never past S:
// roundup(min(64, S - row0), 16) / 16 (0 when row0 >= S).
__device__ __forceinline__ int chunk_tiles(int row0, int seq) {
  return max(0, min(kChunk, seq - row0) + 15) >> 4;
}

// Issue the copies of an fp32 [rows][cols] tile of the [S, S] bias, at
// (row0, col0), into `dst` [rows][cols + kBiasPad]; entries past S are zeros.
// 4-byte copies: a bias row is S * 4 bytes, not 16-byte aligned in general.
__device__ __forceinline__ void stage_bias(const float* __restrict__ bias, int seq, int row0,
                                           int col0, int rows, int cols, float* dst) {
  for (int idx = threadIdx.x; idx < rows * cols; idx += blockDim.x) {
    const int r = idx / cols;
    const int c = idx - r * cols;
    const bool live = row0 + r < seq && col0 + c < seq;
    cp_async4(dst + r * (cols + kBiasPad) + c,
              bias + (live ? static_cast<long long>(row0 + r) * seq + col0 + c : 0),
              live ? 4 : 0);
  }
}

// 2^x on the special-function unit (ex2.approx.ftz: ~2^-22 relative, far
// under the two-term p's 2^-17; 2^-inf = 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two fp32 values as two bf16 pairs: hi = bf16(x), lo = bf16(x - hi).
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// The C fragments of two n8 tiles (16 columns) as the A fragments of one
// k16 step, in two terms.
__device__ __forceinline__ void a_from_c(const float (&c)[2][4], uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  split2(c[0][0], c[0][1], hi[0], lo[0]);
  split2(c[0][2], c[0][3], hi[1], lo[1]);
  split2(c[1][0], c[1][1], hi[2], lo[2]);
  split2(c[1][2], c[1][3], hi[3], lo[3]);
}

// The A fragments of a warp's 16 rows of a staged [rows][kLd] tile, 64 deep.
__device__ __forceinline__ void load_rows(uint32_t (&a)[4][4], const __nv_bfloat16* tile,
                                          int row0) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) load_a(a[kk], tile, kLd, row0, kk * 16);
}

// s (16 x 16, two n8 tiles) = A (16 x 64, fragments a) times the transpose of
// rows n0 .. n0 + 15 of a row-major [.][kLd] tile.
__device__ __forceinline__ void product16(const uint32_t (&a)[4][4], const __nv_bfloat16* tile,
                                          int n0, float (&s)[2][4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) s[0][e] = s[1][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t b[4];
    load_b_nk(b, tile, kLd, n0, kk * 16);
    mma_bf16_16816(s[0], a[kk], b[0], b[1]);
    mma_bf16_16816(s[1], a[kk], b[2], b[3]);
  }
}

// acc (16 x 64) += (hi + lo) (16 x 16) times rows k0 .. k0 + 15 of a
// row-major [.][kLd] tile.
__device__ __forceinline__ void accumulate2(float (&acc)[8][4], const uint32_t (&hi)[4],
                                            const uint32_t (&lo)[4], const __nv_bfloat16* tile,
                                            int k0) {
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    uint32_t b[4];
    load_b_kn(b, tile, kLd, k0, np * 16);
    mma_bf16_16816(acc[2 * np], lo, b[0], b[1]);
    mma_bf16_16816(acc[2 * np + 1], lo, b[2], b[3]);
    mma_bf16_16816(acc[2 * np], hi, b[0], b[1]);
    mma_bf16_16816(acc[2 * np + 1], hi, b[2], b[3]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
}

}  // namespace flash
}  // namespace ilvlm
