// K3-fwd: flash attention forward, any sequence length up to kMaxSeq.
//
// Replaces the TPU kernel iterated_learning_for_vlm_tpu/ops/flash_attention.py
// `_attn_fwd_kernel` (launched by `_fwd_impl.inner`). Same function, per
// (sample, head): logits = q k^T * 64^-1/2 in fp32, plus an optional shared
// [S, S] fp32 bias, optionally the causal mask (a flag: keys above the
// diagonal masked by index, no bias read), an fp32 softmax, the value
// product p v in fp32 (v upcast, p not rounded), one cast to bf16. With a
// non-null `lse` it also writes each row's fp32 log-sum-exp of the logits
// [B, H, S], which the backward reads in place of recomputing the softmax's
// statistics; serving calls pass null and write only the output. The kernel
// reads the [B, S, H, 64] views of the packed in_proj output in place (batch
// and token strides given) and writes [B, S, H*64], the layout out_proj
// takes.
//
// What bounds it on an H100: per (sample, head) it is 4 S^2 64 flops over
// 4 S 64 bf16 values of device memory, so it is bound by bytes (at B = 256,
// H = 12, S = 197: 0.0925 ms at 3.35 TB/s); the unfused path's cost is the
// [B, H, S, S] fp32 logits and probabilities it writes and rereads. The
// design keeps the work off the critical path of the loads and the tensor
// cores busy:
// - a warp owns 16 query rows; a block has block_warps(S) warps (every row
//   tile in one block up to S = 128, e.g. 2 warps at S = 32 and 5 at S = 77;
//   at S = 197 two blocks of 7, so no block idles most of its warps);
// - the block stages its q rows once and walks the keys in chunks of 64
//   (k and v row-major, and the bias tile [rows][64] fp32 when there is one)
//   through a two-stage cp.async ring: chunk j + 1 lands while chunk j
//   computes, one barrier a chunk; the last chunk is trimmed to
//   roundup(S - k0, 16) keys;
// - q k^T takes q's A fragments (ldmatrix, loaded once) and B from the
//   row-major key tile (ldmatrix); p v takes B from the row-major value tile
//   by ldmatrix.trans: no transposed copy;
// - the online softmax runs in base 2 (scale and bias times log2 e, exp2f),
//   the row sum stays per thread until the end, and the output is scaled by
//   one reciprocal per row;
// - p enters p v as two bf16 terms (p to ~2^-17 relative), 2x the tensor work
//   of a bf16 p;
// - causal: chunks past the block's last row are never staged, and each warp
//   stops at the 16-key tile of its own last row.
#include "flash_attention.cuh"

namespace {

using namespace ilvlm;
using namespace ilvlm::flash;

// The query tile [16 warps][kLd], two ring stages of key and value chunks
// [64][kLd], and with a bias two stages of bias tiles [16 warps][64 + pad].
size_t fwd_smem_bytes(int warps, bool with_bias) {
  const size_t rows = 16 * warps;
  return (rows + 4 * kChunk) * kLd * sizeof(__nv_bfloat16) +
         (with_bias ? 2 * rows * (kChunk + kBiasPad) * sizeof(float) : 0);
}

__global__ void __launch_bounds__(kMaxWarps * 32)
flash_attention_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                           float* __restrict__ lse, int seq, int heads, long long batch_stride,
                           long long token_stride, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = blockDim.x >> 1;  // 16 query rows a warp
  const int bias_ld = kChunk + kBiasPad;
  __nv_bfloat16* const qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* const ring = qs + rows * kLd;  // stage i: keys, then values
  float* const bias_ring = reinterpret_cast<float*>(ring + 4 * kChunk * kLd);

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int g = lane_id() >> 2;
  const int t = lane_id() & 3;
  const int r0 = blockIdx.x * rows;  // the block's first query row
  const int wrow = 16 * warp;        // the warp's first row in the block
  const int row0 = r0 + wrow;
  const long long head = b * batch_stride + h * kHeadDim;
  const int kend = causal ? min(seq, r0 + rows) : seq;  // keys the block needs
  const int nchunks = (kend + kChunk - 1) / kChunk;
  const float scale2 = scale * kLog2e;

  auto issue = [&](int j) {
    const int k0 = j * kChunk;
    const int n = 16 * chunk_tiles(k0, kend);
    __nv_bfloat16* const st = ring + (j & 1) * 2 * kChunk * kLd;
    stage_async(k + head + k0 * token_stride, token_stride, n, seq - k0, st);
    stage_async(v + head + k0 * token_stride, token_stride, n, seq - k0, st + kChunk * kLd);
    if (bias != nullptr) {
      stage_bias(bias, seq, r0, k0, rows, kChunk, bias_ring + (j & 1) * rows * bias_ld);
    }
  };
  stage_async(q + head + r0 * token_stride, token_stride, rows, seq - r0, qs);
  issue(0);
  cp_async_commit();

  const bool live = row0 < seq;
  const int wend = causal ? min(seq, row0 + 16) : seq;  // keys this warp needs
  uint32_t qa[4][4];
  float o[8][4];
  zero(o);
  float m[2] = {-INFINITY, -INFINITY};  // running row max (base 2)
  float l[2] = {0.f, 0.f};              // this thread's part of the row sum
  for (int j = 0; j < nchunks; ++j) {
    cp_async_wait<0>();
    __syncthreads();  // chunk j has landed; every warp is done with chunk j - 1
    if (j + 1 < nchunks) {
      issue(j + 1);
      cp_async_commit();
    }
    if (!live) continue;  // a warp past the end only helps stage
    if (j == 0) load_rows(qa, qs, wrow);
    const int k0 = j * kChunk;
    const int nkt = chunk_tiles(k0, wend);
    if (nkt == 0) continue;
    const __nv_bfloat16* const ks = ring + (j & 1) * 2 * kChunk * kLd;
    const __nv_bfloat16* const vs = ks + kChunk * kLd;
    const float* const bs = bias_ring + (j & 1) * rows * bias_ld + wrow * bias_ld;

    float s[4][2][4];
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      if (kt < nkt) product16(qa, ks, kt * 16, s[kt]);
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      if (kt >= nkt) continue;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int c = kt * 16 + n * 8 + 2 * t + (e & 1);  // key in the chunk
          const bool keep = k0 + c < seq && (!causal || k0 + c <= row0 + g + 8 * i);
          float x = -INFINITY;
          if (keep) {
            x = s[kt][n][e] * scale2;
            if (bias != nullptr) x = fmaf(bs[(g + 8 * i) * bias_ld + c], kLog2e, x);
          }
          s[kt][n][e] = x;
          mx[i] = fmaxf(mx[i], x);
        }
      }
    }
    float mu[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      mu[i] = mx[i] == -INFINITY ? 0.f : mx[i];  // a row with nothing kept yet stays at 0
      alpha[i] = exp2f(m[i] - mu[i]);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      if (kt >= nkt) continue;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[kt][n][e] - mu[e >> 1]);
          s[kt][n][e] = p;
          l[e >> 1] += p;
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][e] *= alpha[e >> 1];
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      if (kt >= nkt) continue;
      uint32_t hi[4], lo[4];
      a_from_c(s[kt], hi, lo);
      accumulate2(o, hi, lo, vs, kt * 16);
    }
  }
  if (!live) return;

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = quad_sum(l[i]);
    inv[i] = l[i] > 0.f ? 1.f / l[i] : 0.f;
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] *= inv[e >> 1];
  store_rows(o, 1.f, out + (static_cast<long long>(b) * seq * heads + h) * kHeadDim,
             static_cast<long long>(heads) * kHeadDim, row0, seq);
  if (lse != nullptr && t == 0) {
    const long long base = (static_cast<long long>(b) * heads + h) * seq;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + g + 8 * i;
      // a row with every logit at -inf gets +inf: its p is 0 in the backward
      if (r < seq) lse[base + r] = l[i] > 0.f ? (m[i] + log2f(l[i])) * kLn2 : INFINITY;
    }
  }
}

}  // namespace

// q, k, v: [batch, seq, heads, 64] bf16 views sharing `batch_stride` and
// `token_stride` (elements; heads at a stride of 64, 16-byte aligned rows);
// bias: [seq, seq] fp32 contiguous or null; causal != 0 masks keys above the
// diagonal; out: [batch, seq, heads, 64] bf16 contiguous; lse: [batch, heads,
// seq] fp32 contiguous or null. Launches on `stream`, does not synchronise.
ILVLM_API int flash_attention_fwd(const void* q, const void* k, const void* v, const void* bias,
                                  void* out, void* lse, int batch, int seq, int heads,
                                  long long batch_stride, long long token_stride, int causal,
                                  float scale, void* stream) {
  if (batch < 1 || batch > 65535 || heads < 1 || heads > 65535 || seq < 1 || seq > kMaxSeq) {
    return cudaErrorInvalidValue;
  }
  static unsigned long long configured = 0;
  cudaError_t err = allow_smem(flash_attention_fwd_kernel, fwd_smem_bytes(kMaxWarps, true),
                               configured);
  if (err != cudaSuccess) return err;
  const int warps = block_warps(seq);
  const dim3 grid((seq + 16 * warps - 1) / (16 * warps), heads, batch);
  flash_attention_fwd_kernel<<<grid, warps * 32, fwd_smem_bytes(warps, bias != nullptr),
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), seq, heads, batch_stride,
      token_stride, causal, scale);
  return cudaGetLastError();
}
