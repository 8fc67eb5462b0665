// K2-fwd: multi-head self-attention for tiny sequences, read from packed QKV.
//
// Replaces the TPU kernel iterated_learning_for_vlm_tpu/ops/fused_attention.py
// `_fwd_kernel` (l.135, launched by `_fwd_local`). Same function: for each
// sample and head, softmax(q k^T * hd^-1/2 [+ bias] [+ causal mask]) v, read
// straight from the [B, S, 3D] packed projection (q | k | v column blocks, torch
// in_proj order) with the in_proj bias optionally absorbed (added in bf16),
// written as [B, S, D] at the head's column offset. The bias is the JAX entry
// point's constant [S, S] additive logits bias (fp32, no gradient); the
// causal mask comes as a flag. Numerics follow the unfused path: fp32 logits
// and softmax, p normalised in fp32 and then rounded to bf16, p v summed in
// fp32, one cast to bf16.
//
// What bounds it on an H100: a (sample, head) is 4 S^2 64 flops over 4 S 64
// bf16 values of device memory, so it is bound by bytes (at B = 256, S = 50,
// H = 12: 78.6 MB, 23.5 us at 3.35 TB/s, against 0.49 GFLOP, 0.5 us at
// 989 TFLOP/s). The design keeps the work off the critical path of the loads:
// - one block per (sample, head), S padded to S16 = 16 kT, kT warps of 16
//   query rows each, so the whole head is one tile set and no loop runs over
//   keys;
// - q, k and v land in shared memory by 16-byte cp.async copies (zero-filled
//   past S) as bf16 tiles with a 72-element row stride, 9 KB each at S16 = 64,
//   so 8 blocks fit an SM and their loads overlap each other's math; v is a
//   second copy group that lands while q k^T and the softmax run; the bias is
//   added once a group lands;
// - q k^T and p v run on the tensor cores (mma.sync m16n8k16 from ldmatrix
//   fragments); a row of logits (<= 128 keys) stays in registers as C
//   fragments, its max and sum are quad shuffles, the exponentials are
//   exp2f of base-2 logits and the division one reciprocal per row (the
//   softmax's instructions rivalled the loads), and p goes from the C layout
//   straight into the A fragments of p v;
// - with the causal mask, the key tiles above a warp's diagonal are skipped
//   in both products, and so are tiles wholly past S;
// - an [S, S] bias (at most 64 KB at S = 128, the same for every sample and
//   head) is read from L2 into the softmax's registers, entry by entry where
//   the logit is live; it is a template flag, so the path without one is
//   unchanged.
#include "tiny_attention.cuh"

namespace {

using namespace ilvlm;
using namespace ilvlm::tiny;

template <int kT>
constexpr size_t fwd_smem_bytes() {
  return size_t(3) * 16 * kT * kLd * sizeof(__nv_bfloat16);
}

template <int kT, bool kBias>
__global__ void __launch_bounds__(kT * 32)
tiny_attention_fwd_kernel(const __nv_bfloat16* __restrict__ qkv,
                          const __nv_bfloat16* __restrict__ bias3,
                          const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                          int seq, int heads, int causal, float scale) {
  constexpr int kS16 = 16 * kT;
  constexpr int kNt = 2 * kT;  // 8-key tiles of a row
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* const qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* const ks = qs + kS16 * kLd;
  __nv_bfloat16* const vs = ks + kS16 * kLd;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int d_model = heads * kHeadDim;
  const long long row_stride = 3LL * d_model;
  // two copy groups: q and k, then v, which lands while q k^T runs
  const __nv_bfloat16* const src = qkv + b * seq * row_stride + h * kHeadDim;
  stage_async(src, row_stride, kS16, seq, qs);
  stage_async(src + d_model, row_stride, kS16, seq, ks);
  cp_async_commit();
  stage_async(src + 2 * d_model, row_stride, kS16, seq, vs);
  cp_async_commit();
  cp_async_wait<1>();
  if (bias3 != nullptr) {
    add_bias<kS16>(qs, bias3 + h * kHeadDim, seq);
    add_bias<kS16>(ks, bias3 + d_model + h * kHeadDim, seq);
  }
  __syncthreads();

  const int row0 = (threadIdx.x >> 5) * 16;  // this warp's first query row
  const int nt_end = key_tiles(row0, seq, causal != 0, kNt);

  float s[kNt][4];
  {
    uint32_t qa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) load_a(qa[kk], qs, kLd, row0, kk * 16);
    product_rows<kNt>(qa, ks, nt_end, s);
  }
  softmax_rows<kNt, kBias>(s, row0, seq, causal != 0, scale, nt_end, bias);
  cp_async_wait<0>();
  if (bias3 != nullptr) add_bias<kS16>(vs, bias3 + 2 * d_model + h * kHeadDim, seq);
  __syncthreads();

  // out = p v: p's C fragments of key tiles 2kk, 2kk + 1 are the A fragments
  // of k-step kk, rounded to bf16
  float o[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kT; ++kk) {
    if (2 * kk >= nt_end) continue;
    const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                           pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                           pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                           pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
    accumulate_rows(o, a, vs, kk * 16);
  }
  store_rows(o, 1.f, out + b * seq * static_cast<long long>(d_model) + h * kHeadDim, d_model,
             row0, seq);
}

template <int kT, bool kBias>
cudaError_t launch_with(const __nv_bfloat16* qkv, const __nv_bfloat16* bias3, const float* bias,
                        __nv_bfloat16* out, int batch, int seq, int heads, int causal,
                        float scale, cudaStream_t stream) {
  static unsigned long long configured = 0;
  constexpr size_t smem = fwd_smem_bytes<kT>();
  cudaError_t err = allow_smem(tiny_attention_fwd_kernel<kT, kBias>, smem, configured);
  if (err != cudaSuccess) return err;
  tiny_attention_fwd_kernel<kT, kBias><<<dim3(heads, batch), kT * 32, smem, stream>>>(
      qkv, bias3, bias, out, seq, heads, causal, scale);
  return cudaGetLastError();
}

template <int kT>
cudaError_t launch(const __nv_bfloat16* qkv, const __nv_bfloat16* bias3, const float* bias,
                   __nv_bfloat16* out, int batch, int seq, int heads, int causal, float scale,
                   cudaStream_t stream) {
  return bias != nullptr
             ? launch_with<kT, true>(qkv, bias3, bias, out, batch, seq, heads, causal, scale,
                                     stream)
             : launch_with<kT, false>(qkv, bias3, bias, out, batch, seq, heads, causal, scale,
                                      stream);
}

}  // namespace

// qkv: [batch, seq, 3 * heads * 64] bf16, contiguous, 16-byte aligned;
// bias3: [3 * heads * 64] bf16 or null; bias: [seq, seq] fp32, contiguous, or
// null; out: [batch, seq, heads * 64] bf16. causal != 0 masks keys above the
// diagonal (after the bias is added). Launches on `stream`, does not
// synchronise.
ILVLM_API int tiny_attention_fwd(const void* qkv, const void* bias3, const void* bias, void* out,
                                 int batch, int seq, int heads, int causal, float scale,
                                 void* stream) {
  if (batch < 1 || batch > 65535 || heads < 1 || seq < 1 || seq > kMaxSeq) {
    return cudaErrorInvalidValue;
  }
  const auto* q = static_cast<const __nv_bfloat16*>(qkv);
  const auto* b3 = static_cast<const __nv_bfloat16*>(bias3);
  const auto* bias_s = static_cast<const float*>(bias);
  auto* o = static_cast<__nv_bfloat16*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((seq + 15) / 16) {
    case 1: return launch<1>(q, b3, bias_s, o, batch, seq, heads, causal, scale, st);
    case 2: return launch<2>(q, b3, bias_s, o, batch, seq, heads, causal, scale, st);
    case 3: return launch<3>(q, b3, bias_s, o, batch, seq, heads, causal, scale, st);
    case 4: return launch<4>(q, b3, bias_s, o, batch, seq, heads, causal, scale, st);
    case 5: return launch<5>(q, b3, bias_s, o, batch, seq, heads, causal, scale, st);
    case 6: return launch<6>(q, b3, bias_s, o, batch, seq, heads, causal, scale, st);
    case 7: return launch<7>(q, b3, bias_s, o, batch, seq, heads, causal, scale, st);
    default: return launch<8>(q, b3, bias_s, o, batch, seq, heads, causal, scale, st);
  }
}
