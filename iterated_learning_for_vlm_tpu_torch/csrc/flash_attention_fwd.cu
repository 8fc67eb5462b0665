// K3-fwd: flash attention forward, any sequence length up to kMaxSeq.
//
// Replaces the TPU kernel iterated_learning_for_vlm_tpu/ops/flash_attention.py
// `_attn_fwd_kernel` (launched by `_fwd_impl.inner`). Same function, per
// (sample, head): logits = q k^T * 64^-1/2 in fp32, plus an optional shared
// [S, S] fp32 bias (the causal mask on the text tower), an fp32 softmax, the
// value product p v in fp32 (v upcast, p not rounded), one cast to bf16.
// The TPU kernel transposes q, k, v to [B*H, S, D] for its block specs; here
// the kernel reads the [B, S, H, 64] views of the packed in_proj output in
// place (batch and token strides given) and writes [B, S, H*64], the layout
// out_proj takes, so neither side moves data outside the kernel.
//
// What bounds it on an H100: per (sample, head) it is 4 S^2 64 flops over
// 4 S 64 bf16 values of device memory, so at S = 50 .. 257 it is bound by
// arithmetic, and the unfused path's cost is the [B, H, S, S] fp32 logits and
// probabilities it writes and rereads (477 MB each at B = 256, H = 12, S = 197).
// The kernel keeps them in registers. One block of 4 warps owns 64 query rows
// of one (sample, head); it walks the keys in chunks of 64, staged in shared
// memory (k row-major, v transposed: 18 KB), and keeps a running row max and
// sum (the online softmax), so any S fits. Both products run on the tensor
// cores (mma.sync m16n8k16, fp32 accumulators): q k^T takes the bf16 operands
// as they are, which makes each product exact and the logits fp32 sums; p
// enters p v as three bf16 terms whose sum is p to fp32 precision, so p v is
// an fp32 product, 3x the tensor-core work of a bf16 p. The sum is divided
// out at the end. No cp.async/TMA pipeline or wgmma yet.
#include "flash_attention.cuh"

namespace {

using namespace ilvlm::flash;

__global__ void __launch_bounds__(kWarps * 32)
flash_attention_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                           int seq, int heads, long long batch_stride, long long token_stride,
                           float scale) {
  __shared__ __align__(16) __nv_bfloat16 ks[kChunk * kLd];  // key chunk, row-major
  __shared__ __align__(16) __nv_bfloat16 vt[kChunk * kLd];  // value chunk, transposed

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = blockIdx.x * kChunk + warp * 16;  // this warp's first query row
  const int rows[2] = {row0 + g, row0 + g + 8};
  const long long head = b * batch_stride + h * kHeadDim;

  uint32_t qa[4][4];
  load_a_rows(q + head, token_stride, row0, seq, qa);

  float o[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running row max
  float l[2] = {0.f, 0.f};              // running row sum of exp(logit - m)

  for (int k0 = 0; k0 < seq; k0 += kChunk) {
    __syncthreads();  // the previous chunk is consumed
    stage(k + head, token_stride, k0, seq, ks, nullptr);
    stage(v + head, token_stride, k0, seq, nullptr, vt);
    __syncthreads();
    if (row0 >= seq) continue;  // a warp past the end only helps stage

    float s[8][4];
    product_rows<8>(qa, ks, 0, s);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = logit(s[nt][e], scale, bias, rows[e >> 1], k0 + nt * 8 + 2 * t + (e & 1),
                         seq);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      // a row with every logit so far at -inf keeps l = 0 and o = 0
      alpha[i] = mx[i] == -INFINITY ? 1.f : expf(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[nt][e];
        const float p = x == -INFINITY ? 0.f : expf(x - m[e >> 1]);
        s[nt][e] = p;
        rs[e >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + quad_sum(rs[i]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][e] *= alpha[e >> 1];
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) accumulate_fp32_a(o, s[2 * kk], s[2 * kk + 1], vt, kk * 16);
  }

  const float inv[2] = {1.f / l[0], 1.f / l[1]};  // rows past the end are not stored
  store_rows(o, inv, out + (static_cast<long long>(b) * seq * heads + h) * kHeadDim,
             static_cast<long long>(heads) * kHeadDim, row0, seq);
}

}  // namespace

// q, k, v: [batch, seq, heads, 64] bf16 views sharing `batch_stride` and
// `token_stride` (elements; heads at a stride of 64, 16-byte aligned rows);
// bias: [seq, seq] fp32 contiguous or null; out: [batch, seq, heads, 64] bf16
// contiguous. Launches on `stream`, does not synchronise.
ILVLM_API int flash_attention_fwd(const void* q, const void* k, const void* v, const void* bias,
                                  void* out, int batch, int seq, int heads,
                                  long long batch_stride, long long token_stride, float scale,
                                  void* stream) {
  if (batch < 1 || batch > 65535 || heads < 1 || heads > 65535 || seq < 1 || seq > kMaxSeq) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((seq + kChunk - 1) / kChunk, heads, batch);
  flash_attention_fwd_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), seq, heads, batch_stride, token_stride, scale);
  return cudaGetLastError();
}
