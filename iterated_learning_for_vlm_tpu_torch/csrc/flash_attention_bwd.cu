// K3-bwd: flash attention backward, any sequence length up to kMaxSeq.
//
// Replaces the TPU kernel iterated_learning_for_vlm_tpu/ops/flash_attention.py
// `_attn_bwd_kernel` (launched by `_bwd_rule.inner`). Same function, per
// (sample, head), all in fp32 from bf16 q, k, v, do, cast to bf16 at the end:
//
//   p  = softmax(q k^T * scale + bias)      recomputed
//   dv = p^T do,   dp = do v^T,   ds = p (dp - sum_j dp p)
//   dq = ds k * scale,   dk = ds^T q * scale
//
// The bias (shared [S, S] fp32, or none) gets no gradient.
//
// What bounds it on an H100: five products of S^2 64 multiply-adds per
// (sample, head), arithmetic as in K3-fwd. The TPU kernel holds a whole
// (sample, head) in VMEM; here q, k, v and do as bf16 and the fp32 dk and dv
// sums would take 202 KB at S = 197 before p and ds, and blocks run in no
// order, so a sum split across blocks would need float atomics and would not
// repeat bit for bit. So the wrapper's one call makes two launches, and every
// output element has one owner that sums in a fixed order:
//
// 1. dq kernel: a block of 4 warps owns 64 query rows (16 a warp). Pass 1
//    walks the keys in chunks of 64 (k and v staged row-major) and recomputes
//    the row statistics: the max m and sum l of the softmax (online, as
//    K3-fwd) and D = sum_j dp p. Pass 2 walks them again (k also transposed),
//    forms p = exp(logit - m) / l and ds = p (dp - D) in registers and sums
//    dq += ds k. It writes dq and, per row, m, l and D to a scratch buffer.
//    The statistics are recomputed here, not saved by the forward, so the
//    forward and serving stay one kernel with one output.
// 2. dk/dv kernel: a block owns 64 key rows and walks the queries in chunks
//    of 64 (q and do staged row-major and transposed, with their m, l, D),
//    recomputes p^T and ds^T from the same statistics and sums dv += p^T do,
//    dk += ds^T q.
//
// Every product runs on the tensor cores (mma.sync m16n8k16, fp32
// accumulators): products of two bf16 operands take them as they are; p and
// ds enter as three bf16 terms whose sum is their fp32 value, so those
// products are fp32 products as in the TPU kernel. Shared memory: 28 KB and
// 38 KB a block. No cp.async/TMA pipeline or wgmma yet.
#include "flash_attention.cuh"

namespace {

using namespace ilvlm::flash;

__global__ void __launch_bounds__(kWarps * 32)
flash_attention_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const float* __restrict__ bias,
                              const __nv_bfloat16* __restrict__ dout,
                              __nv_bfloat16* __restrict__ dq, float* __restrict__ stats,
                              int seq, int heads, long long batch_stride, long long token_stride,
                              long long dout_batch_stride, long long dout_token_stride,
                              float scale) {
  __shared__ __align__(16) __nv_bfloat16 ks[kChunk * kLd];  // key chunk, row-major
  __shared__ __align__(16) __nv_bfloat16 vs[kChunk * kLd];  // value chunk, row-major
  __shared__ __align__(16) __nv_bfloat16 kt[kChunk * kLd];  // key chunk, transposed

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = blockIdx.x * kChunk + warp * 16;
  const int rows[2] = {row0 + g, row0 + g + 8};
  const long long head = b * batch_stride + h * kHeadDim;

  uint32_t qa[4][4], da[4][4];
  load_a_rows(q + head, token_stride, row0, seq, qa);
  load_a_rows(dout + b * dout_batch_stride + h * kHeadDim, dout_token_stride, row0, seq, da);

  // Pass 1: m, l and sum_j exp(logit - m) dp, online over the key chunks.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dsum[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < seq; k0 += kChunk) {
    __syncthreads();
    stage(k + head, token_stride, k0, seq, ks, nullptr);
    stage(v + head, token_stride, k0, seq, vs, nullptr);
    __syncthreads();
    if (row0 >= seq) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // 32 keys at a time
      float s[4][4], dp[4][4];
      product_rows<4>(qa, ks, half * 32, s);
      product_rows<4>(da, vs, half * 32, dp);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] = logit(s[nt][e], scale, bias, rows[e >> 1],
                           k0 + half * 32 + nt * 8 + 2 * t + (e & 1), seq);
          mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
        }
      }
      float alpha[2], rs[2] = {0.f, 0.f}, rd[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = quad_max(mx[i]);
        alpha[i] = mx[i] == -INFINITY ? 1.f : expf(m[i] - mx[i]);
        m[i] = mx[i];
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[nt][e];
          const float p = x == -INFINITY ? 0.f : expf(x - m[e >> 1]);
          rs[e >> 1] += p;
          rd[e >> 1] += p * dp[nt][e];
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] = l[i] * alpha[i] + quad_sum(rs[i]);
        dsum[i] = dsum[i] * alpha[i] + quad_sum(rd[i]);
      }
    }
  }
  // D = sum_j dp p (0 on a row past the end, whose logits are all -inf)
  const float dd[2] = {l[0] > 0.f ? dsum[0] / l[0] : 0.f, l[1] > 0.f ? dsum[1] / l[1] : 0.f};

  // Pass 2: ds = p (dp - D), dq += ds k.
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  for (int k0 = 0; k0 < seq; k0 += kChunk) {
    __syncthreads();
    stage(k + head, token_stride, k0, seq, ks, kt);
    stage(v + head, token_stride, k0, seq, vs, nullptr);
    __syncthreads();
    if (row0 >= seq) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float s[4][4], dp[4][4];
      product_rows<4>(qa, ks, half * 32, s);
      product_rows<4>(da, vs, half * 32, dp);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const float x = logit(s[nt][e], scale, bias, rows[i],
                                k0 + half * 32 + nt * 8 + 2 * t + (e & 1), seq);
          const float p = x == -INFINITY ? 0.f : expf(x - m[i]) / l[i];
          s[nt][e] = p * (dp[nt][e] - dd[i]);  // ds
        }
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        accumulate_fp32_a(acc, s[2 * kk], s[2 * kk + 1], kt, half * 32 + kk * 16);
      }
    }
  }
  if (row0 >= seq) return;
  const float mul[2] = {scale, scale};
  store_rows(acc, mul, dq + (static_cast<long long>(b) * seq * heads + h) * kHeadDim,
             static_cast<long long>(heads) * kHeadDim, row0, seq);
  if (t == 0) {
    const long long plane = static_cast<long long>(gridDim.z) * heads * seq;
    const long long base = (static_cast<long long>(b) * heads + h) * seq;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (rows[i] < seq) {
        stats[base + rows[i]] = m[i];
        stats[plane + base + rows[i]] = l[i];
        stats[2 * plane + base + rows[i]] = dd[i];
      }
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
flash_attention_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v,
                                const float* __restrict__ bias,
                                const __nv_bfloat16* __restrict__ dout,
                                const float* __restrict__ stats,
                                __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                                int seq, int heads, long long batch_stride,
                                long long token_stride, long long dout_batch_stride,
                                long long dout_token_stride, float scale) {
  __shared__ __align__(16) __nv_bfloat16 qs[kChunk * kLd];  // query chunk, row-major
  __shared__ __align__(16) __nv_bfloat16 qt[kChunk * kLd];  // ... transposed
  __shared__ __align__(16) __nv_bfloat16 gs[kChunk * kLd];  // output-gradient chunk, row-major
  __shared__ __align__(16) __nv_bfloat16 gt[kChunk * kLd];  // ... transposed
  __shared__ float ms[kChunk], ls[kChunk], dd[kChunk];

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = blockIdx.x * kChunk + warp * 16;  // this warp's first key row
  const int keys[2] = {row0 + g, row0 + g + 8};
  const long long head = b * batch_stride + h * kHeadDim;
  const long long plane = static_cast<long long>(gridDim.z) * heads * seq;
  const long long stat0 = (static_cast<long long>(b) * heads + h) * seq;

  uint32_t ka[4][4], va[4][4];
  load_a_rows(k + head, token_stride, row0, seq, ka);
  load_a_rows(v + head, token_stride, row0, seq, va);

  float adk[8][4], adv[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[nt][e] = adv[nt][e] = 0.f;

  for (int q0 = 0; q0 < seq; q0 += kChunk) {
    __syncthreads();
    stage(q + head, token_stride, q0, seq, qs, qt);
    stage(dout + b * dout_batch_stride + h * kHeadDim, dout_token_stride, q0, seq, gs, gt);
    for (int i = threadIdx.x; i < kChunk; i += blockDim.x) {
      const bool live = q0 + i < seq;  // rows past the end: p = 0 below
      ms[i] = live ? stats[stat0 + q0 + i] : 0.f;
      ls[i] = live ? stats[plane + stat0 + q0 + i] : 1.f;
      dd[i] = live ? stats[2 * plane + stat0 + q0 + i] : 0.f;
    }
    __syncthreads();
    if (row0 >= seq) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // 32 queries at a time
      float st[4][4], dpt[4][4];  // [key][query] tiles of p^T and dp^T
      product_rows<4>(ka, qs, half * 32, st);
      product_rows<4>(va, gs, half * 32, dpt);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = half * 32 + nt * 8 + 2 * t + (e & 1);  // query in the chunk
          const float x = logit(st[nt][e], scale, bias, q0 + c, keys[e >> 1], seq);
          const float p = x == -INFINITY ? 0.f : expf(x - ms[c]) / ls[c];
          st[nt][e] = p;
          dpt[nt][e] = p * (dpt[nt][e] - dd[c]);  // ds^T
        }
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        accumulate_fp32_a(adv, st[2 * kk], st[2 * kk + 1], gt, half * 32 + kk * 16);
        accumulate_fp32_a(adk, dpt[2 * kk], dpt[2 * kk + 1], qt, half * 32 + kk * 16);
      }
    }
  }
  if (row0 >= seq) return;
  const long long out0 = (static_cast<long long>(b) * seq * heads + h) * kHeadDim;
  const long long out_stride = static_cast<long long>(heads) * kHeadDim;
  const float one[2] = {1.f, 1.f}, mul[2] = {scale, scale};
  store_rows(adv, one, dv + out0, out_stride, row0, seq);
  store_rows(adk, mul, dk + out0, out_stride, row0, seq);
}

}  // namespace

// q, k, v: [batch, seq, heads, 64] bf16 views sharing `batch_stride` and
// `token_stride`; dout: the same shape with its own strides (elements; heads
// at a stride of 64, 16-byte aligned rows); bias: [seq, seq] fp32 contiguous
// or null; dq, dk, dv: [batch, seq, heads, 64] bf16 contiguous; stats: fp32
// scratch of 3 * batch * heads * seq. Two launches on `stream`, in order; does
// not synchronise.
ILVLM_API int flash_attention_bwd(const void* q, const void* k, const void* v, const void* bias,
                                  const void* dout, void* dq, void* dk, void* dv, void* stats,
                                  int batch, int seq, int heads, long long batch_stride,
                                  long long token_stride, long long dout_batch_stride,
                                  long long dout_token_stride, float scale, void* stream) {
  if (batch < 1 || batch > 65535 || heads < 1 || heads > 65535 || seq < 1 || seq > kMaxSeq) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((seq + kChunk - 1) / kChunk, heads, batch);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* q_ = static_cast<const __nv_bfloat16*>(q);
  const auto* k_ = static_cast<const __nv_bfloat16*>(k);
  const auto* v_ = static_cast<const __nv_bfloat16*>(v);
  const auto* bias_ = static_cast<const float*>(bias);
  const auto* dout_ = static_cast<const __nv_bfloat16*>(dout);
  flash_attention_bwd_dq_kernel<<<grid, kWarps * 32, 0, st>>>(
      q_, k_, v_, bias_, dout_, static_cast<__nv_bfloat16*>(dq), static_cast<float*>(stats),
      seq, heads, batch_stride, token_stride, dout_batch_stride, dout_token_stride, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_attention_bwd_dkdv_kernel<<<grid, kWarps * 32, 0, st>>>(
      q_, k_, v_, bias_, dout_, static_cast<const float*>(stats),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), seq, heads,
      batch_stride, token_stride, dout_batch_stride, dout_token_stride, scale);
  return cudaGetLastError();
}
