// K2-bwd: backward of multi-head self-attention for tiny sequences, packed QKV.
//
// Replaces the TPU kernel iterated_learning_for_vlm_tpu/ops/fused_attention.py
// `_bwd_kernel` (l.173, launched by `_bwd_local`). Same function: for each
// sample and head it recomputes the softmax from q and k (the in_proj bias
// optionally absorbed, added in bf16 as the forward adds it; the constant
// [S, S] logits bias, if any, and the causal mask as the forward applies
// them), then
//
//   dv = p^T do          p rounded to bf16, fp32 sums
//   dp = do v^T          fp32
//   ds = p (dp - sum_j dp p)   fp32 from the unrounded p, then rounded to bf16
//   dq = ds k * scale,   dk = ds^T q * scale   fp32 sums
//
// (the [S, S] bias gets no gradient: the JAX entry point stops it)
// and writes dq | dk | dv as bf16 into the packed [B, S, 3D] layout the in_proj
// gradient reads, at the head's column offsets. The TPU variant
// `_bwd_kernel_fused3` and the XLA hybrid behind `bwd_fuse3` compute the same
// function for the TPU's matrix unit and are not carried over.
//
// What bounds it on an H100: a (sample, head) is 10 S^2 64 flops over 8 S 64
// bf16 values of device memory (q, k, v, do in; dq, dk, dv out), so it is
// bound by bytes (at B = 256, S = 50, H = 12: 137.6 MB, 41 us at 3.35 TB/s,
// against 1.2 GFLOP). The design, as K2-fwd's (tiny_attention.cuh):
// - one block per (sample, head), kT = S16 / 16 warps; q, k, v and do staged
//   by cp.async as bf16 [S16][72] tiles (v and do a second copy group that
//   lands while q k^T and the softmax run), and p and ds as bf16
//   [S16][S16 + 8]: 54 KB at S16 = 64, so 4 blocks fit an SM;
// - pass 1, a warp per 16 query rows: q k^T and do v^T on the tensor cores,
//   the softmax in registers, D = sum_j dp p from the fp32 p, ds in fp32, then
//   p and ds rounded to bf16, stored to shared memory, and dq = ds k from the
//   registers;
// - pass 2, after one barrier, a warp per 16 key rows: dv = p^T do and
//   dk = ds^T q, their A fragments read transposed from the stored p and ds
//   by ldmatrix.trans;
// - with the causal mask, key tiles after a warp's last query are skipped in
//   pass 1 and query tiles before its first key in pass 2; tiles wholly past
//   S too;
// - the [S, S] bias, as in K2-fwd: read from L2 in the softmax, a template
//   flag, so the path without one is unchanged.
// Every output element has one owner that sums in a fixed order: no float
// atomics, and two calls agree bit for bit.
#include "tiny_attention.cuh"

namespace {

using namespace ilvlm;
using namespace ilvlm::tiny;

template <int kT>
__host__ __device__ constexpr int p_ld() {
  return 16 * kT + 8;  // bf16 row stride of the p and ds tiles
}

template <int kT>
constexpr size_t bwd_smem_bytes() {
  return (size_t(4) * 16 * kT * kLd + size_t(2) * 16 * kT * p_ld<kT>()) *
         sizeof(__nv_bfloat16);
}

template <int kT, bool kBias>
__global__ void __launch_bounds__(kT * 32)
tiny_attention_bwd_kernel(const __nv_bfloat16* __restrict__ qkv,
                          const __nv_bfloat16* __restrict__ bias3,
                          const float* __restrict__ bias,
                          const __nv_bfloat16* __restrict__ dout,
                          __nv_bfloat16* __restrict__ dqkv, int seq, int heads, int causal,
                          float scale) {
  constexpr int kS16 = 16 * kT;
  constexpr int kNt = 2 * kT;
  constexpr int kLdp = p_ld<kT>();
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* const qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* const ks = qs + kS16 * kLd;
  __nv_bfloat16* const vs = ks + kS16 * kLd;
  __nv_bfloat16* const dos = vs + kS16 * kLd;
  __nv_bfloat16* const ps = dos + kS16 * kLd;  // [query][key]
  __nv_bfloat16* const dss = ps + kS16 * kLdp;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int d_model = heads * kHeadDim;
  const long long row_stride = 3LL * d_model;
  // two copy groups: q and k, then v and do, which land while q k^T runs
  const __nv_bfloat16* const src = qkv + b * seq * row_stride + h * kHeadDim;
  stage_async(src, row_stride, kS16, seq, qs);
  stage_async(src + d_model, row_stride, kS16, seq, ks);
  cp_async_commit();
  stage_async(src + 2 * d_model, row_stride, kS16, seq, vs);
  stage_async(dout + b * seq * static_cast<long long>(d_model) + h * kHeadDim, d_model, kS16,
              seq, dos);
  cp_async_commit();
  cp_async_wait<1>();
  if (bias3 != nullptr) {
    add_bias<kS16>(qs, bias3 + h * kHeadDim, seq);
    add_bias<kS16>(ks, bias3 + d_model + h * kHeadDim, seq);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int w0 = (threadIdx.x >> 5) * 16;  // this warp's first query row, then key row
  __nv_bfloat16* const dst = dqkv + b * seq * row_stride + h * kHeadDim;

  // Pass 1: query rows w0 .. w0 + 15 -> p and ds rows, and dq.
  {
    const int nt_end = key_tiles(w0, seq, causal != 0, kNt);
    float s[kNt][4], dp[kNt][4];
    {
      uint32_t a[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) load_a(a[kk], qs, kLd, w0, kk * 16);
      product_rows<kNt>(a, ks, nt_end, s);
      softmax_rows<kNt, kBias>(s, w0, seq, causal != 0, scale, nt_end, bias);  // s = p
      cp_async_wait<0>();
      if (bias3 != nullptr) add_bias<kS16>(vs, bias3 + 2 * d_model + h * kHeadDim, seq);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) load_a(a[kk], dos, kLd, w0, kk * 16);
      product_rows<kNt>(a, vs, nt_end, dp);
    }
    float dd[2] = {0.f, 0.f};  // D = sum_j dp p, from the unrounded p
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dd[e >> 1] += dp[nt][e] * s[nt][e];
#pragma unroll
    for (int i = 0; i < 2; ++i) dd[i] = quad_sum(dd[i]);

    // p and ds as bf16 pairs (rows g and g + 8 of each key tile), stored
    // whole (zeros where masked or skipped) for pass 2
    uint32_t db[kNt][2];
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float p0 = s[nt][2 * half], p1 = s[nt][2 * half + 1];
        db[nt][half] = pack_bf16(p0 * (dp[nt][2 * half] - dd[half]),
                                 p1 * (dp[nt][2 * half + 1] - dd[half]));
        const int off = (w0 + g + 8 * half) * kLdp + nt * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(ps + off) = pack_bf16(p0, p1);
        *reinterpret_cast<uint32_t*>(dss + off) = db[nt][half];
      }
    }

    // dq = ds k * scale
    float acc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kT; ++kk) {
      if (2 * kk >= nt_end) continue;
      const uint32_t a[4] = {db[2 * kk][0], db[2 * kk][1], db[2 * kk + 1][0], db[2 * kk + 1][1]};
      accumulate_rows(acc, a, ks, kk * 16);
    }
    store_rows(acc, scale, dst, row_stride, w0, seq);
  }
  __syncthreads();  // every p and ds row is in shared memory

  // Pass 2: key rows w0 .. w0 + 15 -> dv = p^T do, dk = ds^T q * scale. With
  // the causal mask, p and ds are 0 for the queries before the warp's first key.
  float adv[8][4], adk[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) adv[nt][e] = adk[nt][e] = 0.f;
  const int kk_begin = causal ? w0 >> 4 : 0;
  const int kk_end = (seq + 15) >> 4;
#pragma unroll
  for (int kk = 0; kk < kT; ++kk) {
    if (kk < kk_begin || kk >= kk_end) continue;
    uint32_t a[4];
    load_a_t(a, ps, kLdp, w0, kk * 16);
    accumulate_rows(adv, a, dos, kk * 16);
    load_a_t(a, dss, kLdp, w0, kk * 16);
    accumulate_rows(adk, a, qs, kk * 16);
  }
  store_rows(adk, scale, dst + d_model, row_stride, w0, seq);
  store_rows(adv, 1.f, dst + 2 * d_model, row_stride, w0, seq);
}

template <int kT, bool kBias>
cudaError_t launch_with(const __nv_bfloat16* qkv, const __nv_bfloat16* bias3, const float* bias,
                        const __nv_bfloat16* dout, __nv_bfloat16* dqkv, int batch, int seq,
                        int heads, int causal, float scale, cudaStream_t stream) {
  static unsigned long long configured = 0;
  constexpr size_t smem = bwd_smem_bytes<kT>();
  cudaError_t err = allow_smem(tiny_attention_bwd_kernel<kT, kBias>, smem, configured);
  if (err != cudaSuccess) return err;
  tiny_attention_bwd_kernel<kT, kBias><<<dim3(heads, batch), kT * 32, smem, stream>>>(
      qkv, bias3, bias, dout, dqkv, seq, heads, causal, scale);
  return cudaGetLastError();
}

template <int kT>
cudaError_t launch(const __nv_bfloat16* qkv, const __nv_bfloat16* bias3, const float* bias,
                   const __nv_bfloat16* dout, __nv_bfloat16* dqkv, int batch, int seq, int heads,
                   int causal, float scale, cudaStream_t stream) {
  return bias != nullptr
             ? launch_with<kT, true>(qkv, bias3, bias, dout, dqkv, batch, seq, heads, causal,
                                     scale, stream)
             : launch_with<kT, false>(qkv, bias3, bias, dout, dqkv, batch, seq, heads, causal,
                                      scale, stream);
}

}  // namespace

// qkv: [batch, seq, 3 * heads * 64] bf16, the pre-bias packed projection;
// bias3: [3 * heads * 64] bf16 or null; bias: [seq, seq] fp32, contiguous, or
// null; dout: [batch, seq, heads * 64] bf16; dqkv: [batch, seq, 3 * heads *
// 64] bf16. All bf16 tensors contiguous and 16-byte aligned. causal != 0
// masks keys above the diagonal. Launches on `stream`, does not synchronise.
ILVLM_API int tiny_attention_bwd(const void* qkv, const void* bias3, const void* bias,
                                 const void* dout, void* dqkv, int batch, int seq, int heads,
                                 int causal, float scale, void* stream) {
  if (batch < 1 || batch > 65535 || heads < 1 || seq < 1 || seq > kMaxSeq) {
    return cudaErrorInvalidValue;
  }
  const auto* q = static_cast<const __nv_bfloat16*>(qkv);
  const auto* b3 = static_cast<const __nv_bfloat16*>(bias3);
  const auto* bias_s = static_cast<const float*>(bias);
  const auto* g = static_cast<const __nv_bfloat16*>(dout);
  auto* d = static_cast<__nv_bfloat16*>(dqkv);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((seq + 15) / 16) {
    case 1: return launch<1>(q, b3, bias_s, g, d, batch, seq, heads, causal, scale, st);
    case 2: return launch<2>(q, b3, bias_s, g, d, batch, seq, heads, causal, scale, st);
    case 3: return launch<3>(q, b3, bias_s, g, d, batch, seq, heads, causal, scale, st);
    case 4: return launch<4>(q, b3, bias_s, g, d, batch, seq, heads, causal, scale, st);
    case 5: return launch<5>(q, b3, bias_s, g, d, batch, seq, heads, causal, scale, st);
    case 6: return launch<6>(q, b3, bias_s, g, d, batch, seq, heads, causal, scale, st);
    case 7: return launch<7>(q, b3, bias_s, g, d, batch, seq, heads, causal, scale, st);
    default: return launch<8>(q, b3, bias_s, g, d, batch, seq, heads, causal, scale, st);
  }
}
