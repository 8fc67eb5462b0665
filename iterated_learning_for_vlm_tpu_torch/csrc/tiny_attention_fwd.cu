// K2-fwd: multi-head self-attention for tiny sequences, read from packed QKV.
//
// Replaces the TPU kernel iterated_learning_for_vlm_tpu/ops/fused_attention.py
// `_fwd_kernel` (launched by `_fwd_local`). Same function: for each sample and
// head, softmax(q k^T * hd^-1/2 [+ causal mask]) v, read straight from the
// [B, S, 3D] packed projection (q | k | v column blocks, torch in_proj order)
// with the in_proj bias optionally absorbed, written as [B, S, D] at the
// head's column offset. Numerics follow the unfused path: fp32 logits and
// softmax, p rounded to the operand dtype (bf16), p @ v accumulated in fp32.
//
// What bounds it on an H100: at S <= 128 and hd = 64 a (sample, head) pair is
// ~2 S^2 hd multiply-adds over 4 S hd bf16 values, so its whole working set
// fits in one SM's shared memory and device-memory traffic is one read of
// q/k/v and one write of the output. The TPU kernel's block-diagonal head and
// sample grouping, group mask and sublane padding exist to feed a 128x128
// systolic array and are not carried over. Here one block owns one
// (sample, head): it stages q/k/v once in shared memory as fp32 (row stride
// 65 floats, so the per-lane key rows fall in distinct banks), and each warp
// computes four query rows at a time so every key value loaded from shared
// memory feeds four multiply-adds. The body runs on the CUDA cores; shared
// memory bandwidth, not device memory, is its limit. Tensor-core tiles
// (mma/wgmma) are the next step once the H100 times show where it stands.
#include "common.cuh"

namespace {

constexpr int kHeadDim = 64;          // head width on every main-path tower
constexpr int kLds = kHeadDim + 1;    // padded fp32 row stride in shared memory
constexpr int kWarps = 4;
constexpr int kRows = 4;              // query rows a warp computes together
constexpr int kMaxSeq = 128;          // towers with S > 128 take the plain path
constexpr int kSlots = kMaxSeq / 32;  // keys per lane

size_t smem_bytes(int seq) {
  return (size_t(3) * seq * kLds + size_t(kWarps) * kRows * kMaxSeq) * sizeof(float);
}

__global__ void __launch_bounds__(kWarps * 32)
tiny_attention_fwd_kernel(const __nv_bfloat16* __restrict__ qkv,
                          const __nv_bfloat16* __restrict__ bias3,
                          __nv_bfloat16* __restrict__ out,
                          int seq, int heads, int causal, float scale) {
  extern __shared__ float smem[];
  float* const qs = smem;
  float* const ks = qs + seq * kLds;
  float* const vs = ks + seq * kLds;
  float* const ps = vs + seq * kLds;  // [kWarps][kRows][kMaxSeq] softmax rows

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int d_model = heads * kHeadDim;
  const size_t row_stride = size_t(3) * d_model;
  const __nv_bfloat16* const src = qkv + size_t(b) * seq * row_stride;

  // Stage q, k, v of head h as fp32; a warp reads one 128-byte row slice.
  // The absorbed in_proj bias is added in bf16, the operand dtype, as the
  // unfused path adds it after the projection.
  constexpr int kPairs = kHeadDim / 2;
  const int per_part = seq * kPairs;
  for (int idx = threadIdx.x; idx < 3 * per_part; idx += blockDim.x) {
    const int part = idx / per_part;
    const int rem = idx - part * per_part;
    const int s = rem / kPairs;
    const int c = (rem - s * kPairs) * 2;
    const int col = part * d_model + h * kHeadDim + c;
    __nv_bfloat162 v2 = *reinterpret_cast<const __nv_bfloat162*>(src + s * row_stride + col);
    if (bias3 != nullptr) v2 = __hadd2(v2, *reinterpret_cast<const __nv_bfloat162*>(bias3 + col));
    const float2 f = __bfloat1622float2(v2);
    float* const dst = smem + part * seq * kLds + s * kLds + c;
    dst[0] = f.x;
    dst[1] = f.y;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* const pw = ps + warp * kRows * kMaxSeq;
  __nv_bfloat16* const dst_base = out + size_t(b) * seq * d_model + h * kHeadDim;

  for (int i0 = warp * kRows; i0 < seq; i0 += kWarps * kRows) {
    // keys at or past kend are masked for every row of this group
    const int kend = causal ? min(seq, i0 + kRows) : seq;
    const int slots = (kend + 31) >> 5;

    float acc[kRows][kSlots];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int m = 0; m < kSlots; ++m) acc[r][m] = 0.f;

    const float* qrow[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) qrow[r] = qs + min(i0 + r, seq - 1) * kLds;
    const float* krow[kSlots];
#pragma unroll
    for (int m = 0; m < kSlots; ++m) krow[m] = ks + min(lane + 32 * m, seq - 1) * kLds;

    // logits: lane owns keys lane, lane+32, ...; fp32 dot over hd
#pragma unroll 8
    for (int d = 0; d < kHeadDim; ++d) {
      float qv[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) qv[r] = qrow[r][d];
#pragma unroll
      for (int m = 0; m < kSlots; ++m) {
        if (m < slots) {
          const float kv = krow[m][d];
#pragma unroll
          for (int r = 0; r < kRows; ++r) acc[r][m] = fmaf(qv[r], kv, acc[r][m]);
        }
      }
    }

    // fp32 softmax per row, then p rounded to bf16 for the value product
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = i0 + r;
      float* const prow = pw + r * kMaxSeq;
      if (i >= seq) {  // a row past the end: zero p, never stored
        for (int j = lane; j < kend; j += 32) prow[j] = 0.f;
        continue;
      }
      float mx = -INFINITY;
#pragma unroll
      for (int m = 0; m < kSlots; ++m) {
        const int j = lane + 32 * m;
        const bool live = m < slots && j < seq && (!causal || j <= i);
        const float logit = live ? acc[r][m] * scale : -INFINITY;
        acc[r][m] = logit;
        mx = fmaxf(mx, logit);
      }
      mx = ilvlm::warp_max(mx);  // key 0 is never masked, so mx is finite
      float sum = 0.f;
#pragma unroll
      for (int m = 0; m < kSlots; ++m) {
        const float e = acc[r][m] == -INFINITY ? 0.f : expf(acc[r][m] - mx);
        acc[r][m] = e;
        sum += e;
      }
      sum = ilvlm::warp_sum(sum);
#pragma unroll
      for (int m = 0; m < kSlots; ++m) {
        const int j = lane + 32 * m;
        if (j < kend) prow[j] = __bfloat162float(__float2bfloat16(acc[r][m] / sum));
      }
    }
    __syncwarp();

    // out = p @ v, fp32 accumulation; lane owns columns lane and lane + 32
    float o[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) o[r][0] = o[r][1] = 0.f;
    for (int j = 0; j < kend; ++j) {
      const float v0 = vs[j * kLds + lane];
      const float v1 = vs[j * kLds + lane + 32];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float p = pw[r * kMaxSeq + j];
        o[r][0] = fmaf(p, v0, o[r][0]);
        o[r][1] = fmaf(p, v1, o[r][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = i0 + r;
      if (i < seq) {
        __nv_bfloat16* const dst = dst_base + size_t(i) * d_model;
        dst[lane] = __float2bfloat16(o[r][0]);
        dst[lane + 32] = __float2bfloat16(o[r][1]);
      }
    }
    __syncwarp();  // pw is rewritten by the next row group
  }
}

}  // namespace

// qkv: [batch, seq, 3 * heads * 64] bf16, contiguous; bias3: [3 * heads * 64]
// bf16 or null; out: [batch, seq, heads * 64] bf16. causal != 0 masks keys
// above the diagonal. Launches on `stream`, does not synchronise.
ILVLM_API int tiny_attention_fwd(const void* qkv, const void* bias3, void* out, int batch,
                                 int seq, int heads, int causal, float scale, void* stream) {
  if (batch < 1 || batch > 65535 || heads < 1 || seq < 1 || seq > kMaxSeq) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(tiny_attention_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_bytes(kMaxSeq)));
  if (err != cudaSuccess) return err;
  const dim3 grid(heads, batch);
  tiny_attention_fwd_kernel<<<grid, kWarps * 32, smem_bytes(seq),
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const __nv_bfloat16*>(bias3),
      static_cast<__nv_bfloat16*>(out), seq, heads, causal, scale);
  return cudaGetLastError();
}
