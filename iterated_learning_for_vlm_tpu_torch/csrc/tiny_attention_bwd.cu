// K2-bwd: backward of multi-head self-attention for tiny sequences, packed QKV.
//
// Replaces the TPU kernel iterated_learning_for_vlm_tpu/ops/fused_attention.py
// `_bwd_kernel` (launched by `_bwd_local`). Same function: for each sample and
// head it recomputes the softmax from q and k (the in_proj bias optionally
// absorbed, added in bf16 as the forward adds it), then
//
//   dv = p^T do          p rounded to bf16, fp32 sums
//   dp = do v^T          fp32
//   ds = p (dp - sum_j dp p)   fp32, then rounded to bf16
//   dq = ds k * scale,   dk = ds^T q * scale   fp32 sums
//
// and writes dq | dk | dv as bf16 into the packed [B, S, 3D] layout the in_proj
// gradient reads, at the head's column offsets. The TPU variant
// `_bwd_kernel_fused3` and the XLA hybrid behind `bwd_fuse3` compute the same
// function for the TPU's matrix unit and are not carried over.
//
// What bounds it on an H100: at S <= 128 and hd = 64 a (sample, head) pair is
// ~5 S^2 hd multiply-adds over 8 S hd bf16 values of device memory (q, k, v,
// do in; dq, dk, dv out), so, like K2-fwd, its whole working set lives in one
// SM's shared memory and the body is bound by shared-memory bandwidth on the
// CUDA cores. One block owns one (sample, head). It stages q, k, v and do as
// fp32 (row stride 65 floats, so the per-lane key rows fall in distinct
// banks), 133 KB at S = 128, and p and ds as bf16 [S, S] (64 KB at S = 128:
// 197 KB in all, under the 227 KB a block can have, hence the dynamic
// shared-memory attribute). Pass 1 walks query rows, four per warp: logits
// and dp with the lane owning keys lane, lane + 32, ..., the softmax and ds in
// registers, the p and ds rows to shared memory, then dq from the ds row.
// Pass 2 walks key rows, four per warp, with the lane owning two columns, and
// sums dk and dv over the query rows (from the diagonal on, when causal).
// Tensor-core tiles are the next step once the H100 times show where it stands.
#include "common.cuh"

namespace {

constexpr int kHeadDim = 64;
constexpr int kLds = kHeadDim + 1;    // padded fp32 row stride in shared memory
constexpr int kWarps = 4;
constexpr int kRows = 4;              // rows a warp computes together
constexpr int kMaxSeq = 128;
constexpr int kSlots = kMaxSeq / 32;  // keys per lane

__host__ __device__ int p_stride(int seq) { return (seq + 7) & ~7; }

size_t smem_bytes(int seq) {
  return size_t(4) * seq * kLds * sizeof(float) +
         size_t(2) * seq * p_stride(seq) * sizeof(__nv_bfloat16);
}

__global__ void __launch_bounds__(kWarps * 32)
tiny_attention_bwd_kernel(const __nv_bfloat16* __restrict__ qkv,
                          const __nv_bfloat16* __restrict__ bias3,
                          const __nv_bfloat16* __restrict__ dout,
                          __nv_bfloat16* __restrict__ dqkv,
                          int seq, int heads, int causal, float scale) {
  extern __shared__ float smem[];
  float* const qs = smem;
  float* const ks = qs + seq * kLds;
  float* const vs = ks + seq * kLds;
  float* const dos = vs + seq * kLds;
  const int ldp = p_stride(seq);
  __nv_bfloat16* const ps = reinterpret_cast<__nv_bfloat16*>(dos + seq * kLds);
  __nv_bfloat16* const dss = ps + seq * ldp;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int d_model = heads * kHeadDim;
  const size_t row_stride = size_t(3) * d_model;
  const __nv_bfloat16* const src = qkv + size_t(b) * seq * row_stride;
  const __nv_bfloat16* const dsrc = dout + size_t(b) * seq * d_model;
  __nv_bfloat16* const dst_base = dqkv + size_t(b) * seq * row_stride + h * kHeadDim;

  // Stage q, k, v (bias added in bf16) and do of head h as fp32.
  constexpr int kPairs = kHeadDim / 2;
  const int per_part = seq * kPairs;
  for (int idx = threadIdx.x; idx < 4 * per_part; idx += blockDim.x) {
    const int part = idx / per_part;
    const int rem = idx - part * per_part;
    const int s = rem / kPairs;
    const int c = (rem - s * kPairs) * 2;
    __nv_bfloat162 v2;
    if (part < 3) {
      const int col = part * d_model + h * kHeadDim + c;
      v2 = *reinterpret_cast<const __nv_bfloat162*>(src + s * row_stride + col);
      if (bias3 != nullptr) v2 = __hadd2(v2, *reinterpret_cast<const __nv_bfloat162*>(bias3 + col));
    } else {
      v2 = *reinterpret_cast<const __nv_bfloat162*>(dsrc + size_t(s) * d_model + h * kHeadDim + c);
    }
    const float2 f = __bfloat1622float2(v2);
    float* const dst = smem + part * seq * kLds + s * kLds + c;
    dst[0] = f.x;
    dst[1] = f.y;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // Pass 1: query rows i0 .. i0 + 3 -> p and ds rows, and dq.
  for (int i0 = warp * kRows; i0 < seq; i0 += kWarps * kRows) {
    const int kend = causal ? min(seq, i0 + kRows) : seq;  // keys past kend: masked
    const int slots = (kend + 31) >> 5;

    float sc[kRows][kSlots], dp[kRows][kSlots];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int m = 0; m < kSlots; ++m) sc[r][m] = dp[r][m] = 0.f;

    const float* qrow[kRows];
    const float* drow[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      qrow[r] = qs + min(i0 + r, seq - 1) * kLds;
      drow[r] = dos + min(i0 + r, seq - 1) * kLds;
    }
    const float* krow[kSlots];
    const float* vrow[kSlots];
#pragma unroll
    for (int m = 0; m < kSlots; ++m) {
      krow[m] = ks + min(lane + 32 * m, seq - 1) * kLds;
      vrow[m] = vs + min(lane + 32 * m, seq - 1) * kLds;
    }

#pragma unroll 4
    for (int d = 0; d < kHeadDim; ++d) {
      float qv[kRows], dv[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        qv[r] = qrow[r][d];
        dv[r] = drow[r][d];
      }
#pragma unroll
      for (int m = 0; m < kSlots; ++m) {
        if (m < slots) {
          const float kv = krow[m][d];
          const float vv = vrow[m][d];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            sc[r][m] = fmaf(qv[r], kv, sc[r][m]);
            dp[r][m] = fmaf(dv[r], vv, dp[r][m]);
          }
        }
      }
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = i0 + r;
      if (i >= seq) continue;  // a row past the end: nothing stored
      float mx = -INFINITY;
#pragma unroll
      for (int m = 0; m < kSlots; ++m) {
        const int j = lane + 32 * m;
        const bool live = m < slots && j < seq && (!causal || j <= i);
        const float logit = live ? sc[r][m] * scale : -INFINITY;
        sc[r][m] = logit;
        mx = fmaxf(mx, logit);
      }
      mx = ilvlm::warp_max(mx);  // key 0 is never masked, so mx is finite
      float sum = 0.f;
#pragma unroll
      for (int m = 0; m < kSlots; ++m) {
        const float e = sc[r][m] == -INFINITY ? 0.f : expf(sc[r][m] - mx);
        sc[r][m] = e;
        sum += e;
      }
      sum = ilvlm::warp_sum(sum);
      float pdp = 0.f;
#pragma unroll
      for (int m = 0; m < kSlots; ++m) {
        sc[r][m] = sc[r][m] / sum;  // p; exactly 0 where masked
        pdp += dp[r][m] * sc[r][m];
      }
      pdp = ilvlm::warp_sum(pdp);
      __nv_bfloat16* const prow = ps + i * ldp;
      __nv_bfloat16* const dsrow = dss + i * ldp;
#pragma unroll
      for (int m = 0; m < kSlots; ++m) {
        const int j = lane + 32 * m;
        if (j < seq) {  // the whole row, masked keys as 0, for pass 2
          const float p = sc[r][m];
          prow[j] = __float2bfloat16(p);
          dsrow[j] = __float2bfloat16(p == 0.f ? 0.f : p * (dp[r][m] - pdp));
        }
      }
    }
    __syncwarp();

    // dq = ds k * scale; lane owns columns lane and lane + 32
    float o[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) o[r][0] = o[r][1] = 0.f;
    for (int j = 0; j < kend; ++j) {
      const float k0 = ks[j * kLds + lane];
      const float k1 = ks[j * kLds + lane + 32];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = i0 + r;
        const float dsv = i < seq ? __bfloat162float(dss[i * ldp + j]) : 0.f;
        o[r][0] = fmaf(dsv, k0, o[r][0]);
        o[r][1] = fmaf(dsv, k1, o[r][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = i0 + r;
      if (i < seq) {
        __nv_bfloat16* const dst = dst_base + size_t(i) * row_stride;
        dst[lane] = __float2bfloat16(o[r][0] * scale);
        dst[lane + 32] = __float2bfloat16(o[r][1] * scale);
      }
    }
  }
  __syncthreads();  // every p and ds row is in shared memory

  // Pass 2: key rows j0 .. j0 + 3 -> dk = ds^T q * scale, dv = p^T do.
  for (int j0 = warp * kRows; j0 < seq; j0 += kWarps * kRows) {
    float ak[kRows][2], av[kRows][2];
    int jc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      ak[r][0] = ak[r][1] = av[r][0] = av[r][1] = 0.f;
      jc[r] = min(j0 + r, seq - 1);
    }
    // with the causal mask p and ds are 0 above the diagonal
    for (int i = causal ? j0 : 0; i < seq; ++i) {
      const float q0 = qs[i * kLds + lane];
      const float q1 = qs[i * kLds + lane + 32];
      const float d0 = dos[i * kLds + lane];
      const float d1 = dos[i * kLds + lane + 32];
      const __nv_bfloat16* const prow = ps + i * ldp;
      const __nv_bfloat16* const dsrow = dss + i * ldp;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pv = __bfloat162float(prow[jc[r]]);
        const float dsv = __bfloat162float(dsrow[jc[r]]);
        ak[r][0] = fmaf(dsv, q0, ak[r][0]);
        ak[r][1] = fmaf(dsv, q1, ak[r][1]);
        av[r][0] = fmaf(pv, d0, av[r][0]);
        av[r][1] = fmaf(pv, d1, av[r][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int j = j0 + r;
      if (j < seq) {
        __nv_bfloat16* const dst = dst_base + size_t(j) * row_stride;
        dst[d_model + lane] = __float2bfloat16(ak[r][0] * scale);
        dst[d_model + lane + 32] = __float2bfloat16(ak[r][1] * scale);
        dst[2 * d_model + lane] = __float2bfloat16(av[r][0]);
        dst[2 * d_model + lane + 32] = __float2bfloat16(av[r][1]);
      }
    }
  }
}

}  // namespace

// qkv: [batch, seq, 3 * heads * 64] bf16, the pre-bias packed projection;
// bias3: [3 * heads * 64] bf16 or null; dout: [batch, seq, heads * 64] bf16;
// dqkv: [batch, seq, 3 * heads * 64] bf16. All contiguous. causal != 0 masks
// keys above the diagonal. Launches on `stream`, does not synchronise.
ILVLM_API int tiny_attention_bwd(const void* qkv, const void* bias3, const void* dout,
                                 void* dqkv, int batch, int seq, int heads, int causal,
                                 float scale, void* stream) {
  if (batch < 1 || batch > 65535 || heads < 1 || seq < 1 || seq > kMaxSeq) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(tiny_attention_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_bytes(kMaxSeq)));
  if (err != cudaSuccess) return err;
  const dim3 grid(heads, batch);
  tiny_attention_bwd_kernel<<<grid, kWarps * 32, smem_bytes(seq),
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const __nv_bfloat16*>(bias3),
      static_cast<const __nv_bfloat16*>(dout), static_cast<__nv_bfloat16*>(dqkv), seq, heads,
      causal, scale);
  return cudaGetLastError();
}
