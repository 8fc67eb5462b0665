// K1-bwd: gradients of the fused FDT codebook pooling, dq and dsd.
//
// Replaces the TPU kernels iterated_learning_for_vlm_tpu/ops/codebook_attention.py
// `_bwd_dq_kernel` and `_bwd_dsd_kernel` (both launched by `_pooled_bwd`). With
// c = D^-1/2 / temperature (formed in fp32 by the wrapper) and w[b, n] =
// g[b, n] * c * keep[b, amax[b, n]], the max-pool sends each gradient to the
// one token that won the forward max:
//
//   dq[b, t] = sum_n [amax[b, n] = t] w[b, n] sd[n]      (fp32 sums, bf16 out)
//   dsd[n]   = sum_b w[b, n] q[b, amax[b, n]]            (fp32 sums, bf16 out)
//
// A pad (keep = 0) gets zero gradient and adds nothing to dsd. Codes past N
// are never read; rows of dq that no code routes to are written as zeros.
//
// The TPU kernels spell the routing as dense one-hot [T, N] matmuls, because
// their grid runs in order on a matrix unit. Here each (b, n) touches one row,
// so both kernels are gathers with no tensor-core work, and neither uses a
// float atomic: each output element is summed by one thread in a fixed order,
// so the result is the same from run to run.
//
// What bounds them on an H100, at B = 256, N = 4096, D = 512:
// - dsd reads B * N gathered q rows of 1 KB, ~1.07 GB, and q itself is only
//   12.8 MB (image T = 49) or 8.4 MB (text T = 32), so the rows come from the
//   50 MB L2. One warp owns one code and walks b in order; its lanes fetch the
//   routing of 32 batch rows at once and pass it round by shuffles, and each
//   lane keeps its 8-column slices of the sum in registers, loaded 16 bytes at
//   a time. L2 bandwidth bounds it.
// - dq rereads the 4 MB codebook once per batch row, ~1.07 GB from L2 as well.
//   One block owns one batch row and a 256-column slice of D, and keeps the
//   [T, 256] fp32 sum in shared memory (128 KB at T = 128; a whole-D sum would
//   be 256 KB, over the 227 KB a block can have). The block stages the routing
//   of 128 codes at a time in shared memory, then each thread walks them in
//   increasing n and adds w * sd[n] into its own two columns of row amax, so
//   no two threads ever touch one sum. Eight codebook loads are issued before
//   their adds, to keep L2 requests in flight.
// Tensor-core routings (a dense one-hot product per tile of codes, as on the
// TPU) are the next step once the H100 times show where these stand.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kMaxTokens = 128;
constexpr int kDqThreads = 128;
constexpr int kDqSlice = kDqThreads * 2;  // columns of D per dq block (a bf16 pair each)
constexpr int kDqUnroll = 8;
constexpr int kDsdWarps = 8;              // codes per dsd block, one per warp
constexpr int kVec = 8;                   // bf16 per 16-byte load
constexpr int kDsdChunk = 32 * kVec;      // columns a warp covers per load
constexpr int kMaxChunks = 4;             // D <= 1024
constexpr int kDsdUnroll = 4;

size_t dq_smem_bytes(int tokens) { return size_t(tokens) * kDqSlice * sizeof(float); }

// The routing weight of (b, n): t = amax, w = g * c * keep[t], or t = -1 when
// amax is out of range (it never is for an amax the forward wrote).
__device__ __forceinline__ void route(const int* __restrict__ amax, const float* __restrict__ g,
                                      const float* __restrict__ keep_b, size_t idx, int tokens,
                                      float coeff, int& t, float& w) {
  t = amax[idx];
  w = 0.f;
  if (t < 0 || t >= tokens) {
    t = -1;
    return;
  }
  w = g[idx] * coeff;
  if (keep_b != nullptr) w = w * keep_b[t];
}

__global__ void __launch_bounds__(kDqThreads)
codebook_pool_bwd_dq_kernel(const __nv_bfloat16* __restrict__ sd,
                            const float* __restrict__ keep, const int* __restrict__ amax,
                            const float* __restrict__ g, __nv_bfloat16* __restrict__ dq,
                            int tokens, int depth, int codes, float coeff) {
  extern __shared__ float2 acc[];  // [tokens][kDqThreads] column pairs
  __shared__ int t_s[kDqThreads];
  __shared__ float w_s[kDqThreads];

  const int b = blockIdx.y;
  const int col = blockIdx.x * kDqSlice + threadIdx.x * 2;
  const bool live = col < depth;
  const float* const keep_b = keep != nullptr ? keep + size_t(b) * tokens : nullptr;
  for (int t = 0; t < tokens; ++t) acc[t * kDqThreads + threadIdx.x] = make_float2(0.f, 0.f);

  for (int n0 = 0; n0 < codes; n0 += kDqThreads) {
    __syncthreads();  // the previous chunk's routing is consumed
    const int n = n0 + threadIdx.x;
    int t = -1;
    float w = 0.f;
    if (n < codes) route(amax, g, keep_b, size_t(b) * codes + n, tokens, coeff, t, w);
    t_s[threadIdx.x] = t;
    w_s[threadIdx.x] = w;
    __syncthreads();
    if (!live) continue;
    for (int j0 = 0; j0 < kDqThreads; j0 += kDqUnroll) {
      float2 s[kDqUnroll];
      int tt[kDqUnroll];
#pragma unroll
      for (int u = 0; u < kDqUnroll; ++u) {
        tt[u] = t_s[j0 + u];
        s[u] = make_float2(0.f, 0.f);
        if (tt[u] >= 0) {
          s[u] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              sd + size_t(n0 + j0 + u) * depth + col));
        }
      }
#pragma unroll
      for (int u = 0; u < kDqUnroll; ++u) {
        if (tt[u] >= 0) {  // the same for every thread of the block
          const float wu = w_s[j0 + u];
          float2& a = acc[tt[u] * kDqThreads + threadIdx.x];
          a.x = fmaf(wu, s[u].x, a.x);
          a.y = fmaf(wu, s[u].y, a.y);
        }
      }
    }
  }
  if (!live) return;
  // each thread wrote only its own columns, so no barrier is needed here
  __nv_bfloat16* const dst = dq + size_t(b) * tokens * depth + col;
  for (int t = 0; t < tokens; ++t) {
    const float2 a = acc[t * kDqThreads + threadIdx.x];
    *reinterpret_cast<__nv_bfloat162*>(dst + size_t(t) * depth) = __floats2bfloat162_rn(a.x, a.y);
  }
}

__global__ void __launch_bounds__(kDsdWarps * 32)
codebook_pool_bwd_dsd_kernel(const __nv_bfloat16* __restrict__ q,
                             const float* __restrict__ keep, const int* __restrict__ amax,
                             const float* __restrict__ g, __nv_bfloat16* __restrict__ dsd,
                             int batch, int tokens, int depth, int codes, float coeff) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kDsdWarps + warp;
  if (n >= codes) return;  // codes past N are never read
  const int chunks = (depth + kDsdChunk - 1) / kDsdChunk;

  float acc[kMaxChunks][kVec];
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c)
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[c][e] = 0.f;

  for (int b0 = 0; b0 < batch; b0 += 32) {
    // lane l fetches the routing of batch row b0 + l
    int t = -1;
    float w = 0.f;
    const int bl = b0 + lane;
    if (bl < batch) {
      route(amax, g, keep != nullptr ? keep + size_t(bl) * tokens : nullptr,
            size_t(bl) * codes + n, tokens, coeff, t, w);
    }
    const int rows = min(32, batch - b0);
    for (int j0 = 0; j0 < rows; j0 += kDsdUnroll) {
      uint4 v[kDsdUnroll][kMaxChunks];
      float wj[kDsdUnroll];
#pragma unroll
      for (int u = 0; u < kDsdUnroll; ++u) {
        const int j = j0 + u;
        const int tj = __shfl_sync(0xffffffffu, t, j & 31);
        wj[u] = __shfl_sync(0xffffffffu, w, j & 31);
        const bool use = j < rows && tj >= 0;  // the same for every lane
        if (!use) wj[u] = 0.f;
        const __nv_bfloat16* const row =
            use ? q + (size_t(b0 + j) * tokens + tj) * depth : q;
#pragma unroll
        for (int c = 0; c < kMaxChunks; ++c) {
          const int col = c * kDsdChunk + lane * kVec;
          v[u][c] = make_uint4(0u, 0u, 0u, 0u);
          if (use && c < chunks && col < depth) v[u][c] = *reinterpret_cast<const uint4*>(row + col);
        }
      }
#pragma unroll
      for (int u = 0; u < kDsdUnroll; ++u) {
        // a row past the batch has w = 0 and v = 0, so it adds exactly 0
#pragma unroll
        for (int c = 0; c < kMaxChunks; ++c) {
          const __nv_bfloat162* const h = reinterpret_cast<const __nv_bfloat162*>(&v[u][c]);
#pragma unroll
          for (int e = 0; e < kVec / 2; ++e) {
            const float2 f = __bfloat1622float2(h[e]);
            acc[c][2 * e] = fmaf(wj[u], f.x, acc[c][2 * e]);
            acc[c][2 * e + 1] = fmaf(wj[u], f.y, acc[c][2 * e + 1]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int col = c * kDsdChunk + lane * kVec;
    if (c < chunks && col < depth) {
      uint4 out;
      __nv_bfloat162* const h = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
      for (int e = 0; e < kVec / 2; ++e) h[e] = __floats2bfloat162_rn(acc[c][2 * e], acc[c][2 * e + 1]);
      *reinterpret_cast<uint4*>(dsd + size_t(n) * depth + col) = out;
    }
  }
}

bool bad_shape(int batch, int tokens, int depth, int codes) {
  return batch < 1 || batch > 65535 || tokens < 1 || tokens > kMaxTokens || depth < kVec ||
         depth % kVec != 0 || depth > kMaxChunks * kDsdChunk || codes < 1;
}

}  // namespace

// Both entries take the same arguments. q: [batch, tokens, depth] bf16; sd:
// [codes, depth] bf16; keep: [batch, tokens] fp32 or null; amax: [batch, codes]
// int32 (the forward's argmax); g: [batch, codes] fp32, the gradient of the
// pooled logits; out: dq [batch, tokens, depth] or dsd [codes, depth], bf16.
// All contiguous and 16-byte aligned; depth a multiple of 8, at most 1024;
// tokens <= 128. coeff = D^-1/2 / temperature. Launch on `stream`, no sync.
ILVLM_API int codebook_pool_bwd_dq(const void* q, const void* sd, const void* keep,
                                   const void* amax, const void* g, void* out, int batch,
                                   int tokens, int depth, int codes, float coeff, void* stream) {
  (void)q;
  if (bad_shape(batch, tokens, depth, codes)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(codebook_pool_bwd_dq_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(dq_smem_bytes(kMaxTokens)));
  if (err != cudaSuccess) return err;
  const dim3 grid((depth + kDqSlice - 1) / kDqSlice, batch);
  codebook_pool_bwd_dq_kernel<<<grid, kDqThreads, dq_smem_bytes(tokens),
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(sd), static_cast<const float*>(keep),
      static_cast<const int*>(amax), static_cast<const float*>(g),
      static_cast<__nv_bfloat16*>(out), tokens, depth, codes, coeff);
  return cudaGetLastError();
}

ILVLM_API int codebook_pool_bwd_dsd(const void* q, const void* sd, const void* keep,
                                    const void* amax, const void* g, void* out, int batch,
                                    int tokens, int depth, int codes, float coeff, void* stream) {
  (void)sd;
  if (bad_shape(batch, tokens, depth, codes)) return cudaErrorInvalidValue;
  const dim3 grid((codes + kDsdWarps - 1) / kDsdWarps);
  codebook_pool_bwd_dsd_kernel<<<grid, kDsdWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const float*>(keep),
      static_cast<const int*>(amax), static_cast<const float*>(g),
      static_cast<__nv_bfloat16*>(out), batch, tokens, depth, codes, coeff);
  return cudaGetLastError();
}
