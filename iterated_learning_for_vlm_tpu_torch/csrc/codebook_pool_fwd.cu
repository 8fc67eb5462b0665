// K1-fwd: fused FDT codebook pooling forward.
//
// Replaces the TPU kernel iterated_learning_for_vlm_tpu/ops/codebook_attention.py
// `_pooled_fwd_kernel` (launched by `_pooled_fwd`). Same function:
//
//   pooled[b, n] = max_t ((q[b, t] . sd[n]) * scale * keep[b, t] / temperature)
//   amax[b, n]   = the first t that reaches that max
//
// with bf16 operands, fp32 accumulation and the TPU kernel's operation order
// (fp32 dot, * scale, * keep, / temperature). A padded token (keep = 0) enters
// the max as 0, not -inf: that is the reference semantics. Tokens past T in a
// ragged tile never enter the max; codes past N are never written. The
// temperature is a run-time argument, so a decaying schedule costs no rebuild.
//
// What bounds it on an H100: it is a [T, D] x [D, N] product per batch row
// (T <= 77, D = 512, N = 4096) followed by a max over T, so ~2 T D N flops
// against one read of q and of the codebook; the unfused path writes and
// rereads the [B, T, N] fp32 product (323 MB at B = 256, T = 77). The kernel
// keeps that product in registers: one block owns one batch row and 128 codes,
// stages q[b] and the codebook tile through shared memory 64 columns of D at a
// time (rows padded to 144 bytes so the fragment loads hit distinct banks), and
// each of its 8 warps runs bf16 tensor-core mma.sync (m16n8k16, fp32
// accumulators) over all T rows for its 16 codes. The max over T is taken in
// registers, then across the 8 lanes that share a column, smallest t winning
// ties. The loads are not yet overlapped with the math (no cp.async/TMA
// pipeline, no wgmma); that is the next step once the H100 times show where it
// stands.
#include "common.cuh"

namespace {

using ilvlm::mma_bf16_16816;

constexpr int kWarps = 8;
constexpr int kBlockN = kWarps * 16;  // codes per block
constexpr int kBlockK = 64;           // depth staged per step
constexpr int kLdk = kBlockK + 8;     // bf16 shared-memory row stride
constexpr int kMaxTokens = 128;
constexpr int kMaxMTiles = kMaxTokens / 16;
constexpr int kVec = 8;               // bf16 per 16-byte load
constexpr int kVecPerRow = kBlockK / kVec;

__global__ void __launch_bounds__(kWarps * 32)
codebook_pool_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ sd,
                         const float* __restrict__ keep,
                         float* __restrict__ pooled, int* __restrict__ amax,
                         int tokens, int depth, int codes, float scale, float temperature) {
  __shared__ __align__(16) __nv_bfloat16 qs[kMaxTokens * kLdk];
  __shared__ __align__(16) __nv_bfloat16 ss[kBlockN * kLdk];

  const int b = blockIdx.y;
  const int n0 = blockIdx.x * kBlockN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;    // mma group: fragment row / column
  const int tig = lane & 3;   // thread in group: fragment k pair
  const int mtiles = (tokens + 15) >> 4;
  const int rows = mtiles * 16;
  const __nv_bfloat16* const qb = q + size_t(b) * tokens * depth;

  float acc[kMaxMTiles][2][4];
#pragma unroll
  for (int mt = 0; mt < kMaxMTiles; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int k0 = 0; k0 < depth; k0 += kBlockK) {
    __syncthreads();  // the previous step's fragments are consumed
    for (int idx = threadIdx.x; idx < rows * kVecPerRow; idx += blockDim.x) {
      const int r = idx / kVecPerRow;
      const int c = (idx - r * kVecPerRow) * kVec;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);  // rows past T stage as zeros
      if (r < tokens) v = *reinterpret_cast<const uint4*>(qb + size_t(r) * depth + k0 + c);
      *reinterpret_cast<uint4*>(qs + r * kLdk + c) = v;
    }
    for (int idx = threadIdx.x; idx < kBlockN * kVecPerRow; idx += blockDim.x) {
      const int r = idx / kVecPerRow;
      const int c = (idx - r * kVecPerRow) * kVec;
      const int n = n0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (n < codes) v = *reinterpret_cast<const uint4*>(sd + size_t(n) * depth + k0 + c);
      *reinterpret_cast<uint4*>(ss + r * kLdk + c) = v;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBlockK; kk += 16) {
      uint32_t bf[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const __nv_bfloat16* const p = ss + (warp * 16 + nt * 8 + g) * kLdk + kk + 2 * tig;
        bf[nt][0] = *reinterpret_cast<const uint32_t*>(p);
        bf[nt][1] = *reinterpret_cast<const uint32_t*>(p + 8);
      }
#pragma unroll
      for (int mt = 0; mt < kMaxMTiles; ++mt) {
        if (mt < mtiles) {
          const __nv_bfloat16* const p = qs + (mt * 16 + g) * kLdk + kk + 2 * tig;
          uint32_t a[4];
          a[0] = *reinterpret_cast<const uint32_t*>(p);
          a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * kLdk);
          a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
          a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * kLdk + 8);
          mma_bf16_16816(acc[mt][0], a, bf[0][0], bf[0][1]);
          mma_bf16_16816(acc[mt][1], a, bf[1][0], bf[1][1]);
        }
      }
    }
  }

  // Epilogue: this thread holds rows g, g+8, 16+g, ... (increasing t) of
  // columns 2*tig and 2*tig+1 of each n8 tile. Scan upward with a strict >
  // so the first t reaching the max wins, then merge the 8 lanes of a column.
  const float* const keep_b = keep != nullptr ? keep + size_t(b) * tokens : nullptr;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float best = -INFINITY;
      int arg = tokens;
#pragma unroll
      for (int mt = 0; mt < kMaxMTiles; ++mt) {
        if (mt < mtiles) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int t = mt * 16 + half * 8 + g;
            if (t < tokens) {
              float v = acc[mt][nt][half * 2 + e] * scale;
              if (keep_b != nullptr) v = v * keep_b[t];
              v = v / temperature;
              if (v > best) {
                best = v;
                arg = t;
              }
            }
          }
        }
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, off);
        const int oa = __shfl_xor_sync(0xffffffffu, arg, off);
        if (ob > best || (ob == best && oa < arg)) {
          best = ob;
          arg = oa;
        }
      }
      const int n = n0 + warp * 16 + nt * 8 + 2 * tig + e;
      if (g == 0 && n < codes) {
        pooled[size_t(b) * codes + n] = best;
        amax[size_t(b) * codes + n] = arg;
      }
    }
  }
}

}  // namespace

// q: [batch, tokens, depth] bf16; sd: [codes, depth] bf16; keep: [batch, tokens]
// fp32 (1 real, 0 pad) or null; pooled: [batch, codes] fp32; amax: [batch,
// codes] int32. All contiguous; depth a multiple of 64, tokens <= 128.
// Launches on `stream`, does not synchronise.
ILVLM_API int codebook_pool_fwd(const void* q, const void* sd, const void* keep, void* pooled,
                                void* amax, int batch, int tokens, int depth, int codes,
                                float scale, float temperature, void* stream) {
  if (batch < 1 || batch > 65535 || tokens < 1 || tokens > kMaxTokens || depth < kBlockK ||
      depth % kBlockK != 0 || codes < 1) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((codes + kBlockN - 1) / kBlockN, batch);
  codebook_pool_fwd_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(sd),
      static_cast<const float*>(keep), static_cast<float*>(pooled), static_cast<int*>(amax),
      tokens, depth, codes, scale, temperature);
  return cudaGetLastError();
}
