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
// are never read; rows of dq that no code routes to are written as zeros. No
// kernel here uses a float atomic: each output element is summed by one
// thread in a fixed order, so the result is the same from run to run. Any
// T >= 1.
//
// What bounds them on an H100, at B = 256, N = 4096, D = 512: the useful work
// is B N D = 0.54 G fused multiply-adds on ~25 MB of device memory, but the
// routing is data-dependent, so the operands are gathered.
// - dq is two launches. The route kernel sorts each batch row's codes by amax
//   (a counting sort, deterministic: one block a row, the codes' order kept
//   within a token) into (n, w) pairs and per-token offsets. The gather
//   kernel then gives a block a 16-column slice of D and a range of batch
//   rows: the slice of the whole codebook (4096 x 32 bytes) is staged once by
//   cp.async and stays in shared memory for all of the block's rows, and each
//   half-warp owns one output row (b, t): its lanes split the row's sorted
//   run of codes, each with 16 sums in registers, and a fixed shuffle tree
//   adds them. The codebook crosses L2 once per row range (4 times at
//   B = 256); the sorted routing (8 bytes a code) is what each column slice
//   rereads. The random 32-byte reads of the slice cost shared-memory bank
//   conflicts: that, not the sums, bounds the gather.
// - The TPU kernel's dense one-hot form (w as two bf16 terms on the tensor
//   cores, 2 x 2 B T N D operations, T times the gather's work) was measured
//   against this gather and lost at every main-path shape (PERF.md).
// - dsd reads B * N gathered q rows of 1 KB, ~1.07 GB, and q itself is only
//   12.8 MB (image T = 49) or 8.4 MB (text T = 32), so the rows come from the
//   50 MB L2. One warp owns one code and walks b in order; its lanes fetch the
//   routing of 32 batch rows at once and pass it round by shuffles, and each
//   lane keeps its 8-column slices of the sum in registers, loaded 16 bytes at
//   a time. L2 bandwidth bounds it.
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace ilvlm;

constexpr int kVec = 8;  // bf16 per 16-byte load

// -- dq: route, then gather --------------------------------------------------
constexpr int kRouteWarps = 8;
constexpr int kRouteWindow = 1024;  // tokens a counting pass covers
constexpr int kRouteBins = kRouteWindow / (kRouteWarps * 32);
constexpr int kRouteUnroll = 4;
constexpr int kGatherThreads = 512;
constexpr int kGatherCols = 16;  // columns of D a gather block owns: 32 bytes a code
constexpr int kGatherUnroll = 2;  // codes a lane has in flight
constexpr size_t kStagedBytes = 227 * 1024;  // slice + two rows of routing in shared memory

// One block per batch row b. Writes pairs[b, :count] = (n, w bits) sorted by
// amax[b, n], then by n, leaving out w = 0 (a pad's codes add exactly 0);
// offsets[b, t] is the first entry of token t and offsets[b, T] the count
// (rows pair_ld and off_ld apart, 16-byte multiples, for the gather's
// copies). Warp w owns a contiguous segment of codes; a pass
// counts, per warp, the codes of each token of a 1024-token window, a scan in
// (token, warp) order turns the counts into positions, and a second pass
// places each code at its position (its rank among the warp's equal tokens by
// __match_any_sync). No atomics, so the order is the same on every run.
__global__ void __launch_bounds__(kRouteWarps * 32)
codebook_pool_dq_route_kernel(const float* __restrict__ keep, const int* __restrict__ amax,
                              const float* __restrict__ g, int2* __restrict__ pairs,
                              int* __restrict__ offsets, int tokens, int codes, float coeff,
                              int pair_ld, int off_ld) {
  __shared__ int cnt[kRouteWarps][kRouteWindow];
  __shared__ int warp_sum[kRouteWarps];
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int per_warp = (codes + kRouteWarps * 32 - 1) / (kRouteWarps * 32) * 32;
  const int n_beg = warp * per_warp;
  const int n_end = min(codes, n_beg + per_warp);
  const int* const am = amax + size_t(b) * codes;
  const float* const gb = g + size_t(b) * codes;
  const float* const kb = keep != nullptr ? keep + size_t(b) * tokens : nullptr;
  int2* const rt = pairs + size_t(b) * pair_ld;
  int* const off = offsets + size_t(b) * off_ld;
  int placed = 0;  // codes of earlier windows

  for (int w0 = 0; w0 < tokens; w0 += kRouteWindow) {
    const int win = min(kRouteWindow, tokens - w0);
    // code n's token relative to the window (-1: outside it, or a zero weight,
    // which adds exactly nothing: pads) and its weight w = g c keep[t]
    auto weight = [&](int n, int& t, float& w) {
      t = -1;
      w = 0.f;
      if (n >= n_end) return;
      const int a = am[n];
      if (a < w0 || a >= w0 + win) return;
      w = gb[n] * coeff;
      if (kb != nullptr) w = w * kb[a];
      if (w != 0.f) t = a - w0;
    };
    for (int i = threadIdx.x; i < kRouteWarps * kRouteWindow; i += blockDim.x) (&cnt[0][0])[i] = 0;
    __syncthreads();

    for (int n0 = n_beg; n0 < n_end; n0 += 32 * kRouteUnroll) {
      int tv[kRouteUnroll];
      float wv[kRouteUnroll];
#pragma unroll
      for (int u = 0; u < kRouteUnroll; ++u) weight(n0 + u * 32 + lane, tv[u], wv[u]);
#pragma unroll
      for (int u = 0; u < kRouteUnroll; ++u) {
        const bool in = tv[u] >= 0;
        const unsigned peers = __match_any_sync(0xffffffffu, in ? tv[u] : -1);
        if (in && (peers & below) == 0) cnt[warp][tv[u]] += __popc(peers);
        __syncwarp();
      }
    }
    __syncthreads();

    // thread j owns tokens j kRouteBins .. + kRouteBins - 1 of the window
    int tot[kRouteBins];
    int sum = 0;
#pragma unroll
    for (int k = 0; k < kRouteBins; ++k) {
      const int i = threadIdx.x * kRouteBins + k;
      int run = 0;
      if (i < win) {
        for (int w = 0; w < kRouteWarps; ++w) {
          const int c = cnt[w][i];
          cnt[w][i] = run;  // codes of this token in earlier warps
          run += c;
        }
      }
      tot[k] = run;
      sum += run;
    }
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    int start = placed + incl - sum;
    int window_total = 0;
    for (int w = 0; w < kRouteWarps; ++w) {
      if (w < warp) start += warp_sum[w];
      window_total += warp_sum[w];
    }
#pragma unroll
    for (int k = 0; k < kRouteBins; ++k) {
      const int i = threadIdx.x * kRouteBins + k;
      if (i < win) {
        off[w0 + i] = start;
        for (int w = 0; w < kRouteWarps; ++w) cnt[w][i] += start;
        start += tot[k];
      }
    }
    __syncthreads();

    for (int n0 = n_beg; n0 < n_end; n0 += 32 * kRouteUnroll) {
      int tv[kRouteUnroll];
      float wv[kRouteUnroll];
#pragma unroll
      for (int u = 0; u < kRouteUnroll; ++u) weight(n0 + u * 32 + lane, tv[u], wv[u]);
#pragma unroll
      for (int u = 0; u < kRouteUnroll; ++u) {
        const bool in = tv[u] >= 0;
        const unsigned peers = __match_any_sync(0xffffffffu, in ? tv[u] : -1);
        const int pos = in ? cnt[warp][tv[u]] + __popc(peers & below) : 0;
        __syncwarp();
        if (in) {
          rt[pos] = make_int2(n0 + u * 32 + lane, __float_as_int(wv[u]));
          if ((peers & below) == 0) cnt[warp][tv[u]] += __popc(peers);
        }
        __syncwarp();
      }
    }
    placed += window_total;
    __syncthreads();  // cnt and warp_sum are reused by the next window
  }
  if (threadIdx.x == 0) off[tokens] = placed;
}

__device__ __forceinline__ void fma_bf16x8(float (&acc)[8], float w, const uint4& v) {
  const __nv_bfloat162* const h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    acc[2 * e] = fmaf(w, f.x, acc[2 * e]);
    acc[2 * e + 1] = fmaf(w, f.y, acc[2 * e + 1]);
  }
}

// Block (column slice x, batch range y) walks its batch rows in order. With
// kStaged, the slice [codes][16] stays in shared memory, and each row's sorted
// pairs and offsets are staged there too, the next row's copies in flight
// while the current row is summed (two buffers, one barrier a row); without
// it (a codebook too large to keep), everything is read in place. Each
// half-warp owns one output row (b, t) at a time: its 16 lanes take the row's
// run of codes 16 apart, each summing w sd[n] over the slice's 16 columns in
// registers, and a fixed transpose-reduction leaves column c's total on lane c.
template <bool kStaged>
__global__ void __launch_bounds__(kGatherThreads)
codebook_pool_dq_gather_kernel(const __nv_bfloat16* __restrict__ sd,
                               const int2* __restrict__ pairs, const int* __restrict__ offsets,
                               __nv_bfloat16* __restrict__ dq,
                               int batch, int tokens, int depth, int codes, int pair_ld,
                               int off_ld) {
  extern __shared__ __align__(16) uint4 smem_v[];
  uint4* const slice_s = smem_v;                                   // [codes][2]
  int2* const pairs_s = reinterpret_cast<int2*>(smem_v + 2 * codes);  // [2][pair_ld]
  int* const offs_s = reinterpret_cast<int*>(pairs_s + 2 * pair_ld);  // [2][off_ld]
  const int col0 = blockIdx.x * kGatherCols;
  const int b0 = int((long long)batch * blockIdx.y / gridDim.y);
  const int b1 = int((long long)batch * (blockIdx.y + 1) / gridDim.y);

  auto stage_row = [&](int b, int buf) {
    const uint4* const src_p = reinterpret_cast<const uint4*>(pairs + size_t(b) * pair_ld);
    uint4* const dst_p = reinterpret_cast<uint4*>(pairs_s + buf * pair_ld);
    for (int i = threadIdx.x; i < pair_ld / 2; i += blockDim.x) {
      cp_async16(dst_p + i, src_p + i, 16);
    }
    const uint4* const src_o = reinterpret_cast<const uint4*>(offsets + size_t(b) * off_ld);
    uint4* const dst_o = reinterpret_cast<uint4*>(offs_s + buf * off_ld);
    for (int i = threadIdx.x; i < off_ld / 4; i += blockDim.x) {
      cp_async16(dst_o + i, src_o + i, 16);
    }
  };
  if (kStaged) {
    for (int idx = threadIdx.x; idx < codes * 2; idx += blockDim.x) {
      cp_async16(slice_s + idx, sd + size_t(idx >> 1) * depth + col0 + (idx & 1) * kVec, 16);
    }
    stage_row(b0, 0);
    cp_async_commit();
  }

  const int sub = threadIdx.x & 15;
  // odd lanes read a code's columns 8..15 first: a quarter-warp's 16-byte
  // reads of eight codes' 32-byte rows then spread over all eight 16-byte
  // bank slots of a 128-byte line, not four
  const int odd = sub & 1;
  const unsigned mask = 0xffffu << (threadIdx.x & 16);  // this half-warp's lanes
  for (int b = b0; b < b1; ++b) {
    const int buf = (b - b0) & 1;
    if (kStaged) {
      cp_async_wait<0>();
      __syncthreads();  // row b landed; the other buffer's row is done
      if (b + 1 < b1) stage_row(b + 1, buf ^ 1);
      cp_async_commit();
    }
    const int* const off = kStaged ? offs_s + buf * off_ld : offsets + size_t(b) * off_ld;
    const int2* const r = kStaged ? pairs_s + buf * pair_ld : pairs + size_t(b) * pair_ld;
    for (int t = threadIdx.x >> 4; t < tokens; t += blockDim.x >> 4) {
      const int beg = off[t];
      const int end = off[t + 1];
      float lo[kVec], hi[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) lo[e] = hi[e] = 0.f;
      for (int j0 = beg; j0 < end; j0 += 16 * kGatherUnroll) {
        int2 ent[kGatherUnroll];
        uint4 x[kGatherUnroll], y[kGatherUnroll];
#pragma unroll
        for (int u = 0; u < kGatherUnroll; ++u) {
          const int j = j0 + u * 16 + sub;
          ent[u] = j < end ? r[j] : make_int2(0, 0);
        }
#pragma unroll
        for (int u = 0; u < kGatherUnroll; ++u) {
          const uint4* const row = kStaged ? slice_s + 2 * ent[u].x
                                           : reinterpret_cast<const uint4*>(
                                                 sd + size_t(ent[u].x) * depth + col0);
          x[u] = row[odd];
          y[u] = row[odd ^ 1];
        }
#pragma unroll
        for (int u = 0; u < kGatherUnroll; ++u) {
          if (j0 + u * 16 + sub < end) {
            const float w = __int_as_float(ent[u].y);
            fma_bf16x8(lo, w, x[u]);
            fma_bf16x8(hi, w, y[u]);
          }
        }
      }
      if (odd) {  // this lane summed columns 8..15 in lo
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float v = lo[e];
          lo[e] = hi[e];
          hi[e] = v;
        }
      }
      // lanes with bit 8 keep columns 8..15, the others 0..7; then 4, 2, 1
      const bool up8 = sub & 8, up4 = sub & 4, up2 = sub & 2, up1 = sub & 1;
      float v8[kVec], v4[4], v2[2];
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        v8[e] = (up8 ? hi[e] : lo[e]) + __shfl_xor_sync(mask, up8 ? lo[e] : hi[e], 8);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v4[e] = (up4 ? v8[e + 4] : v8[e]) + __shfl_xor_sync(mask, up4 ? v8[e] : v8[e + 4], 4);
#pragma unroll
      for (int e = 0; e < 2; ++e)
        v2[e] = (up2 ? v4[e + 2] : v4[e]) + __shfl_xor_sync(mask, up2 ? v4[e] : v4[e + 2], 2);
      const float v1 = (up1 ? v2[1] : v2[0]) + __shfl_xor_sync(mask, up1 ? v2[0] : v2[1], 1);
      dq[((long long)b * tokens + t) * depth + col0 + sub] = __float2bfloat16_rn(v1);
    }
  }
}

// -- dsd ----------------------------------------------------------------------
constexpr int kDsdWarps = 8;         // codes per dsd block, one per warp
constexpr int kDsdChunk = 32 * kVec;  // columns a warp covers per load
constexpr int kMaxChunks = 4;        // D <= 1024
constexpr int kDsdUnroll = 4;

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
  return batch < 1 || batch > 65535 || tokens < 1 || depth < kGatherCols ||
         depth % kGatherCols != 0 || depth > kMaxChunks * kDsdChunk || codes < 1;
}

}  // namespace

// Every entry takes q: [batch, tokens, depth] bf16; sd: [codes, depth] bf16;
// keep: [batch, tokens] fp32 or null; amax: [batch, codes] int32 (the
// forward's argmax); g: [batch, codes] fp32, the gradient of the pooled
// logits; out: dq [batch, tokens, depth] or dsd [codes, depth], bf16. All
// contiguous and 16-byte aligned; depth a multiple of 16, at most 1024; any
// tokens >= 1. coeff = D^-1/2 / temperature. Launch on `stream`, no sync.

// dq. scratch: int32 [batch, 2 codes + tokens + 8] or more (the
// sorted routing, rows rounded to 16 bytes, then the per-token offsets),
// written before it is read.
ILVLM_API int codebook_pool_bwd_dq(const void* q, const void* sd, const void* keep,
                                   const void* amax, const void* g, void* out, void* scratch,
                                   int batch, int tokens, int depth, int codes, float coeff,
                                   void* stream) {
  (void)q;
  if (bad_shape(batch, tokens, depth, codes)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int pair_ld = (codes + 1) / 2 * 2;       // 16-byte rows
  const int off_ld = (tokens + 1 + 3) / 4 * 4;
  int2* const route_buf = static_cast<int2*>(scratch);
  int* const offsets = reinterpret_cast<int*>(route_buf + size_t(batch) * pair_ld);
  codebook_pool_dq_route_kernel<<<batch, kRouteWarps * 32, 0, s>>>(
      static_cast<const float*>(keep), static_cast<const int*>(amax),
      static_cast<const float*>(g), route_buf, offsets, tokens, codes, coeff, pair_ld, off_ld);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  static unsigned long long smem_set = 0;
  const size_t staged = size_t(codes) * kGatherCols * sizeof(__nv_bfloat16) +
                        2 * (size_t(pair_ld) * sizeof(int2) + size_t(off_ld) * sizeof(int));
  err = allow_smem(codebook_pool_dq_gather_kernel<true>, kStagedBytes, smem_set);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = sm_count(sms);
  if (err != cudaSuccess) return err;
  const int slices = depth / kGatherCols;
  const int batch_tiles = max(1, min(batch, min(65535, sms / slices)));
  const dim3 grid(slices, batch_tiles);
  if (staged <= kStagedBytes) {
    codebook_pool_dq_gather_kernel<true><<<grid, kGatherThreads, staged, s>>>(
        static_cast<const __nv_bfloat16*>(sd), route_buf, offsets,
        static_cast<__nv_bfloat16*>(out), batch, tokens, depth, codes, pair_ld, off_ld);
  } else {
    codebook_pool_dq_gather_kernel<false><<<grid, kGatherThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(sd), route_buf, offsets,
        static_cast<__nv_bfloat16*>(out), batch, tokens, depth, codes, pair_ld, off_ld);
  }
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
