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
// - dsd gathers B * N rows of q, ~1.07 GB of bf16 at T = 49, from a q of only
//   12.8 MB (image T = 49) or 8.4 MB (text T = 32). A route kernel first
//   writes each (b, n)'s (token, weight) pair, w = g c keep[t], code tile by
//   code tile. The gather gives a block a tile of 256 codes x 64 columns, one
//   consumer thread a code with its 64 fp32 sums in registers, and walks the
//   batch rows in order through a ring of stages in shared memory that one
//   producer thread fills: a stage holds several batch rows' slices q[b, :,
//   64 columns] (8 at T <= 32, 5 at T = 49) by one 2-D tensor copy (TMA) and
//   their pairs by one bulk copy, with a full and an empty mbarrier, so no
//   block-wide barrier stops the consumers. Every gathered row is read from
//   shared memory, not L2, in an order that keeps a quarter-warp's eight
//   16-byte reads in eight different bank groups whatever the tokens. L2
//   serves each block its slices and pairs, (N / 256) |q| + (D / 64) |pairs|
//   (~270 MB at T = 49). What bounds it (PERF.md): the copy
//   operations a batch row needs, then the bf16 widening and multiply-adds
//   (~0.04 ms of issue); the shared-memory floor of any such gather is
//   1.07 GB at 128 bytes a clock on 132 SMs, ~0.035 ms. Copies issued by
//   every thread, or one copy per 128-byte row, cost more than the whole
//   first version of this kernel. Past T = 888 the ring does not fit and the
//   rows are read in place from L2 (same kernel, another instance, chosen
//   from T before the launch). Each output element is summed by one thread,
//   b in order, fmaf(w, q, acc) from 0, as the first version of this kernel
//   summed it, so both give the same bits.
#include <cuda.h>
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
constexpr int kDsdCodes = 256;  // codes of a block's tile, one consumer thread each
constexpr int kDsdCols = 64;    // columns of its slice: 128-byte rows of bf16
constexpr int kDsdConsumerWarps = kDsdCodes / 32;
constexpr int kDsdThreads = kDsdCodes + 32;  // and one producer warp
constexpr int kDsdSlots = kDsdCols / kVec;   // 16-byte chunks a thread sums
constexpr int kDsdRowBytes = kDsdCols * 2;
constexpr int kDsdPairBytes = kDsdCodes * sizeof(int2);  // a tile's (token, weight) pairs
constexpr int kDsdMaxBox = 256;  // rows of one tensor copy (the copy engine's bound)
constexpr int kDsdMaxRows = 8;   // batch rows a stage holds
constexpr size_t kDsdSmemBytes = 227 * 1024;

// The (token, weight) pair of every (b, n), code tile by code tile:
// pairs[(n / 256) B + b][n % 256], so a tile's pairs of consecutive batch
// rows are contiguous. t = amax[b, n] and w = g c keep[b, t], w formed in the
// order the first version of dsd formed it; (0, 0) for a code past N or a
// token out of range (an amax the forward never writes).
__global__ void codebook_pool_dsd_route_kernel(const float* __restrict__ keep,
                                               const int* __restrict__ amax,
                                               const float* __restrict__ g,
                                               int2* __restrict__ pairs, int batch, int tokens,
                                               int codes, float coeff, long long count) {
  const long long i = blockIdx.x * 256ll + threadIdx.x;
  if (i >= count) return;
  const long long tile_b = i / kDsdCodes;
  const int b = int(tile_b % batch);
  const int n = int(tile_b / batch) * kDsdCodes + int(i % kDsdCodes);
  int tok = 0;
  float w = 0.f;
  if (n < codes) {
    const size_t j = size_t(b) * codes + n;
    const int t = amax[j];
    if (t >= 0 && t < tokens) {
      tok = t;
      w = g[j] * coeff;
      if (keep != nullptr) w = w * keep[size_t(b) * tokens + t];
    }
  }
  pairs[i] = make_int2(tok, __float_as_int(w));
}

// How a stage holds the slices: `rows` batch rows (samples), brought by
// `count` tensor copies of `box` rows each (count * box >= rows * T; rows
// past the stage's samples are the next ones', or zeros past the tensor,
// and are never read). Up to T = 32 a stage holds 8 batch rows in one copy,
// 5 at T = 49, 3 at T = 77; past T = 256 one batch row in several copies.
struct DsdStage {
  int rows, box, count;
};

__host__ __device__ inline DsdStage dsd_stage(int tokens) {
  if (tokens <= kDsdMaxBox) {
    const int rows = min(kDsdMaxRows, kDsdMaxBox / tokens);
    return {rows, rows * tokens, 1};
  }
  const int count = (tokens + kDsdMaxBox - 1) / kDsdMaxBox;
  return {1, (tokens + count - 1) / count, count};
}

// Bytes of one ring stage, 128-byte aligned: (staged) the slices as the
// tensor copies land them, then the tile's pairs of the stage's batch rows.
__host__ __device__ inline size_t dsd_stage_bytes(int tokens, bool staged) {
  const DsdStage st = staged ? dsd_stage(tokens) : DsdStage{1, 0, 0};
  const size_t q_bytes = size_t(st.box) * st.count * kDsdRowBytes;
  return (q_bytes + size_t(st.rows) * kDsdPairBytes + 127) / 128 * 128;
}

// Shared memory of a ring of `stages`: the stages, then a full and an empty
// barrier for each.
__host__ __device__ inline size_t dsd_smem_bytes(int stages, int tokens, bool staged) {
  return stages * dsd_stage_bytes(tokens, staged) + 2 * stages * sizeof(uint64_t);
}

// One 2-D tensor copy of a box of the tensor `map` at (column c, row r) into
// shared memory, its bytes counted on `bar`.
__device__ __forceinline__ void tensor_copy_g2s(void* smem, const CUtensorMap& map, int c, int r,
                                                uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(smem_addr(smem)), "l"(reinterpret_cast<uint64_t>(&map)), "r"(smem_addr(bar)),
      "r"(c), "r"(r)
      : "memory");
}

// Block (code tile x, column slice y). One producer thread fills a ring of
// kStages stages, stage i (batch rows i R .. i R + R - 1, R = dsd_stage().rows)
// in place i % kStages: the slices by tensor copies of `q_map` (q as [B T, D]
// rows, boxes of 64 columns; kStaged) and the tile's pairs of those rows by
// one bulk copy; the stage's full barrier completes when all of it has
// landed. Consumer thread i owns code n0 + i and the slice's 64 columns
// (eight 16-byte chunks); its slot k holds the chunk (i + k) % 8, so at each
// k a quarter-warp's eight lanes read eight different chunks (bank groups)
// of their rows, whatever the tokens. Each consumer warp releases a stage on
// its empty barrier once it is done with it. Without kStaged (T too large for
// the ring) the rows are read in place.
template <int kStages, bool kStaged>
__global__ void __launch_bounds__(kDsdThreads, 1)
codebook_pool_bwd_dsd_kernel(const __grid_constant__ CUtensorMap q_map,
                             const __nv_bfloat16* __restrict__ q,
                             const int2* __restrict__ pairs, __nv_bfloat16* __restrict__ dsd,
                             int batch, int tokens, int depth, int codes) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int n0 = blockIdx.x * kDsdCodes;
  const int c0 = blockIdx.y * kDsdCols;
  const DsdStage geo = kStaged ? dsd_stage(tokens) : DsdStage{1, 0, 0};
  const int stages = (batch + geo.rows - 1) / geo.rows;
  const size_t stage_bytes = dsd_stage_bytes(tokens, kStaged);
  const size_t q_bytes = size_t(geo.box) * geo.count * kDsdRowBytes;
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem + kStages * stage_bytes);
  uint64_t* const empty = full + kStages;
  auto stage = [&](int i) { return smem + (i % kStages) * stage_bytes; };
  auto q_s = [&](unsigned char* st) { return reinterpret_cast<__nv_bfloat16*>(st); };
  auto pairs_s = [&](unsigned char* st) { return reinterpret_cast<int2*>(st + q_bytes); };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);  // the producer's expect_tx
      mbar_init(&empty[s], kDsdConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kDsdCodes) {  // the producer warp; one thread issues the copies
    if (lane != 0) return;
    const int2* const tile_pairs = pairs + size_t(blockIdx.x) * batch * kDsdCodes;
    for (int i = 0; i < stages; ++i) {
      const int s = i % kStages;
      if (i >= kStages) mbar_wait(&empty[s], (i / kStages - 1) & 1);  // its last use was read
      unsigned char* const st = stage(i);
      const int b0 = i * geo.rows;
      const int rows = min(geo.rows, batch - b0);
      mbar_arrive_expect_tx(&full[s], uint32_t(q_bytes) + uint32_t(rows) * kDsdPairBytes);
      if (kStaged) {
        for (int c = 0; c < geo.count; ++c) {
          tensor_copy_g2s(q_s(st) + c * geo.box * kDsdCols, q_map, c0, b0 * tokens + c * geo.box,
                          &full[s]);
        }
      }
      bulk_copy_g2s(pairs_s(st), tile_pairs + size_t(b0) * kDsdCodes, rows * kDsdPairBytes,
                    &full[s]);
    }
    return;
  }

  // Consumers. Codes of the tile past N sum zeros and are never written.
  int chunk[kDsdSlots];  // the column chunk (of 8) each slot sums
#pragma unroll
  for (int k = 0; k < kDsdSlots; ++k) chunk[k] = (tid + k) % kDsdSlots;
  float acc[kDsdSlots][kVec];
#pragma unroll
  for (int k = 0; k < kDsdSlots; ++k)
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[k][e] = 0.f;

  for (int i = 0; i < stages; ++i) {
    const int s = i % kStages;
    mbar_wait(&full[s], (i / kStages) & 1);
    unsigned char* const st = stage(i);
    const int rows = min(geo.rows, batch - i * geo.rows);
    for (int r = 0; r < rows; ++r) {
      const int2 pr = pairs_s(st)[r * kDsdCodes + tid];
      const float w = __int_as_float(pr.y);
      const __nv_bfloat16* const row =
          kStaged ? q_s(st) + (r * tokens + pr.x) * kDsdCols
                  : q + (size_t(i * geo.rows + r) * tokens + pr.x) * depth + c0;
      uint4 v[kDsdSlots];
#pragma unroll
      for (int k = 0; k < kDsdSlots; ++k) {
        v[k] = *reinterpret_cast<const uint4*>(row + chunk[k] * kVec);
      }
#pragma unroll
      for (int k = 0; k < kDsdSlots; ++k) fma_bf16x8(acc[k], w, v[k]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // the warp is done with the stage
  }

  const int n = n0 + tid;
  if (n < codes) {  // codes past N are never written
#pragma unroll
    for (int k = 0; k < kDsdSlots; ++k) {
      uint4 out;
      __nv_bfloat162* const h = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
      for (int e = 0; e < kVec / 2; ++e) h[e] = __floats2bfloat162_rn(acc[k][2 * e], acc[k][2 * e + 1]);
      *reinterpret_cast<uint4*>(dsd + size_t(n) * depth + c0 + chunk[k] * kVec) = out;
    }
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link to
// the driver library).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

cudaError_t encode_tiled(EncodeTiled& fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || ptr == nullptr) return cudaErrorNotSupported;
    cached = reinterpret_cast<EncodeTiled>(ptr);
  }
  fn = cached;
  return cudaSuccess;
}

// q [batch * tokens, depth] bf16 as boxes of dsd_stage().box rows x 64
// columns, no swizzle: a box lands as its rows of 128 bytes.
cudaError_t dsd_q_map(CUtensorMap& map, const __nv_bfloat16* q, int batch, int tokens,
                      int depth) {
  EncodeTiled encode = nullptr;
  const cudaError_t err = encode_tiled(encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {cuuint64_t(depth), cuuint64_t(batch) * tokens};
  const cuuint64_t strides[1] = {cuuint64_t(depth) * sizeof(__nv_bfloat16)};
  const cuuint32_t box[2] = {cuuint32_t(kDsdCols), cuuint32_t(dsd_stage(tokens).box)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                              const_cast<__nv_bfloat16*>(q), dims, strides, box, elem,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int kStages, bool kStaged>
cudaError_t launch_dsd(const __nv_bfloat16* q, const int2* pairs, __nv_bfloat16* dsd, int batch,
                       int tokens, int depth, int codes, cudaStream_t stream) {
  static unsigned long long smem_set = 0;
  cudaError_t err = allow_smem(codebook_pool_bwd_dsd_kernel<kStages, kStaged>, kDsdSmemBytes,
                               smem_set);
  if (err != cudaSuccess) return err;
  CUtensorMap map = {};
  if (kStaged) {
    err = dsd_q_map(map, q, batch, tokens, depth);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((codes + kDsdCodes - 1) / kDsdCodes, depth / kDsdCols);
  codebook_pool_bwd_dsd_kernel<kStages, kStaged>
      <<<grid, kDsdThreads, dsd_smem_bytes(kStages, tokens, kStaged), stream>>>(
          map, q, pairs, dsd, batch, tokens, depth, codes);
  return cudaGetLastError();
}

// The ring's depth for T tokens: the most of 8, 6, 4 and 2 stages that fit,
// else 0 (the slice rows are read in place).
int dsd_stages(int tokens) {
  constexpr int kRing[] = {8, 6, 4, 2};
  for (int stages : kRing) {
    if (dsd_smem_bytes(stages, tokens, true) <= kDsdSmemBytes) return stages;
  }
  return 0;
}

constexpr int kMaxDepth = 1024;  // the wrappers' bound (MAX_DEPTH)

bool bad_shape(int batch, int tokens, int depth, int codes) {
  return batch < 1 || batch > 65535 || tokens < 1 || depth < kGatherCols ||
         depth % kGatherCols != 0 || depth > kMaxDepth || codes < 1;
}

}  // namespace

// Every entry takes q: [batch, tokens, depth] bf16; sd: [codes, depth] bf16;
// keep: [batch, tokens] fp32 or null; amax: [batch, codes] int32 (the
// forward's argmax); g: [batch, codes] fp32, the gradient of the pooled
// logits; out: dq [batch, tokens, depth] or dsd [codes, depth], bf16. All
// contiguous and 16-byte aligned; depth a multiple of 16 (of 64 for dsd), at
// most 1024; any tokens >= 1. coeff = D^-1/2 / temperature. Launch on `stream`, no sync.

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

// dsd. scratch: int32 [2 * batch * codes rounded up to a multiple of 256]
// or more (the (token, weight) pairs, code tile by code tile), written
// before it is read.
ILVLM_API int codebook_pool_bwd_dsd(const void* q, const void* sd, const void* keep,
                                    const void* amax, const void* g, void* out, void* scratch,
                                    int batch, int tokens, int depth, int codes, float coeff,
                                    void* stream) {
  (void)sd;
  if (bad_shape(batch, tokens, depth, codes) || depth % kDsdCols != 0 ||
      (codes + kDsdCodes - 1) / kDsdCodes > 65535) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int2* const pairs = static_cast<int2*>(scratch);
  const long long count = (long long)batch * ((codes + kDsdCodes - 1) / kDsdCodes) * kDsdCodes;
  codebook_pool_dsd_route_kernel<<<unsigned((count + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(keep), static_cast<const int*>(amax),
      static_cast<const float*>(g), pairs, batch, tokens, codes, coeff, count);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  auto* op = static_cast<__nv_bfloat16*>(out);
  switch (dsd_stages(tokens)) {
    case 8: return launch_dsd<8, true>(qp, pairs, op, batch, tokens, depth, codes, s);
    case 6: return launch_dsd<6, true>(qp, pairs, op, batch, tokens, depth, codes, s);
    case 4: return launch_dsd<4, true>(qp, pairs, op, batch, tokens, depth, codes, s);
    case 2: return launch_dsd<2, true>(qp, pairs, op, batch, tokens, depth, codes, s);
    default: return launch_dsd<8, false>(qp, pairs, op, batch, tokens, depth, codes, s);
  }
}
