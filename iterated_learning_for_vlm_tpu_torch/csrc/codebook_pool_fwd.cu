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
// the max as 0, not -inf: that is the reference semantics. Codes past N are
// never written. The temperature is a run-time argument, so a decaying
// schedule costs no rebuild. Any T >= 1.
//
// What bounds it on an H100: the work is one [B T, D] x [D, N] bf16 product
// (B = 256, T = 49, D = 512, N = 4096: 53 GFLOP, 0.053 ms at the tensor-core
// peak) followed by a max over each sample's T rows; the unfused path writes
// and rereads the [B, T, N] fp32 product. Design:
// - A block owns 128 codes (64 at D > 512) and a contiguous range of
//   samples. Its codebook tile, all D columns, is staged once into shared
//   memory and stays there (128 KB), so the codebook crosses L2 once per
//   sample range (4 times at B = 256), not once per row.
// - The samples' q rows stream through a four-stage cp.async ring, 128 rows
//   and 64 columns of D a stage (with the rows' keep at the last depth
//   chunk): each staged q tile serves every code of the block. The rows are
//   packed (sample after sample, no padding to 16), so T = 49 costs 49 rows
//   of tensor work, not 64.
// - Two warpgroups take the product sd q^T on `wgmma` (m64nNk16, both
//   operands read from shared memory, fp32 accumulators in registers): at
//   D <= 512 each owns 64 codes and all 128 rows of a step (N = 128); at
//   D > 512 both own the block's 64 codes and each its half of the samples
//   (N = 64). Both tiles are kept in the no-swizzle core-matrix layout (8
//   rows x 16 bytes contiguous), which the copies write directly.
// - A thread's accumulators hold 2 codes x N / 4 rows. After the last depth
//   chunk of a step, each warp takes the segmented max: for every sample with
//   rows in the step, the max over the thread's rows of it (increasing t,
//   strict >; only the n8 tiles that meet the sample are read), merged into
//   the thread's running (best, arg) when the sample began in an earlier
//   step (strict >, so the earlier t keeps a tie). When the sample's last row
//   is in the step, the four lanes that share a code merge by shuffles (ties
//   to the smaller t) and one writes it out. The max is taken over acc *
//   scale * keep; the division by the (positive) temperature keeps the
//   order, so it is applied to the winner alone.
// On the card the loop's three parts, waiting for the ring, the products and
// the epilogue, each take about a third of the time and run in turn, one
// barrier an item (PERF.md); overlapping them is the next step.
#include "common.cuh"

namespace {

using namespace ilvlm;

constexpr int kThreads = 256;     // two warpgroups
constexpr int kStageRows = 128;   // q rows a stage (the step of both groups)
constexpr int kBlockK = 64;       // depth staged per ring stage
constexpr int kStages = 4;
constexpr int kStageBytes = kStageRows * kBlockK * 2;
constexpr int kCore = 128;        // bytes of one 8 x 8 bf16 core matrix
constexpr int kMaxDepth = 1024;
static_assert(kStageRows <= kThreads && kStageRows * (kBlockK / 8) % kThreads == 0,
              "a stage is a whole number of 16-byte copies a thread, one keep a thread");

// Byte offset of 16-byte piece (row r, column chunk c) in a core-matrix tile
// whose 8-row groups are `group_bytes` apart (column chunks 128 bytes apart).
__device__ __forceinline__ int core_offset(int r, int c, int group_bytes) {
  return (r >> 3) * group_bytes + c * kCore + (r & 7) * 16;
}

// A wgmma shared-memory descriptor of a K-major, no-swizzle tile: `lbo` bytes
// between the two core matrices of a k16 step, `sbo` bytes between 8-row
// groups.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return uint64_t((a & 0x3FFFF) >> 4) | (uint64_t((lbo & 0x3FFFF) >> 4) << 16) |
         (uint64_t((sbo & 0x3FFFF) >> 4) << 32);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// One k16 step of a warpgroup's m64nN product: d (+)= A B^T, A [64 x 16] and
// B [N x 16] both K-major in shared memory (`desc_a`, `desc_b`); d is not
// read when `accumulate` is 0. Thread (warp w, lane l) holds rows 16 w + l / 4
// (+ 8) and columns 8 j + 2 (l % 4) (+ 1) as d[4 j + ...], as an mma.sync
// C fragment per n8 tile.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a,
                                                 uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t desc_a,
                                                 uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_step(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                           int accumulate) {
  if constexpr (N == 128) {
    wgmma_m64n128k16(d, desc_a, desc_b, accumulate);
  } else {
    wgmma_m64n64k16(d, desc_a, desc_b, accumulate);
  }
}

size_t fwd_smem_bytes(int depth, int block_codes) {
  return size_t(block_codes) * depth * sizeof(__nv_bfloat16) + size_t(kStages) * kStageBytes +
         size_t(kStages) * kStageRows * sizeof(float);
}

// kRowGroups = 1: 128 codes, each warpgroup 64 of them over all 128 rows of a
// step; kRowGroups = 2: 64 codes, warpgroup k over rows 64 k .. 64 k + 63 of
// a step, a walk over its own half of the block's samples.
template <int kRowGroups>
__global__ void __launch_bounds__(kThreads, 1)
codebook_pool_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ sd,
                         const float* __restrict__ keep,
                         float* __restrict__ pooled, int* __restrict__ amax, int batch,
                         int tokens, int depth, int codes, float scale, float temperature) {
  constexpr int kN = kStageRows / kRowGroups;  // rows of a warpgroup's step
  constexpr int kNT = kN / 8;
  constexpr int kBlockN = 128 / kRowGroups;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* const cb = smem;                               // [kBlockN x depth], core layout
  unsigned char* const ring = smem + size_t(kBlockN) * depth * 2;  // [kStages][128 x 64]
  float* const keep_ring = reinterpret_cast<float*>(ring + kStages * kStageBytes);
  const int cb_group = depth * 16;        // bytes between 8-code groups
  const int q_group = kBlockK / 8 * kCore;  // bytes between 8-row groups of a stage

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wg = warp >> 2;
  const int w4 = warp & 3;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int n0 = blockIdx.x * kBlockN;
  const int rg = kRowGroups == 1 ? 0 : wg;
  const int code0 = kRowGroups == 1 ? wg * 64 : 0;  // this warpgroup's first code

  // This block's samples [b0, b1); row group k takes [first(k), first(k + 1)).
  // Rows are global: row b * T + t of q (and of keep).
  const int b0 = int((long long)batch * blockIdx.y / gridDim.y);
  const int b1 = int((long long)batch * (blockIdx.y + 1) / gridDim.y);
  auto first = [&](int k) { return (long long)(b0 + (b1 - b0) * k / kRowGroups) * tokens; };
  int steps = 0;  // of the longest row group: every warp runs the same items
#pragma unroll
  for (int k = 0; k < kRowGroups; ++k) {
    steps = max(steps, int((first(k + 1) - first(k) + kN - 1) / kN));
  }
  const int kchunks = depth / kBlockK;
  const int total = steps * kchunks;

  // q rows of ring item i (step i / kchunks, depth chunk i % kchunks) into
  // its stage, row group k in stage rows kN k and on; rows past a group's end
  // are zero-filled and read nothing. The last depth chunk also brings the
  // rows' keep (thread j the keep of stage row j).
  auto stage_q = [&](int i) {
    const int st = i / kchunks;
    const int kc = i - st * kchunks;
    unsigned char* const dst = ring + (i % kStages) * kStageBytes;
#pragma unroll
    for (int j = 0; j < kStageRows * (kBlockK / 8) / kThreads; ++j) {
      const int idx = threadIdx.x + j * kThreads;
      const int r = idx / (kBlockK / 8);
      const int c = idx % (kBlockK / 8);
      const int k = r / kN;
      const long long row = first(k) + (long long)st * kN + (r - k * kN);
      const bool live = row < first(k + 1);
      cp_async16(dst + core_offset(r, c, q_group),
                 q + (live ? row : 0) * depth + kc * kBlockK + c * 8, live ? 16 : 0);
    }
    if (keep != nullptr && kc == kchunks - 1 && threadIdx.x < kStageRows) {
      const int k = threadIdx.x / kN;
      const long long row = first(k) + (long long)st * kN + threadIdx.x % kN;
      const bool live = row < first(k + 1);
      cp_async4(keep_ring + (i % kStages) * kStageRows + threadIdx.x, keep + (live ? row : 0),
                live ? 4 : 0);
    }
  };

  // the resident codebook tile (codes past N zero-filled) joins the first group
  const int vecs = depth / 8;
  for (int idx = threadIdx.x; idx < kBlockN * vecs; idx += kThreads) {
    const int r = idx / vecs;
    const int c = idx - r * vecs;
    const bool live = n0 + r < codes;
    cp_async16(cb + core_offset(r, c, cb_group), sd + size_t(live ? n0 + r : 0) * depth + c * 8,
               live ? 16 : 0);
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) stage_q(s);
    cp_async_commit();
  }

  const long long my_beg = first(rg);
  const long long my_end = first(rg + 1);
  const unsigned char* const cbw = cb + (code0 >> 3) * cb_group;  // this warpgroup's codes

  float acc[kN / 2] = {};
  // this thread's running max over its rows of the sample that continues
  // from the previous step, for each of its two codes (h)
  float run_best[2] = {-INFINITY, -INFINITY};
  int run_arg[2] = {tokens, tokens};

  for (int i = 0; i < total; ++i) {
    cp_async_wait<kStages - 2>();
    fence_proxy_async();  // the copies are read by wgmma (the async proxy)
    __syncthreads();      // item i (and the codebook) landed; stage i - 1 is free
    if (i + kStages - 1 < total) stage_q(i + kStages - 1);
    cp_async_commit();

    const int st = i / kchunks;
    const int kc = i - st * kchunks;
    const long long r0 = my_beg + (long long)st * kN;  // global row of local row 0
    const int rows = int(min((long long)kN, max(my_end - r0, 0ll)));  // live rows
    if (rows == 0) continue;  // this row group is done (the other is not)
    const unsigned char* const qs = ring + (i % kStages) * kStageBytes + (rg * kN >> 3) * q_group;

    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBlockK / 16; ++ks) {
      wgmma_step<kN>(acc, smem_desc(cbw + (kc * kBlockK / 8 + 2 * ks) * kCore, kCore, cb_group),
                     smem_desc(qs + 2 * ks * kCore, kCore, q_group), kc > 0 || ks > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    if (kc != kchunks - 1) continue;

    // Epilogue of the step. This thread holds rows 8 nt + 2 tig + e (in
    // increasing order of (nt, e)) of codes 16 w4 + 8 h + g of its
    // warpgroup's, as acc[4 nt + 2 h + e]. First v = acc * scale * keep.
    const float* const ks_row = keep_ring + (i % kStages) * kStageRows + rg * kN;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float kv = keep != nullptr ? ks_row[nt * 8 + 2 * tig + e] : 1.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v = acc[4 * nt + 2 * h + e] * scale;
          if (keep != nullptr) v = v * kv;
          acc[4 * nt + 2 * h + e] = v;
        }
      }
    const int s_lo = int(r0 / tokens);
    const int s_hi = int((r0 + rows - 1) / tokens);
    for (int s = s_lo; s <= s_hi; ++s) {
      const long long s_beg = (long long)s * tokens;
      const int lo = int(max(s_beg - r0, 0ll));  // local rows of s: [lo, hi)
      const int hi = int(min(s_beg + tokens - r0, (long long)rows));
      const int t0 = int(r0 - s_beg);  // t of local row 0
      const bool continues = s_beg < r0;  // rows of s came in an earlier step
      const bool ends = s_beg + tokens <= r0 + rows;
      float best[2] = {-INFINITY, -INFINITY};
      int arg[2] = {tokens, tokens};
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        if (nt * 8 + 8 <= lo || nt * 8 >= hi) continue;  // the same for the whole warp
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int lr = nt * 8 + 2 * tig + e;
          if (lr < lo || lr >= hi) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float v = acc[4 * nt + 2 * h + e];
            if (v > best[h]) {
              best[h] = v;
              arg[h] = t0 + lr;
            }
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!continues || best[h] > run_best[h]) {
          run_best[h] = best[h];
          run_arg[h] = arg[h];
        }
        if (!ends) continue;
        float bv = run_best[h];
        int ba = run_arg[h];
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          const float ob = __shfl_xor_sync(0xffffffffu, bv, off);
          const int oa = __shfl_xor_sync(0xffffffffu, ba, off);
          if (ob > bv || (ob == bv && oa < ba)) {
            bv = ob;
            ba = oa;
          }
        }
        const int n = n0 + code0 + w4 * 16 + h * 8 + g;
        if (tig == 0 && n < codes) {
          pooled[size_t(s) * codes + n] = bv / temperature;
          amax[size_t(s) * codes + n] = ba;
        }
      }
    }
  }
}

template <int kRowGroups>
cudaError_t launch(const void* q, const void* sd, const void* keep, void* pooled, void* amax,
                   int batch, int tokens, int depth, int codes, float scale, float temperature,
                   cudaStream_t stream) {
  static unsigned long long smem_set = 0;
  constexpr int kBlockN = 128 / kRowGroups;
  const size_t smem = fwd_smem_bytes(depth, kBlockN);
  // the cap is raised once per device, to the largest depth this instance takes
  cudaError_t err = allow_smem(codebook_pool_fwd_kernel<kRowGroups>,
                               fwd_smem_bytes(kRowGroups == 1 ? 512 : kMaxDepth, kBlockN),
                               smem_set);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = sm_count(sms);
  if (err != cudaSuccess) return err;
  // one resident block an SM: split the batch so the grid fills the SMs once
  const int code_tiles = (codes + kBlockN - 1) / kBlockN;
  const int batch_tiles = max(1, min(batch, min(65535, sms / code_tiles)));
  const dim3 grid(code_tiles, batch_tiles);
  codebook_pool_fwd_kernel<kRowGroups><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(sd),
      static_cast<const float*>(keep), static_cast<float*>(pooled), static_cast<int*>(amax),
      batch, tokens, depth, codes, scale, temperature);
  return cudaGetLastError();
}

}  // namespace

// q: [batch, tokens, depth] bf16; sd: [codes, depth] bf16; keep: [batch, tokens]
// fp32 (1 real, 0 pad) or null; pooled: [batch, codes] fp32; amax: [batch,
// codes] int32. All contiguous and 16-byte aligned; depth a multiple of 64, at
// most 1024; any tokens >= 1. Launches on `stream`, does not synchronise.
ILVLM_API int codebook_pool_fwd(const void* q, const void* sd, const void* keep, void* pooled,
                                void* amax, int batch, int tokens, int depth, int codes,
                                float scale, float temperature, void* stream) {
  if (batch < 1 || tokens < 1 || depth < kBlockK || depth % kBlockK != 0 || depth > kMaxDepth ||
      codes < 1) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (depth <= 512) {
    return launch<1>(q, sd, keep, pooled, amax, batch, tokens, depth, codes, scale, temperature, s);
  }
  return launch<2>(q, sd, keep, pooled, amax, batch, tokens, depth, codes, scale, temperature, s);
}
