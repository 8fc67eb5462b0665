// K4-bwd: backward of Swin window attention, with the bias's gradient.
//
// Replaces no TPU kernel (see window_attention_fwd.cu). For each window w
// and head h it recomputes the softmax from q, k and the fp32 bias
// bias[w % nbias, h] as K4-fwd does, then, as K2-bwd does
// (tiny_attention_bwd.cu),
//
//   dv = p^T do          p rounded to bf16, fp32 sums
//   dp = do v^T          fp32
//   ds = p (dp - sum_j dp p)   fp32 from the unrounded p, then rounded to bf16
//   dq = ds k * scale,   dk = ds^T q * scale   fp32 sums
//
// and writes dq | dk | dv as bf16 into the [W, N, 3C] layout the qkv
// projection's gradient reads. The bias's gradient is the fp32 ds itself,
// summed over the windows: that sum is the gradient of the head's
// relative-position bias (the shift mask is a constant), which the wrapper
// then reduces onto the bias table.
//
// What bounds it on an H100: a (window, head) is 10 N^2 32 flops over
// 8 N 32 bf16 values (q, k, v, do in; dq, dk, dv out): at N = 144, 6.6 MFLOP
// over 73.7 KB, 90 FLOP/B, so bytes; but, as in the forward, a window's
// softmax recompute and six dependent rounds of mma take a warp longer than
// its loads, so the kernel must keep the loads off the warps' path. Walking
// a block's windows in turn did not: the next window's tiles waited for the
// current one's stores, and the softmax read the bias from L2 entry by
// entry. The design:
// - a block owns one head and one bias slice (w % nbias) and walks a fixed,
//   ascending set of the slice's windows (window_attention.cuh walk_window,
//   the wrapper's walk_plan), as the forward does;
// - the whole block stages the slice's bias into shared memory once (fp32
//   rows 16 kT + 8 words apart: conflict-free float2 reads in the softmax);
// - the block's last warp is a producer: it fills a two-stage ring with q,
//   k, v and do by cp.async (and, in the cosine form, the rows' inverse
//   norms), signalled on mbarriers (Ring);
// - per window, K2-bwd's two passes over kT compute warps: pass 1, a warp
//   per 16 query rows: q k^T on the tensor cores, the softmax in registers,
//   D = sum_j dp p from the fp32 p and dp = do v^T, ds in fp32, p rounded to
//   bf16 into shared memory, dq = ds k from the registers; pass 2, a warp
//   per 16 key rows: dv = p^T do, then, once ds (bf16, from pass 1's
//   registers) has replaced p in the same tile, dk = ds^T q, their A
//   fragments read transposed by ldmatrix.trans. The hand-offs of that tile
//   are split barriers (WarpBarrier): a warp arrives when it is done and
//   waits only when it needs the others, so dq, the dv store and the next
//   window's first half run across them;
// - the bias's gradient is the fp32 ds summed over the block's windows in
//   its fixed order, in registers: each pass-1 thread adds the ds values its
//   C fragments hold to the slots only it holds, and writes them once at the
//   end as the block's partial [N, N]; the wrapper sums the partials. No
//   float atomics: two calls agree bit for bit.
// Shared memory at N = 144: 87.6 KB of bias, 2 x 46.1 KB of tiles and 43.8
// KB of p or ds, one block of 10 warps an SM. What that budget gave up: the
// [N, N] fp32 bias-gradient tile (83 KB) left shared memory for registers
// (at the 168 a thread that 10 warps allow, the kernel spills: a few hundred
// bytes a thread pass through local memory once a window), p and ds share
// one tile, and pass 1 computes dp = do v^T twice, a pair of key tiles at a
// time (once for D, once for ds), so that no thread holds a whole row of dp
// beside p and its share of the bias gradient. A window's arithmetic does
// not depend on the walk: dqkv has the same bits whatever the plan, and so
// has the bias gradient of a plan with a window a block.
//
// The cosine form (window_attention_cos_bwd): the logits are
// s_h rq_i rk_j (q_i . k_j) + bias, with rq, rk the rows' inverse norms and
// s_h the head's scale (window_attention_fwd.cu). With g = ds (fp32) the
// unit rows' gradients are s_h sum_j g_ij khat_j and s_h sum_i g_ij qhat_i;
// the kernel takes them as products of the raw bf16 tiles with ds scaled in
// fp32 before its rounding (by rk_j along a row for dq, by rq_i down a
// column for dk: pass 1's two register copies of ds), then maps
// each row back through the normalisation (project32). The scale's
// gradient is sum_ij g_ij cos_ij = sum_i qhat_i . (sum_j g_ij khat_j), the
// dot products project32 takes anyway; each block sums its own in a fixed
// order and writes one value a head, which the wrapper sums over the
// blocks, as the bias's gradient.
#include "window_attention.cuh"

namespace {

using namespace ilvlm;
using namespace ilvlm::win;

template <int kT>
__host__ __device__ constexpr int p_ld() {
  return 16 * kT + 8;  // bf16 row stride of the p / ds tile
}

template <int kT, bool kCos>
constexpr size_t bwd_smem_bytes() {
  return bias_bytes<kT>() +
         (size_t(2) * 4 * 16 * kT * kLdW + size_t(16 * kT) * p_ld<kT>()) *
             sizeof(__nv_bfloat16) +
         (kCos ? size_t(2) * 2 * 16 * kT * sizeof(float) : 0) + 8 * sizeof(uint64_t) +
         (kCos ? 16 * sizeof(float) : 0);
}

// One head's walk over its bias slice's windows, in either form (see the top
// of this file); the cosine form also writes its block's scale gradient.
template <int kT, bool kCos>
__device__ __forceinline__ void bwd_walk(unsigned char* smem,
                                         const __nv_bfloat16* __restrict__ qkv,
                                         const float* __restrict__ bias,
                                         const __nv_bfloat16* __restrict__ dout,
                                         __nv_bfloat16* __restrict__ dqkv,
                                         float* __restrict__ dbias_part, int windows, int n,
                                         int heads, int nbias, int per, float scale,
                                         const float* __restrict__ scales,
                                         float* __restrict__ dscale_part) {
  constexpr int kS16 = 16 * kT;
  constexpr int kNt = 2 * kT;
  constexpr int kLdp = p_ld<kT>();
  constexpr int kTile = kS16 * kLdW;
  constexpr int kThreads = kT * 32;  // the compute warps'
  float* const bs = reinterpret_cast<float*>(smem);
  __nv_bfloat16* const tiles = reinterpret_cast<__nv_bfloat16*>(bs + kS16 * bias_ld<kT>());
  __nv_bfloat16* const pd = tiles + 2 * 4 * kTile;  // p, then ds: [query][key]
  // each stage's inverse norms (the cosine form): q rows, then k rows
  float* const norms = reinterpret_cast<float*>(pd + kS16 * kLdp);
  uint64_t* const bars = reinterpret_cast<uint64_t*>(norms + (kCos ? 2 * 2 * kS16 : 0));
  float* const warp_sums = reinterpret_cast<float*>(bars + 8);  // the cosine form's
  const Ring<2> ring{bars, bars + 2};
  ring.init(kT);
  // the hand-offs of pd: every p row written, every warp done reading p,
  // every ds row written, every warp done reading ds
  const WarpBarrier p_done{bars + 4}, p_read{bars + 5}, ds_done{bars + 6}, pd_free{bars + 7};
  p_done.init(kT);
  p_read.init(kT);
  ds_done.init(kT);
  pd_free.init(kT);

  const int h = blockIdx.y;
  const int c = heads * kDim;
  const long long row_stride = 3LL * c;
  const int slice_windows = windows / nbias;
  const int first = blockIdx.x / nbias;
  const bool producer = threadIdx.x >= kThreads;
  // q, k, v and do of the walk's j-th window (the slice's k-th) into its stage
  auto stage = [&](int j, int k) {
    const long long w = walk_window(nbias, k);
    const __nv_bfloat16* const src = qkv + w * n * row_stride + h * kDim;
    __nv_bfloat16* const qs = tiles + (j & 1) * 4 * kTile;
    stage32(src, row_stride, kS16, n, qs);
    stage32(src + c, row_stride, kS16, n, qs + kTile);
    stage32(src + 2 * c, row_stride, kS16, n, qs + 2 * kTile);
    stage32(dout + w * n * c + h * kDim, c, kS16, n, qs + 3 * kTile);
  };

  // the bias, staged by the whole block while the first window's copies fly
  stage_bias(bias + (static_cast<long long>(blockIdx.x % nbias) * heads + h) * n * n, n, bs,
             bias_ld<kT>());
  if (producer) {
    stage(0, first);
    cp_async_commit();
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();  // the bias has landed, and the barriers are set

  if (producer) {
    for (int k = first, j = 0; k < slice_windows; k += per, ++j) {
      if (j > 0) {
        ring.wait_empty(j);
        stage(j, k);
      }
      if constexpr (kCos) {
        cp_async_commit();
        cp_async_wait<0>();
        __syncwarp();
        const __nv_bfloat16* const qs = tiles + (j & 1) * 4 * kTile;
        inverse_norms<kT>(qs, qs + kTile, norms + (j & 1) * 2 * kS16);
      }
      ring.fill(j);
    }
    return;
  }

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int w0 = (threadIdx.x >> 5) * 16;  // this warp's first query row, then key row
  if constexpr (kCos) scale = __ldg(scales + h);
  float dscale = 0.f;  // this thread's share of the scale's gradient

  // this thread's share of the block's bias gradient: rows w0 + g (+ 8),
  // columns 8 nt + 2 t (+ 1), the positions of its pass-1 C fragments
  float2 gsum[kNt][2];
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
    for (int half = 0; half < 2; ++half) gsum[nt][half] = make_float2(0.f, 0.f);

  const int nt_end = tiny::key_tiles(w0, n, false, kNt);
  const int kk_end = (n + 15) >> 4;
  for (int k = first, j = 0; k < slice_windows; k += per, ++j) {
    ring.wait_full(j);
    const __nv_bfloat16* const qs = tiles + (j & 1) * 4 * kTile;
    const __nv_bfloat16* const ks = qs + kTile;
    const __nv_bfloat16* const vs = ks + kTile;
    const __nv_bfloat16* const dos = vs + kTile;
    const float* const rn = norms + (j & 1) * 2 * kS16;
    __nv_bfloat16* const dst = dqkv + walk_window(nbias, k) * n * row_stride + h * kDim;

    // Pass 1: query rows w0 .. w0 + 15 -> p rows, ds, the bias gradient, dq.
    // ds as bf16 pairs (rows g and g + 8 of each key tile), whole (zeros
    // where masked or skipped): db for dq, and for dk (pass 2) db itself or,
    // in the cosine form, dbk: ds times the keys' inverse norms for dq, times
    // the query's for dk.
    uint32_t db[kNt][2];
    uint32_t dbk[kCos ? kNt : 1][2];
    {
      float s[kNt][4];
      uint32_t a[2][4];
      load_a(a[0], qs, kLdW, w0, 0);
      load_a(a[1], qs, kLdW, w0, 16);
      product32<kNt>(a, ks, nt_end, s);
      if constexpr (kCos) cosines<kNt>(s, rn, rn + kS16, w0, nt_end);
      softmax_rows<kNt>(s, w0, n, scale, nt_end, bs, bias_ld<kT>());  // s = p
      // dp = do v^T a pair of key tiles at a time, twice: once for D, once
      // for ds. do's fragments stay in a through both loops (reading them
      // again for each pair measured 6% slower: more spills, not fewer)
      load_a(a[0], dos, kLdW, w0, 0);
      load_a(a[1], dos, kLdW, w0, 16);
      float dd[2] = {0.f, 0.f};  // D = sum_j dp p, from the unrounded p
#pragma unroll
      for (int np = 0; np < kT; ++np) {
        float dp[2][4];
        product32_pair(a, vs, np, nt_end, dp);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) dd[e >> 1] += dp[i][e] * s[2 * np + i][e];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) dd[i] = quad_sum(dd[i]);

      if (j > 0) pd_free.wait(j - 1);  // every warp has read the last window's ds
#pragma unroll
      for (int np = 0; np < kT; ++np) {
        float dp[2][4];
        product32_pair(a, vs, np, nt_end, dp);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int nt = 2 * np + i;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float p0 = s[nt][2 * half], p1 = s[nt][2 * half + 1];
            const float ds0 = p0 * (dp[i][2 * half] - dd[half]);
            const float ds1 = p1 * (dp[i][2 * half + 1] - dd[half]);
            const int row = w0 + g + 8 * half;
            *reinterpret_cast<uint32_t*>(pd + row * kLdp + nt * 8 + 2 * t) = pack_bf16(p0, p1);
            if constexpr (kCos) {
              const float2 rk = *reinterpret_cast<const float2*>(rn + kS16 + nt * 8 + 2 * t);
              db[nt][half] = pack_bf16(ds0 * rk.x, ds1 * rk.y);
              dbk[nt][half] = pack_bf16(ds0 * rn[row], ds1 * rn[row]);
            } else {
              db[nt][half] = pack_bf16(ds0, ds1);
            }
            gsum[nt][half] = make_float2(gsum[nt][half].x + ds0, gsum[nt][half].y + ds1);
          }
        }
      }
    }
    p_done.arrive();

    // dq = ds k * scale (the cosine form: through the q rows' normalisation)
    {
      float acc[4][4];
      zero(acc);
#pragma unroll
      for (int kk = 0; kk < kT; ++kk) {
        if (2 * kk >= nt_end) continue;
        const uint32_t a[4] = {db[2 * kk][0], db[2 * kk][1], db[2 * kk + 1][0],
                               db[2 * kk + 1][1]};
        accumulate32(acc, a, ks, kk * 16);
      }
      if constexpr (kCos) dscale += project32(acc, qs, rn, w0);
      store32(acc, scale, dst, row_stride, w0, n);
    }
    p_done.wait(j);  // every p row is in shared memory

    // Pass 2: key rows w0 .. w0 + 15 -> dv = p^T do, ...
    {
      float adv[4][4];
      zero(adv);
#pragma unroll
      for (int kk = 0; kk < kT; ++kk) {
        if (kk >= kk_end) continue;
        uint32_t a[4];
        load_a_t(a, pd, kLdp, w0, kk * 16);
        accumulate32(adv, a, dos, kk * 16);
      }
      p_read.arrive();
      store32(adv, 1.f, dst + 2 * c, row_stride, w0, n);
    }
    p_read.wait(j);  // every warp has read p
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t* const slot =
            reinterpret_cast<uint32_t*>(pd + (w0 + g + 8 * half) * kLdp + nt * 8 + 2 * t);
        if constexpr (kCos) {
          *slot = dbk[nt][half];
        } else {
          *slot = db[nt][half];
        }
      }
    }
    ds_done.arrive();
    ds_done.wait(j);  // every ds row is in shared memory

    // ... and dk = ds^T q * scale
    {
      float adk[4][4];
      zero(adk);
#pragma unroll
      for (int kk = 0; kk < kT; ++kk) {
        if (kk >= kk_end) continue;
        uint32_t a[4];
        load_a_t(a, pd, kLdp, w0, kk * 16);
        accumulate32(adk, a, qs, kk * 16);
      }
      if constexpr (kCos) project32(adk, ks, rn + kS16, w0);
      ring.release(j);
      pd_free.arrive();
      store32(adk, scale, dst + c, row_stride, w0, n);
    }
  }

  // this block's partial [n, n] of head h
  float* const part =
      dbias_part + (static_cast<long long>(blockIdx.x) * heads + h) * static_cast<long long>(n) * n;
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = w0 + g + 8 * half;
      const int col = nt * 8 + 2 * t;
      if (row >= n) continue;
      if (col < n) part[row * n + col] = gsum[nt][half].x;
      if (col + 1 < n) part[row * n + col + 1] = gsum[nt][half].y;
    }
  }

  if constexpr (kCos) {
    // and its scale gradient of head h: over the lanes, then the warps in turn
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) dscale += __shfl_xor_sync(0xffffffffu, dscale, o);
    if (lane == 0) warp_sums[threadIdx.x >> 5] = dscale;
    compute_sync(kThreads);
    if (threadIdx.x == 0) {
      float sum = 0.f;
      for (int i = 0; i < kT; ++i) sum += warp_sums[i];
      dscale_part[static_cast<long long>(blockIdx.x) * heads + h] = sum;
    }
  }
}

template <int kT>
__global__ void __launch_bounds__((kT + 1) * 32)
window_attention_bwd_kernel(const __nv_bfloat16* __restrict__ qkv,
                            const float* __restrict__ bias,
                            const __nv_bfloat16* __restrict__ dout,
                            __nv_bfloat16* __restrict__ dqkv, float* __restrict__ dbias_part,
                            int windows, int n, int heads, int nbias, int per, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bwd_walk<kT, false>(smem, qkv, bias, dout, dqkv, dbias_part, windows, n, heads, nbias, per,
                      scale, nullptr, nullptr);
}

template <int kT>
__global__ void __launch_bounds__((kT + 1) * 32)
window_attention_cos_bwd_kernel(const __nv_bfloat16* __restrict__ qkv,
                                const float* __restrict__ bias,
                                const float* __restrict__ scales,
                                const __nv_bfloat16* __restrict__ dout,
                                __nv_bfloat16* __restrict__ dqkv,
                                float* __restrict__ dbias_part, float* __restrict__ dscale_part,
                                int windows, int n, int heads, int nbias, int per) {
  extern __shared__ __align__(16) unsigned char smem[];
  bwd_walk<kT, true>(smem, qkv, bias, dout, dqkv, dbias_part, windows, n, heads, nbias, per,
                     0.f, scales, dscale_part);
}

template <int kT, bool kCos>
auto bwd_kernel() {
  if constexpr (kCos) {
    return window_attention_cos_bwd_kernel<kT>;
  } else {
    return window_attention_bwd_kernel<kT>;
  }
}

template <int kT, bool kCos>
unsigned long long& configured() {
  static unsigned long long devices = 0;  // allow_smem's record
  return devices;
}

template <int kT, bool kCos, typename... Args>
cudaError_t launch(int nbias, int per, int heads, cudaStream_t stream, Args... args) {
  constexpr size_t smem = bwd_smem_bytes<kT, kCos>();
  const auto kernel = bwd_kernel<kT, kCos>();
  cudaError_t err = allow_smem(kernel, smem, configured<kT, kCos>());
  if (err != cudaSuccess) return err;
  kernel<<<dim3(nbias * per, heads), (kT + 1) * 32, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

// The blocks of the backward kernel for windows of n tokens (the cosine
// form's with `cosine` set) that an SM holds at once; -1 on an error.
ILVLM_API int window_attention_bwd_blocks_per_sm(int n, int cosine) {
  if (n < 1 || n > kMaxN) return -1;
  return by_tiles(n, [&](auto tiles) {
    constexpr int kT = decltype(tiles)::value;
    return cosine ? blocks_per_sm(bwd_kernel<kT, true>(), (kT + 1) * 32,
                                  bwd_smem_bytes<kT, true>(), configured<kT, true>())
                  : blocks_per_sm(bwd_kernel<kT, false>(), (kT + 1) * 32,
                                  bwd_smem_bytes<kT, false>(), configured<kT, false>());
  });
}

// qkv: [windows, n, 3 * heads * 32] bf16 (the forward's input); bias:
// [nbias, heads, n, n] fp32 (window w takes bias[w % nbias]); dout:
// [windows, n, heads * 32] bf16; dqkv: [windows, n, 3 * heads * 32] bf16;
// dbias_part: [nbias * per, heads, n, n] fp32, each block's sum of ds over
// the windows it walks (as window_attention_fwd's blocks walk them). All
// contiguous, the bf16 ones 16-byte aligned. Launches on `stream`, does not
// synchronise.
ILVLM_API int window_attention_bwd(const void* qkv, const void* bias, const void* dout,
                                   void* dqkv, void* dbias_part, int windows, int n, int heads,
                                   int nbias, int per, float scale, void* stream) {
  if (!valid_walk(windows, n, heads, nbias, per)) return cudaErrorInvalidValue;
  const auto* q = static_cast<const __nv_bfloat16*>(qkv);
  const auto* b = static_cast<const float*>(bias);
  const auto* go = static_cast<const __nv_bfloat16*>(dout);
  auto* d = static_cast<__nv_bfloat16*>(dqkv);
  auto* p = static_cast<float*>(dbias_part);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_tiles(n, [&](auto tiles) {
    return launch<decltype(tiles)::value, false>(nbias, per, heads, st, q, b, go, d, p, windows,
                                                 n, heads, nbias, per, scale);
  });
}

// The cosine form: as window_attention_bwd, with scales: [heads] fp32 (the
// forward's), dqkv the gradient of the raw q, k and v, and dscale_part:
// [nbias * per, heads] fp32, each block's sum over its windows of the
// gradient of its head's scale.
ILVLM_API int window_attention_cos_bwd(const void* qkv, const void* bias, const void* scales,
                                       const void* dout, void* dqkv, void* dbias_part,
                                       void* dscale_part, int windows, int n, int heads,
                                       int nbias, int per, void* stream) {
  if (!valid_walk(windows, n, heads, nbias, per)) return cudaErrorInvalidValue;
  const auto* q = static_cast<const __nv_bfloat16*>(qkv);
  const auto* b = static_cast<const float*>(bias);
  const auto* sc = static_cast<const float*>(scales);
  const auto* go = static_cast<const __nv_bfloat16*>(dout);
  auto* d = static_cast<__nv_bfloat16*>(dqkv);
  auto* p = static_cast<float*>(dbias_part);
  auto* ds = static_cast<float*>(dscale_part);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_tiles(n, [&](auto tiles) {
    return launch<decltype(tiles)::value, true>(nbias, per, heads, st, q, b, sc, go, d, p, ds,
                                                windows, n, heads, nbias, per);
  });
}
