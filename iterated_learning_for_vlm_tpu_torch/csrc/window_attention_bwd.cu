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
// over 73.7 KB, 90 FLOP/B, so bytes. The design:
// - a block owns one head and a strided set of windows (w = g, g + groups,
//   ...), as many blocks as fit the card at once (window_attention_bwd_groups),
//   so the bias's gradient is summed in the block, in a fixed window order,
//   in shared memory: each thread adds the ds values its mma C fragments
//   hold to the [N, N] fp32 slots only it touches, and writes them once at
//   the end as the block's partial [N, N]; the wrapper sums the `groups`
//   partials. No float atomics: two calls agree bit for bit;
// - per window, K2-bwd's two passes: q, k, v and do staged by cp.async as
//   bf16 [S16][40] tiles (v and do a second copy group that lands while
//   q k^T and the softmax run); pass 1, a warp per 16 query rows: q k^T and
//   do v^T on the tensor cores, the softmax in registers, D = sum_j dp p from
//   the fp32 p, ds in fp32, p and ds rounded to bf16 into shared memory, and
//   dq = ds k from the registers; pass 2, a warp per 16 key rows:
//   dv = p^T do and dk = ds^T q, their A fragments read transposed from the
//   stored p and ds by ldmatrix.trans;
// - shared memory at N = 144: 46 KB of tiles, 88 KB of p and ds, 83 KB of
//   bias gradient, so one block an SM; the windows of a block run in turn.
//
// The cosine form (window_attention_cos_bwd): the logits are
// s_h rq_i rk_j (q_i . k_j) + bias, with rq, rk the rows' inverse norms and
// s_h the head's scale (window_attention_fwd.cu). With g = ds (fp32) the
// unit rows' gradients are s_h sum_j g_ij khat_j and s_h sum_i g_ij qhat_i;
// the kernel takes them as products of the raw bf16 tiles with ds scaled in
// fp32 before its rounding (by rk_j along a row for dq, by rq_i down a
// column for dk: the register copy and the stored copy of ds), then maps
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
  return 16 * kT + 8;  // bf16 row stride of the p and ds tiles
}

template <int kT, bool kCos>
constexpr size_t bwd_smem_bytes() {
  return (size_t(4) * 16 * kT * kLdW + size_t(2) * 16 * kT * p_ld<kT>()) *
             sizeof(__nv_bfloat16) +
         size_t(16 * kT) * (16 * kT) * sizeof(float) +
         (kCos ? size_t(2) * 16 * kT * sizeof(float) : 0);
}

// One head over a strided set of windows, in either form (see the top of
// this file); the cosine form also writes its block's scale gradient.
template <int kT, bool kCos>
__device__ __forceinline__ void bwd_windows(unsigned char* smem,
                                            const __nv_bfloat16* __restrict__ qkv,
                                            const float* __restrict__ bias,
                                            const __nv_bfloat16* __restrict__ dout,
                                            __nv_bfloat16* __restrict__ dqkv,
                                            float* __restrict__ dbias_part, int windows, int n,
                                            int heads, int nbias, int groups, float scale,
                                            const float* __restrict__ scales,
                                            float* __restrict__ dscale_part) {
  constexpr int kS16 = 16 * kT;
  constexpr int kNt = 2 * kT;
  constexpr int kLdp = p_ld<kT>();
  __nv_bfloat16* const qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* const ks = qs + kS16 * kLdW;
  __nv_bfloat16* const vs = ks + kS16 * kLdW;
  __nv_bfloat16* const dos = vs + kS16 * kLdW;
  __nv_bfloat16* const ps = dos + kS16 * kLdW;  // [query][key]
  __nv_bfloat16* const dss = ps + kS16 * kLdp;
  float* const gsum = reinterpret_cast<float*>(dss + kS16 * kLdp);  // [query][key], kS16 wide
  float* const rn = gsum + kS16 * kS16;  // inverse norms: q rows, then k rows

  const int h = blockIdx.y;
  const int c = heads * kDim;
  const long long row_stride = 3LL * c;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int w0 = (threadIdx.x >> 5) * 16;  // this warp's first query row, then key row
  if constexpr (kCos) scale = __ldg(scales + h);
  float dscale = 0.f;  // this thread's share of the scale's gradient

  // the bias-gradient slots this thread owns: rows w0 + g (+ 8), columns
  // 8 nt + 2 t (+ 1), the positions of its C fragments
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      *reinterpret_cast<float2*>(gsum + (w0 + g + 8 * half) * kS16 + nt * 8 + 2 * t) =
          make_float2(0.f, 0.f);

  for (int w = blockIdx.x; w < windows; w += groups) {
    const __nv_bfloat16* const src = qkv + static_cast<long long>(w) * n * row_stride + h * kDim;
    stage32(src, row_stride, kS16, n, qs);
    stage32(src + c, row_stride, kS16, n, ks);
    cp_async_commit();
    stage32(src + 2 * c, row_stride, kS16, n, vs);
    stage32(dout + static_cast<long long>(w) * n * c + h * kDim, c, kS16, n, dos);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if constexpr (kCos) {
      inverse_norms(qs, ks, kS16, rn);
      __syncthreads();
    }

    const float* const bw =
        bias + (static_cast<long long>(w % nbias) * heads + h) * static_cast<long long>(n) * n;
    __nv_bfloat16* const dst = dqkv + static_cast<long long>(w) * n * row_stride + h * kDim;

    // Pass 1: query rows w0 .. w0 + 15 -> p and ds rows, the bias gradient, dq.
    {
      const int nt_end = tiny::key_tiles(w0, n, false, kNt);
      float s[kNt][4], dp[kNt][4];
      {
        uint32_t a[2][4];
        load_a(a[0], qs, kLdW, w0, 0);
        load_a(a[1], qs, kLdW, w0, 16);
        product32<kNt>(a, ks, nt_end, s);
        if constexpr (kCos) cosines<kNt>(s, rn, rn + kS16, w0, nt_end);
        tiny::softmax_rows<kNt, true>(s, w0, n, false, scale, nt_end, bw);  // s = p
        cp_async_wait<0>();
        __syncthreads();
        load_a(a[0], dos, kLdW, w0, 0);
        load_a(a[1], dos, kLdW, w0, 16);
        product32<kNt>(a, vs, nt_end, dp);
      }
      float dd[2] = {0.f, 0.f};  // D = sum_j dp p, from the unrounded p
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dd[e >> 1] += dp[nt][e] * s[nt][e];
#pragma unroll
      for (int i = 0; i < 2; ++i) dd[i] = quad_sum(dd[i]);

      // p and ds as bf16 pairs (rows g and g + 8 of each key tile), stored
      // whole (zeros where masked or skipped) for pass 2; the fp32 ds added
      // to this thread's bias-gradient slots. The cosine form keeps ds times
      // the keys' inverse norms for dq and stores ds times the query's for dk.
      uint32_t db[kNt][2];
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float p0 = s[nt][2 * half], p1 = s[nt][2 * half + 1];
          const float ds0 = p0 * (dp[nt][2 * half] - dd[half]);
          const float ds1 = p1 * (dp[nt][2 * half + 1] - dd[half]);
          const int row = w0 + g + 8 * half;
          const int off = row * kLdp + nt * 8 + 2 * t;
          *reinterpret_cast<uint32_t*>(ps + off) = pack_bf16(p0, p1);
          if constexpr (kCos) {
            const float* const rk = rn + kS16 + nt * 8 + 2 * t;
            db[nt][half] = pack_bf16(ds0 * rk[0], ds1 * rk[1]);
            *reinterpret_cast<uint32_t*>(dss + off) = pack_bf16(ds0 * rn[row], ds1 * rn[row]);
          } else {
            db[nt][half] = pack_bf16(ds0, ds1);
            *reinterpret_cast<uint32_t*>(dss + off) = db[nt][half];
          }
          float2* const slot = reinterpret_cast<float2*>(gsum + row * kS16 + nt * 8 + 2 * t);
          const float2 old = *slot;
          *slot = make_float2(old.x + ds0, old.y + ds1);
        }
      }

      // dq = ds k * scale (the cosine form: through the q rows' normalisation)
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
    __syncthreads();  // every p and ds row is in shared memory

    // Pass 2: key rows w0 .. w0 + 15 -> dv = p^T do, dk = ds^T q * scale.
    float adv[4][4], adk[4][4];
    zero(adv);
    zero(adk);
    const int kk_end = (n + 15) >> 4;
#pragma unroll
    for (int kk = 0; kk < kT; ++kk) {
      if (kk >= kk_end) continue;
      uint32_t a[4];
      load_a_t(a, ps, kLdp, w0, kk * 16);
      accumulate32(adv, a, dos, kk * 16);
      load_a_t(a, dss, kLdp, w0, kk * 16);
      accumulate32(adk, a, qs, kk * 16);
    }
    if constexpr (kCos) project32(adk, ks, rn + kS16, w0);
    store32(adk, scale, dst + c, row_stride, w0, n);
    store32(adv, 1.f, dst + 2 * c, row_stride, w0, n);
    __syncthreads();  // the tiles are restaged for the next window
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
      const float2 v = *reinterpret_cast<const float2*>(gsum + row * kS16 + col);
      if (col < n) part[row * n + col] = v.x;
      if (col + 1 < n) part[row * n + col + 1] = v.y;
    }
  }

  if constexpr (kCos) {
    // and its scale gradient of head h: over the lanes, then the warps in turn
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) dscale += __shfl_xor_sync(0xffffffffu, dscale, o);
    if (lane == 0) rn[threadIdx.x >> 5] = dscale;
    __syncthreads();
    if (threadIdx.x == 0) {
      float sum = 0.f;
      for (int i = 0; i < kT; ++i) sum += rn[i];
      dscale_part[static_cast<long long>(blockIdx.x) * heads + h] = sum;
    }
  }
}

template <int kT>
__global__ void __launch_bounds__(kT * 32)
window_attention_bwd_kernel(const __nv_bfloat16* __restrict__ qkv,
                            const float* __restrict__ bias,
                            const __nv_bfloat16* __restrict__ dout,
                            __nv_bfloat16* __restrict__ dqkv, float* __restrict__ dbias_part,
                            int windows, int n, int heads, int nbias, int groups, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bwd_windows<kT, false>(smem, qkv, bias, dout, dqkv, dbias_part, windows, n, heads, nbias,
                         groups, scale, nullptr, nullptr);
}

template <int kT>
__global__ void __launch_bounds__(kT * 32)
window_attention_cos_bwd_kernel(const __nv_bfloat16* __restrict__ qkv,
                                const float* __restrict__ bias,
                                const float* __restrict__ scales,
                                const __nv_bfloat16* __restrict__ dout,
                                __nv_bfloat16* __restrict__ dqkv,
                                float* __restrict__ dbias_part, float* __restrict__ dscale_part,
                                int windows, int n, int heads, int nbias, int groups) {
  extern __shared__ __align__(16) unsigned char smem[];
  bwd_windows<kT, true>(smem, qkv, bias, dout, dqkv, dbias_part, windows, n, heads, nbias,
                        groups, 0.f, scales, dscale_part);
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
cudaError_t configure() {
  static unsigned long long configured = 0;
  return allow_smem(bwd_kernel<kT, kCos>(), bwd_smem_bytes<kT, kCos>(), configured);
}

// The number of blocks per head that fill the card once: the SMs times the
// blocks an SM holds, over the heads, at most one per window.
template <int kT, bool kCos>
int groups_for(int windows, int heads) {
  if (configure<kT, kCos>() != cudaSuccess) return -1;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bwd_kernel<kT, kCos>(), kT * 32,
                                                    bwd_smem_bytes<kT, kCos>()) !=
      cudaSuccess) {
    return -1;
  }
  int sms = 0;
  if (sm_count(sms) != cudaSuccess) return -1;
  const int blocks = per_sm * sms;
  if (blocks < 1) return -1;
  const int groups = blocks / heads < 1 ? 1 : blocks / heads;
  return groups < windows ? groups : windows;
}

template <int kT, bool kCos, typename... Args>
cudaError_t launch(int groups, int heads, cudaStream_t stream, Args... args) {
  cudaError_t err = configure<kT, kCos>();
  if (err != cudaSuccess) return err;
  const auto kernel = bwd_kernel<kT, kCos>();
  kernel<<<dim3(groups, heads), kT * 32, bwd_smem_bytes<kT, kCos>(), stream>>>(args...);
  return cudaGetLastError();
}

bool valid(int windows, int n, int heads) {
  return windows >= 1 && heads >= 1 && heads <= 65535 && n >= 1 && n <= kMaxN;
}

bool valid(int windows, int n, int heads, int nbias, int groups) {
  return valid(windows, n, heads) && nbias >= 1 && windows % nbias == 0 && groups >= 1 &&
         groups <= windows;
}

}  // namespace

// The number of window groups (blocks per head) window_attention_bwd takes
// for this shape: the size of its dbias_part's first axis. -1 on an error.
ILVLM_API int window_attention_bwd_groups(int windows, int n, int heads) {
  if (!valid(windows, n, heads)) return -1;
  return by_tiles(n, [&](auto tiles) {
    return groups_for<decltype(tiles)::value, false>(windows, heads);
  });
}

// qkv: [windows, n, 3 * heads * 32] bf16 (the forward's input); bias:
// [nbias, heads, n, n] fp32 (window w takes bias[w % nbias]); dout:
// [windows, n, heads * 32] bf16; dqkv: [windows, n, 3 * heads * 32] bf16;
// dbias_part: [groups, heads, n, n] fp32, each block's sum of ds over its
// windows (groups from window_attention_bwd_groups). All contiguous, the bf16
// ones 16-byte aligned. Launches on `stream`, does not synchronise.
ILVLM_API int window_attention_bwd(const void* qkv, const void* bias, const void* dout,
                                   void* dqkv, void* dbias_part, int windows, int n, int heads,
                                   int nbias, int groups, float scale, void* stream) {
  if (!valid(windows, n, heads, nbias, groups)) return cudaErrorInvalidValue;
  const auto* q = static_cast<const __nv_bfloat16*>(qkv);
  const auto* b = static_cast<const float*>(bias);
  const auto* go = static_cast<const __nv_bfloat16*>(dout);
  auto* d = static_cast<__nv_bfloat16*>(dqkv);
  auto* p = static_cast<float*>(dbias_part);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_tiles(n, [&](auto tiles) {
    return launch<decltype(tiles)::value, false>(groups, heads, st, q, b, go, d, p, windows, n,
                                                 heads, nbias, groups, scale);
  });
}

// The cosine form's window groups (its blocks hold the rows' inverse norms
// besides): the size of dbias_part's and dscale_part's first axes.
ILVLM_API int window_attention_cos_bwd_groups(int windows, int n, int heads) {
  if (!valid(windows, n, heads)) return -1;
  return by_tiles(n, [&](auto tiles) {
    return groups_for<decltype(tiles)::value, true>(windows, heads);
  });
}

// The cosine form: as window_attention_bwd, with scales: [heads] fp32 (the
// forward's), dqkv the gradient of the raw q, k and v, and dscale_part:
// [groups, heads] fp32, each block's sum over its windows of the gradient of
// its head's scale.
ILVLM_API int window_attention_cos_bwd(const void* qkv, const void* bias, const void* scales,
                                       const void* dout, void* dqkv, void* dbias_part,
                                       void* dscale_part, int windows, int n, int heads,
                                       int nbias, int groups, void* stream) {
  if (!valid(windows, n, heads, nbias, groups)) return cudaErrorInvalidValue;
  const auto* q = static_cast<const __nv_bfloat16*>(qkv);
  const auto* b = static_cast<const float*>(bias);
  const auto* sc = static_cast<const float*>(scales);
  const auto* go = static_cast<const __nv_bfloat16*>(dout);
  auto* d = static_cast<__nv_bfloat16*>(dqkv);
  auto* p = static_cast<float*>(dbias_part);
  auto* ds = static_cast<float*>(dscale_part);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_tiles(n, [&](auto tiles) {
    return launch<decltype(tiles)::value, true>(groups, heads, st, q, b, sc, go, d, p, ds,
                                                windows, n, heads, nbias, groups);
  });
}
