// K4-fwd: Swin window attention with a per-(window, head) additive bias.
//
// Replaces no TPU kernel: the JAX package's WindowAttention
// (iterated_learning_for_vlm_tpu/models/swin.py) is two einsums that XLA
// fuses on the TPU. Written for the card because the plain route there
// writes every window's fp32 logits and probabilities to device memory
// ([W, H, N, N], 1.36 GB a layer at stage 0 of Swin-B at 192 px and 256
// images) and reads them back. Same function: for each window w and head h,
// softmax(q k^T * 32^-1/2 + bias[w % nbias, h]) v, read straight from the
// [W, N, 3C] qkv projection (q | k | v column blocks, its bias already
// added) and written as [W, N, C] at the head's column offset. The fp32 bias
// is the head's relative-position bias plus the window's shift mask, made by
// the wrapper (ops/window_attention.py). Numerics as K2-fwd's: fp32 logits,
// bias and softmax, p normalised in fp32 and then rounded to bf16, p v summed
// in fp32, one cast to bf16.
//
// What bounds it on an H100: a (window, head) is 4 N^2 32 flops over
// 4 N 32 bf16 values of device memory (at N = 144: 2.65 MFLOP over 36.9 KB,
// 72 FLOP/B, under the card's ridge of 295), so bytes; but a window's
// softmax (72 exp2f a thread, each with its subnormal guard) and two
// dependent rounds of mma keep a warp busy for longer than its loads take,
// so what the kernel must do is keep the loads off the warps' path and keep
// enough warps in different phases. A block per (window, head) did neither:
// it staged, computed and stored with nothing in flight, its 9 warps in
// step, and each block read its head's [N, N] fp32 bias from L2 entry by
// entry (82.9 KB at N = 144: at stage 2, 340 MB from L2 a launch against
// 151 MB of device memory). The design walks windows instead:
// - a block owns one head and one bias slice (w % nbias) and walks a fixed,
//   ascending set of the slice's windows (window_attention.cuh walk_window);
//   the wrapper's plan (ops/window_attention.py walk_plan) takes as many
//   blocks as the card holds at once, a window a block when it holds them
//   all;
// - the whole block stages the slice's bias into shared memory once, as fp32
//   rows 16 kT + 8 words apart, so the softmax reads it as conflict-free
//   float2 at its C fragments' positions;
// - the block's last warp is a producer: it fills a three-stage ring with q,
//   k and v by cp.async (and, in the cosine form, the rows' inverse norms)
//   and signals each stage on an mbarrier (Ring); the compute warps never
//   wait for one another, only for their stage;
// - the compute warps take the walk's row tiles in turn (fwd_compute_warps:
//   11 at N > 80), a warp 16 query rows of a window; the whole window is one
//   tile set, so no loop runs over keys; a row of logits (<= 144 keys, 18 C
//   fragments) stays in registers; the softmax is K2's, in base 2 with one
//   reciprocal per row (a full window's without its masks; the row's max
//   as a tree: window_attention.cuh softmax_rows), and p goes from the C
//   layout straight into the A fragments of p v.
// Shared memory at N = 144: 87.6 KB of bias and 3 x 34.6 KB of tiles, one
// block of 12 warps an SM. A window's arithmetic does not depend on the walk
// or on which warp takes a tile, so the output has the same bits whatever
// the plan.
//
// The cosine form (window_attention_cos_fwd, Swin V2's attention) runs the
// same body with three more steps: once a window's q and k have landed, the
// producer takes each staged row's fp32 inverse norm (2 N values a stage);
// the raw logits are multiplied by the two rows' inverse norms; and the
// scale is the head's, read from the device ([H] fp32, exp(min(logit_scale,
// ln 100)) made on the device by the caller, so a captured graph reads the
// value of each replay).
#include "window_attention.cuh"

namespace {

using namespace ilvlm;
using namespace ilvlm::win;

// The compute warps of a block. Eleven beside the producer are what an SM's
// registers hold at 3 warps a sub-partition (168 registers a thread); they
// take the walk's row tiles in turn, so each sub-partition carries 2 or 3 of
// every 11 tiles (a warp a row tile would put 3 of a window's 9 on one). A
// warp's next tile lies 11 tiles on, so within the next two windows when a
// window has 6 or more row tiles (N > 80), which the ring's phase parity
// needs; smaller windows take a warp a row tile.
template <int kT>
__host__ __device__ constexpr int fwd_compute_warps() {
  return kT >= 6 ? 11 : kT;
}

template <int kT>
__host__ __device__ constexpr int fwd_threads() {
  return (fwd_compute_warps<kT>() + 1) * 32;
}

// The ring's stages: with the compute warps spread over two windows, a
// third stage keeps the producer a window ahead.
constexpr int kFwdStages = 3;

template <int kT, bool kCos>
constexpr size_t fwd_smem_bytes() {
  return bias_bytes<kT>() + size_t(kFwdStages) * 3 * 16 * kT * kLdW * sizeof(__nv_bfloat16) +
         (kCos ? size_t(kFwdStages) * 2 * 16 * kT * sizeof(float) : 0) +
         2 * kFwdStages * sizeof(uint64_t);
}

// One head's walk over its bias slice's windows, in either form: the dot
// product's logits are `scale` times q k^T; the cosine form's are scales[h]
// times the rows' cosines. The compute warps take the walk's row tiles in
// turn (tile u: row tile u % kT of the walk's window u / kT); the last warp
// produces.
template <int kT, bool kCos>
__device__ __forceinline__ void fwd_walk(unsigned char* smem,
                                         const __nv_bfloat16* __restrict__ qkv,
                                         const float* __restrict__ bias,
                                         __nv_bfloat16* __restrict__ out, int windows, int n,
                                         int heads, int nbias, int per, float scale,
                                         const float* __restrict__ scales) {
  constexpr int kS16 = 16 * kT;
  constexpr int kNt = 2 * kT;  // 8-key tiles of a row
  constexpr int kTile = kS16 * kLdW;
  constexpr int kWarps = fwd_compute_warps<kT>();
  float* const bs = reinterpret_cast<float*>(smem);
  __nv_bfloat16* const tiles = reinterpret_cast<__nv_bfloat16*>(bs + kS16 * bias_ld<kT>());
  // each stage's inverse norms (the cosine form): q rows, then k rows
  float* const norms = reinterpret_cast<float*>(tiles + kFwdStages * 3 * kTile);
  uint64_t* const bars =
      reinterpret_cast<uint64_t*>(norms + (kCos ? kFwdStages * 2 * kS16 : 0));
  const Ring<kFwdStages> ring{bars, bars + kFwdStages};
  ring.init(kT);

  const int h = blockIdx.y;
  const int c = heads * kDim;
  const long long row_stride = 3LL * c;
  const int slice_windows = windows / nbias;
  const int first = blockIdx.x / nbias;
  const bool producer = threadIdx.x >= kWarps * 32;
  // q, k and v of the walk's j-th window (the slice's k-th) into its stage
  auto stage = [&](int j, int k) {
    const __nv_bfloat16* const src = qkv + walk_window(nbias, k) * n * row_stride + h * kDim;
    __nv_bfloat16* const qs = tiles + j % kFwdStages * 3 * kTile;
    stage32(src, row_stride, kS16, n, qs);
    stage32(src + c, row_stride, kS16, n, qs + kTile);
    stage32(src + 2 * c, row_stride, kS16, n, qs + 2 * kTile);
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
        const __nv_bfloat16* const qs = tiles + j % kFwdStages * 3 * kTile;
        inverse_norms<kT>(qs, qs + kTile, norms + j % kFwdStages * 2 * kS16);
      }
      ring.fill(j);
    }
    return;
  }

  if constexpr (kCos) scale = __ldg(scales + h);
  for (int u = threadIdx.x >> 5;; u += kWarps) {
    const int j = u / kT;
    const int k = first + j * per;
    if (k >= slice_windows) break;
    const int row0 = (u - j * kT) * 16;  // this tile's first query row
    const int nt_end = tiny::key_tiles(row0, n, false, kNt);
    ring.wait_full(j);
    const __nv_bfloat16* const qs = tiles + j % kFwdStages * 3 * kTile;
    const __nv_bfloat16* const ks = qs + kTile;
    const __nv_bfloat16* const vs = ks + kTile;
    const float* const rn = norms + j % kFwdStages * 2 * kS16;

    float s[kNt][4];
    {
      uint32_t qa[2][4];
      load_a(qa[0], qs, kLdW, row0, 0);
      load_a(qa[1], qs, kLdW, row0, 16);
      product32<kNt>(qa, ks, nt_end, s);
    }
    if constexpr (kCos) cosines<kNt>(s, rn, rn + kS16, row0, nt_end);
    softmax_rows<kNt>(s, row0, n, scale, nt_end, bs, bias_ld<kT>());

    // out = p v: p's C fragments of key tiles 2kk, 2kk + 1 are the A
    // fragments of k-step kk, rounded to bf16
    float o[4][4];
    zero(o);
#pragma unroll
    for (int kk = 0; kk < kT; ++kk) {
      if (2 * kk >= nt_end) continue;
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      accumulate32(o, a, vs, kk * 16);
    }
    ring.release(j);
    store32(o, 1.f, out + walk_window(nbias, k) * n * c + h * kDim, c, row0, n);
  }
}

template <int kT>
__global__ void __launch_bounds__(fwd_threads<kT>())
window_attention_fwd_kernel(const __nv_bfloat16* __restrict__ qkv,
                            const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                            int windows, int n, int heads, int nbias, int per, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  fwd_walk<kT, false>(smem, qkv, bias, out, windows, n, heads, nbias, per, scale, nullptr);
}

template <int kT>
__global__ void __launch_bounds__(fwd_threads<kT>())
window_attention_cos_fwd_kernel(const __nv_bfloat16* __restrict__ qkv,
                                const float* __restrict__ bias,
                                const float* __restrict__ scales,
                                __nv_bfloat16* __restrict__ out, int windows, int n, int heads,
                                int nbias, int per) {
  extern __shared__ __align__(16) unsigned char smem[];
  fwd_walk<kT, true>(smem, qkv, bias, out, windows, n, heads, nbias, per, 0.f, scales);
}

template <int kT, bool kCos>
auto fwd_kernel() {
  if constexpr (kCos) {
    return window_attention_cos_fwd_kernel<kT>;
  } else {
    return window_attention_fwd_kernel<kT>;
  }
}

template <int kT, bool kCos>
unsigned long long& configured() {
  static unsigned long long devices = 0;  // allow_smem's record
  return devices;
}

template <int kT, bool kCos, typename... Args>
cudaError_t launch(int nbias, int per, int heads, cudaStream_t stream, Args... args) {
  constexpr size_t smem = fwd_smem_bytes<kT, kCos>();
  const auto kernel = fwd_kernel<kT, kCos>();
  cudaError_t err = allow_smem(kernel, smem, configured<kT, kCos>());
  if (err != cudaSuccess) return err;
  kernel<<<dim3(nbias * per, heads), fwd_threads<kT>(), smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

// The blocks of the forward kernel for windows of n tokens (the cosine form's
// with `cosine` set) that an SM holds at once; -1 on an error.
ILVLM_API int window_attention_fwd_blocks_per_sm(int n, int cosine) {
  if (n < 1 || n > kMaxN) return -1;
  return by_tiles(n, [&](auto tiles) {
    constexpr int kT = decltype(tiles)::value;
    return cosine ? blocks_per_sm(fwd_kernel<kT, true>(), fwd_threads<kT>(),
                                  fwd_smem_bytes<kT, true>(), configured<kT, true>())
                  : blocks_per_sm(fwd_kernel<kT, false>(), fwd_threads<kT>(),
                                  fwd_smem_bytes<kT, false>(), configured<kT, false>());
  });
}

// qkv: [windows, n, 3 * heads * 32] bf16, contiguous, 16-byte aligned;
// bias: [nbias, heads, n, n] fp32, contiguous, nbias dividing windows (window
// w takes bias[w % nbias]); out: [windows, n, heads * 32] bf16. The launch
// has nbias * per x heads blocks; block (s + nbias j, h) walks the windows
// s + nbias k, k = j, j + per, ... < windows / nbias. Launches on `stream`,
// does not synchronise.
ILVLM_API int window_attention_fwd(const void* qkv, const void* bias, void* out, int windows,
                                   int n, int heads, int nbias, int per, float scale,
                                   void* stream) {
  if (!valid_walk(windows, n, heads, nbias, per)) return cudaErrorInvalidValue;
  const auto* q = static_cast<const __nv_bfloat16*>(qkv);
  const auto* b = static_cast<const float*>(bias);
  auto* o = static_cast<__nv_bfloat16*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_tiles(n, [&](auto tiles) {
    return launch<decltype(tiles)::value, false>(nbias, per, heads, st, q, b, o, windows, n,
                                                 heads, nbias, per, scale);
  });
}

// The cosine form: as window_attention_fwd, with scales: [heads] fp32 on the
// device, each head's multiplier of its rows' cosines.
ILVLM_API int window_attention_cos_fwd(const void* qkv, const void* bias, const void* scales,
                                       void* out, int windows, int n, int heads, int nbias,
                                       int per, void* stream) {
  if (!valid_walk(windows, n, heads, nbias, per)) return cudaErrorInvalidValue;
  const auto* q = static_cast<const __nv_bfloat16*>(qkv);
  const auto* b = static_cast<const float*>(bias);
  const auto* sc = static_cast<const float*>(scales);
  auto* o = static_cast<__nv_bfloat16*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_tiles(n, [&](auto tiles) {
    return launch<decltype(tiles)::value, true>(nbias, per, heads, st, q, b, sc, o, windows, n,
                                                heads, nbias, per);
  });
}
