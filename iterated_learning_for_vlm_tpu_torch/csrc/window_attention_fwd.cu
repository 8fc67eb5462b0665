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
// 72 FLOP/B, under the card's ridge of 295), so it is bound by bytes. The
// design, as K2-fwd's, keeps the loads off the critical path:
// - one block per (window, head), kT = ceil(N / 16) warps of 16 query rows;
//   the whole window is one tile set, so no loop runs over keys;
// - q and k land in shared memory as one cp.async copy group, v as a second
//   that lands while q k^T and the softmax run (11.5 KB a tile at N = 144,
//   so several blocks share an SM and their loads overlap each other's math);
// - a row of logits (<= 144 keys, 18 C fragments) stays in registers; the
//   softmax is K2's, in base 2 with one reciprocal per row, and p goes from
//   the C layout straight into the A fragments of p v;
// - the [N, N] fp32 bias of the window's (mask, head) is read from L2 in the
//   softmax, entry by entry (the bias tensor is at most nW H N^2 4 bytes,
//   5.3 MB at stage 0, and every block of the launch reads it).
//
// The cosine form (window_attention_cos_fwd, Swin V2's attention) runs the
// same body with three more steps: once q and k have landed, each thread
// takes one staged row's fp32 inverse norm (2 N values in shared memory);
// the raw logits are multiplied by the two rows' inverse norms; and the
// scale is the head's, read from the device ([H] fp32, exp(min(logit_scale,
// ln 100)) made on the device by the caller, so a captured graph reads the
// value of each replay).
#include "window_attention.cuh"

namespace {

using namespace ilvlm;
using namespace ilvlm::win;

template <int kT, bool kCos>
constexpr size_t fwd_smem_bytes() {
  return size_t(3) * 16 * kT * kLdW * sizeof(__nv_bfloat16) +
         (kCos ? size_t(2) * 16 * kT * sizeof(float) : 0);
}

// One (window, head) of either form: the dot product's logits are `scale`
// times q k^T; the cosine form's are scales[h] times the rows' cosines.
template <int kT, bool kCos>
__device__ __forceinline__ void fwd_window(unsigned char* smem,
                                           const __nv_bfloat16* __restrict__ qkv,
                                           const float* __restrict__ bias,
                                           __nv_bfloat16* __restrict__ out, int n, int heads,
                                           int nbias, float scale,
                                           const float* __restrict__ scales) {
  constexpr int kS16 = 16 * kT;
  constexpr int kNt = 2 * kT;  // 8-key tiles of a row
  __nv_bfloat16* const qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* const ks = qs + kS16 * kLdW;
  __nv_bfloat16* const vs = ks + kS16 * kLdW;

  const int w = blockIdx.x;
  const int h = blockIdx.y;
  const int c = heads * kDim;
  const long long row_stride = 3LL * c;
  const __nv_bfloat16* const src = qkv + static_cast<long long>(w) * n * row_stride + h * kDim;
  stage32(src, row_stride, kS16, n, qs);
  stage32(src + c, row_stride, kS16, n, ks);
  cp_async_commit();
  stage32(src + 2 * c, row_stride, kS16, n, vs);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  float* const rn = reinterpret_cast<float*>(vs + kS16 * kLdW);  // q rows, then k rows
  if constexpr (kCos) {
    inverse_norms(qs, ks, kS16, rn);
    scale = __ldg(scales + h);
    __syncthreads();
  }

  const int row0 = (threadIdx.x >> 5) * 16;  // this warp's first query row
  const int nt_end = tiny::key_tiles(row0, n, false, kNt);
  const float* const bw =
      bias + (static_cast<long long>(w % nbias) * heads + h) * static_cast<long long>(n) * n;

  float s[kNt][4];
  {
    uint32_t qa[2][4];
    load_a(qa[0], qs, kLdW, row0, 0);
    load_a(qa[1], qs, kLdW, row0, 16);
    product32<kNt>(qa, ks, nt_end, s);
  }
  if constexpr (kCos) cosines<kNt>(s, rn, rn + kS16, row0, nt_end);
  tiny::softmax_rows<kNt, true>(s, row0, n, false, scale, nt_end, bw);
  cp_async_wait<0>();
  __syncthreads();

  // out = p v: p's C fragments of key tiles 2kk, 2kk + 1 are the A fragments
  // of k-step kk, rounded to bf16
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
  store32(o, 1.f, out + static_cast<long long>(w) * n * c + h * kDim, c, row0, n);
}

template <int kT>
__global__ void __launch_bounds__(kT * 32)
window_attention_fwd_kernel(const __nv_bfloat16* __restrict__ qkv,
                            const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                            int n, int heads, int nbias, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  fwd_window<kT, false>(smem, qkv, bias, out, n, heads, nbias, scale, nullptr);
}

template <int kT>
__global__ void __launch_bounds__(kT * 32)
window_attention_cos_fwd_kernel(const __nv_bfloat16* __restrict__ qkv,
                                const float* __restrict__ bias,
                                const float* __restrict__ scales,
                                __nv_bfloat16* __restrict__ out, int n, int heads, int nbias) {
  extern __shared__ __align__(16) unsigned char smem[];
  fwd_window<kT, true>(smem, qkv, bias, out, n, heads, nbias, 0.f, scales);
}

template <int kT, bool kCos, typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int windows, int heads, cudaStream_t stream, Args... args) {
  static unsigned long long configured = 0;
  constexpr size_t smem = fwd_smem_bytes<kT, kCos>();
  cudaError_t err = allow_smem(kernel, smem, configured);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(windows, heads), kT * 32, smem, stream>>>(args...);
  return cudaGetLastError();
}

bool valid(int windows, int n, int heads, int nbias) {
  return windows >= 1 && heads >= 1 && heads <= 65535 && n >= 1 && n <= kMaxN && nbias >= 1 &&
         windows % nbias == 0;
}

}  // namespace

// qkv: [windows, n, 3 * heads * 32] bf16, contiguous, 16-byte aligned;
// bias: [nbias, heads, n, n] fp32, contiguous, nbias dividing windows (window
// w takes bias[w % nbias]); out: [windows, n, heads * 32] bf16. Launches on
// `stream`, does not synchronise.
ILVLM_API int window_attention_fwd(const void* qkv, const void* bias, void* out, int windows,
                                   int n, int heads, int nbias, float scale, void* stream) {
  if (!valid(windows, n, heads, nbias)) return cudaErrorInvalidValue;
  const auto* q = static_cast<const __nv_bfloat16*>(qkv);
  const auto* b = static_cast<const float*>(bias);
  auto* o = static_cast<__nv_bfloat16*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_tiles(n, [&](auto tiles) {
    constexpr int kT = decltype(tiles)::value;
    return launch<kT, false>(window_attention_fwd_kernel<kT>, windows, heads, st, q, b, o, n,
                             heads, nbias, scale);
  });
}

// The cosine form: as window_attention_fwd, with scales: [heads] fp32 on the
// device, each head's multiplier of its rows' cosines.
ILVLM_API int window_attention_cos_fwd(const void* qkv, const void* bias, const void* scales,
                                       void* out, int windows, int n, int heads, int nbias,
                                       void* stream) {
  if (!valid(windows, n, heads, nbias)) return cudaErrorInvalidValue;
  const auto* q = static_cast<const __nv_bfloat16*>(qkv);
  const auto* b = static_cast<const float*>(bias);
  const auto* sc = static_cast<const float*>(scales);
  auto* o = static_cast<__nv_bfloat16*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_tiles(n, [&](auto tiles) {
    constexpr int kT = decltype(tiles)::value;
    return launch<kT, true>(window_attention_cos_fwd_kernel<kT>, windows, heads, st, q, b, sc,
                            o, n, heads, nbias);
  });
}
