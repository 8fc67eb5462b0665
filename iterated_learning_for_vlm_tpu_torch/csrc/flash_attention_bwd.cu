// K3-bwd: flash attention backward, any sequence length up to kMaxSeq.
//
// Replaces the TPU kernel iterated_learning_for_vlm_tpu/ops/flash_attention.py
// `_attn_bwd_kernel` (launched by `_bwd_rule.inner`). Same function, per
// (sample, head), all in fp32 from bf16 q, k, v, do, cast to bf16 at the end:
//
//   p  = exp(q k^T * scale + bias - lse)    lse: the forward's row log-sum-exp
//   dv = p^T do,   dp = do v^T,   ds = p (dp - D),   D = sum_j dp p
//   dq = ds k * scale,   dk = ds^T q * scale
//
// The bias (shared [S, S] fp32, or none) gets no gradient; the causal flag
// masks keys above the diagonal by index, as in K3-fwd.
//
// What bounds it on an H100: bytes, as K3-fwd (at B = 256, H = 12, S = 197:
// 0.1619 ms at 3.35 TB/s). A (sample, head) does not fit one block's shared
// memory at S = 197 with its fp32 sums, and blocks run in no order, so a sum
// split across blocks would need float atomics and would not repeat bit for
// bit. So the wrapper's one call makes two launches, and every output
// element has one owner that sums in a fixed order:
//
// 1. dq kernel: a warp owns 16 query rows, a block block_warps(S) warps (as
//    K3-fwd). q and do are staged once by cp.async; the keys and values are
//    walked once, in chunks of 64 through a two-stage cp.async ring (one
//    barrier a chunk, the next chunk in flight). From p = exp2(logit2 - lse2)
//    (the forward's lse, so no online rescale) it sums, in one pass, D =
//    sum_j p dp exactly and the two products sum_j (p dp)_j k_j and
//    sum_j p_j k_j (B from the row-major key tile by ldmatrix.trans); then
//    dq = scale (sum (p dp) k - D sum p k), which is ds k with
//    ds = p (dp - D), and D goes to the stats buffer. (The difference loses
//    ~2e-5 to fp32 at S = 77 to 1024, against 1e-3 of tolerance; a second
//    pass over the keys for ds itself took 18% longer at S = 197. D = do . o
//    from the saved bf16 output was measured first and dropped: o's
//    rounding moves D by up to ~2e-2 at S = 77, which the causal first row
//    carries straight into dq, past the 1e-3 tolerance.)
// 2. dk/dv kernel: a warp owns 16 key rows (k and v staged once; their A
//    fragments are loaded again for each query tile, which keeps 32
//    registers free); the block walks the queries in chunks of 64 (q and do
//    row-major, with their lse and D, through the same kind of ring):
//    s^T = k q^T and dp^T = v do^T take B = q and B = do by ldmatrix, then
//    dv += p^T do and dk += ds^T q take the C fragments as A fragments in
//    registers and B = do and B = q by ldmatrix.trans.
//
// p, p dp and ds enter their products as two bf16 terms (~2^-17 relative).
// Per (sample, head) that is 6 product units of S^2 64 in each kernel.
// Causal: the dq kernel stages no chunk past its block's last row and each
// warp stops at its own diagonal tile; the dk/dv kernel starts at the chunk
// of its first key and each warp skips the query tiles wholly before its
// first key. Chunks are trimmed to roundup(S - row0, 16) rows.
#include "flash_attention.cuh"

namespace {

using namespace ilvlm;
using namespace ilvlm::flash;

// q and do tiles [16 warps][kLd], two ring stages of key and value chunks,
// and with a bias two stages of bias tiles [16 warps][64 + pad] fp32.
size_t dq_smem_bytes(int warps, bool with_bias) {
  const size_t rows = 16 * warps;
  return (2 * rows + 4 * kChunk) * kLd * sizeof(__nv_bfloat16) +
         (with_bias ? 2 * rows * (kChunk + kBiasPad) * sizeof(float) : 0);
}

// k and v tiles [16 warps][kLd], two ring stages of q and do chunks, two of
// their lse and D [64] fp32, and with a bias two stages of bias tiles
// [64][16 warps + pad] fp32.
size_t dkdv_smem_bytes(int warps, bool with_bias) {
  const size_t rows = 16 * warps;
  return (2 * rows + 4 * kChunk) * kLd * sizeof(__nv_bfloat16) +
         2 * 2 * kChunk * sizeof(float) +
         (with_bias ? 2 * kChunk * (rows + kBiasPad) * sizeof(float) : 0);
}

__global__ void __launch_bounds__(kMaxWarps * 32)
flash_attention_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const float* __restrict__ bias,
                              const __nv_bfloat16* __restrict__ dout,
                              const float* __restrict__ lse, __nv_bfloat16* __restrict__ dq,
                              float* __restrict__ dstat, int seq, int heads,
                              long long batch_stride, long long token_stride,
                              long long dout_batch_stride, long long dout_token_stride,
                              int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = blockDim.x >> 1;  // 16 query rows a warp
  const int bias_ld = kChunk + kBiasPad;
  __nv_bfloat16* const qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* const dos = qs + rows * kLd;
  __nv_bfloat16* const ring = dos + rows * kLd;  // stage i: keys, then values
  float* const bias_ring = reinterpret_cast<float*>(ring + 4 * kChunk * kLd);

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int g = lane_id() >> 2;
  const int t = lane_id() & 3;
  const int r0 = blockIdx.x * rows;
  const int wrow = 16 * warp;
  const int row0 = r0 + wrow;
  const long long head = b * batch_stride + h * kHeadDim;
  const long long stat0 = (static_cast<long long>(b) * heads + h) * seq;
  const int kend = causal ? min(seq, r0 + rows) : seq;
  const int nchunks = (kend + kChunk - 1) / kChunk;
  const float scale2 = scale * kLog2e;
  // p = 2^(s sc - lse2): s the raw product without a bias, else the base-2 logit
  const float sc = bias == nullptr ? scale2 : 1.f;

  auto issue = [&](int j) {
    const int k0 = j * kChunk;
    const int n = 16 * chunk_tiles(k0, kend);
    __nv_bfloat16* const st = ring + (j & 1) * 2 * kChunk * kLd;
    stage_async(k + head + k0 * token_stride, token_stride, n, seq - k0, st);
    stage_async(v + head + k0 * token_stride, token_stride, n, seq - k0, st + kChunk * kLd);
    if (bias != nullptr) {
      stage_bias(bias, seq, r0, k0, rows, kChunk, bias_ring + (j & 1) * rows * bias_ld);
    }
  };
  stage_async(q + head + r0 * token_stride, token_stride, rows, seq - r0, qs);
  stage_async(dout + b * dout_batch_stride + h * kHeadDim + r0 * dout_token_stride,
              dout_token_stride, rows, seq - r0, dos);
  issue(0);
  cp_async_commit();

  const bool live = row0 < seq;
  const int wend = causal ? min(seq, row0 + 16) : seq;
  float lse2[2], dd[2] = {0.f, 0.f};  // dd: this thread's part of D, then D
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + g + 8 * i;
    lse2[i] = r < seq ? lse[stat0 + r] * kLog2e : INFINITY;  // p = 0 on rows past the end
  }
  // dq = scale (sum_j (p dp)_j k_j - D sum_j p_j k_j): one pass over the keys
  float pdk[8][4], pk[8][4];
  zero(pdk);
  zero(pk);
  for (int j = 0; j < nchunks; ++j) {
    cp_async_wait<0>();
    __syncthreads();
    if (j + 1 < nchunks) {
      issue(j + 1);
      cp_async_commit();
    }
    if (!live) continue;
    const int k0 = j * kChunk;
    const int nkt = chunk_tiles(k0, wend);
    const __nv_bfloat16* const ks = ring + (j & 1) * 2 * kChunk * kLd;
    const __nv_bfloat16* const vs = ks + kChunk * kLd;
    const float* const bs = bias_ring + (j & 1) * rows * bias_ld + wrow * bias_ld;
    for (int kt = 0; kt < nkt; ++kt) {
      float s[2][4], dp[2][4];
      {
        // q and do fragments come again from shared memory for each tile,
        // which keeps 32 registers free for the two sums
        uint32_t a[4][4];
        load_rows(a, qs, wrow);
        product16(a, ks, kt * 16, s);
        load_rows(a, dos, wrow);
        product16(a, vs, kt * 16, dp);
      }
      // a mask only where the tile crosses S or the diagonal (as K3-fwd)
      const bool whole = k0 + 16 * kt + 16 <= seq && (!causal || k0 + 16 * kt + 16 <= row0 + 1);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int c = kt * 16 + n * 8 + 2 * t + (e & 1);  // key in the chunk
          float x = s[n][e];
          if (bias != nullptr) x = fmaf(bs[(g + 8 * i) * bias_ld + c], kLog2e, x * scale2);
          float p = exp2_approx(fmaf(x, sc, -lse2[i]));
          if (!whole && (k0 + c >= seq || (causal && k0 + c > row0 + g + 8 * i))) p = 0.f;
          s[n][e] = p;
          dp[n][e] *= p;
          dd[i] += dp[n][e];
        }
      }
      uint32_t hi[4], lo[4];
      a_from_c(dp, hi, lo);
      accumulate2(pdk, hi, lo, ks, kt * 16);
      a_from_c(s, hi, lo);
      accumulate2(pk, hi, lo, ks, kt * 16);
    }
  }
  if (!live) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    dd[i] = quad_sum(dd[i]);
    const int r = row0 + g + 8 * i;
    if (t == 0 && r < seq) dstat[stat0 + r] = dd[i];
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) pdk[nt][e] = fmaf(-dd[e >> 1], pk[nt][e], pdk[nt][e]);
  store_rows(pdk, scale, dq + (static_cast<long long>(b) * seq * heads + h) * kHeadDim,
             static_cast<long long>(heads) * kHeadDim, row0, seq);
}

__global__ void __launch_bounds__(kMaxWarps * 32)
flash_attention_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v,
                                const float* __restrict__ bias,
                                const __nv_bfloat16* __restrict__ dout,
                                const float* __restrict__ lse, const float* __restrict__ dstat,
                                __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                                int seq, int heads, long long batch_stride,
                                long long token_stride, long long dout_batch_stride,
                                long long dout_token_stride, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = blockDim.x >> 1;  // 16 key rows a warp
  const int bias_ld = rows + kBiasPad;
  __nv_bfloat16* const ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* const vs = ks + rows * kLd;
  __nv_bfloat16* const ring = vs + rows * kLd;  // stage i: queries, then output gradients
  float* const stat_ring = reinterpret_cast<float*>(ring + 4 * kChunk * kLd);  // lse, D
  float* const bias_ring = stat_ring + 4 * kChunk;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int g = lane_id() >> 2;
  const int t = lane_id() & 3;
  const int kb0 = blockIdx.x * rows;  // the block's first key row
  const int wrow = 16 * warp;
  const int w0 = kb0 + wrow;  // the warp's first key row
  const long long head = b * batch_stride + h * kHeadDim;
  const long long dhead = b * dout_batch_stride + h * kHeadDim;
  const long long stat0 = (static_cast<long long>(b) * heads + h) * seq;
  const int first = causal ? kb0 / kChunk : 0;  // queries before the block's keys see none
  const int nchunks = (seq + kChunk - 1) / kChunk;
  const float scale2 = scale * kLog2e;
  const float sc = bias == nullptr ? scale2 : 1.f;  // as in the dq kernel

  auto issue = [&](int j) {
    const int q0 = j * kChunk;
    const int n = 16 * chunk_tiles(q0, seq);
    __nv_bfloat16* const st = ring + (j & 1) * 2 * kChunk * kLd;
    stage_async(q + head + q0 * token_stride, token_stride, n, seq - q0, st);
    stage_async(dout + dhead + q0 * dout_token_stride, dout_token_stride, n, seq - q0,
                st + kChunk * kLd);
    float* const sr = stat_ring + (j & 1) * 2 * kChunk;
    for (int i = threadIdx.x; i < kChunk; i += blockDim.x) {
      const bool in = q0 + i < seq;
      cp_async4(sr + i, lse + stat0 + (in ? q0 + i : 0), in ? 4 : 0);
      cp_async4(sr + kChunk + i, dstat + stat0 + (in ? q0 + i : 0), in ? 4 : 0);
    }
    if (bias != nullptr) {
      stage_bias(bias, seq, q0, kb0, kChunk, rows, bias_ring + (j & 1) * kChunk * bias_ld);
    }
  };
  stage_async(k + head + kb0 * token_stride, token_stride, rows, seq - kb0, ks);
  stage_async(v + head + kb0 * token_stride, token_stride, rows, seq - kb0, vs);
  issue(first);
  cp_async_commit();

  const bool live = w0 < seq;
  float adk[8][4], adv[8][4];
  zero(adk);
  zero(adv);
  for (int j = first; j < nchunks; ++j) {
    cp_async_wait<0>();
    __syncthreads();
    if (j + 1 < nchunks) {
      issue(j + 1);
      cp_async_commit();
    }
    if (!live) continue;
    const int q0 = j * kChunk;
    // query tiles wholly before the warp's first key are masked for all its keys
    const int qt0 = causal ? max(0, (w0 - q0) >> 4) : 0;
    const int nqt = chunk_tiles(q0, seq);
    const __nv_bfloat16* const qc = ring + (j & 1) * 2 * kChunk * kLd;
    const __nv_bfloat16* const dc = qc + kChunk * kLd;
    const float* const ls = stat_ring + (j & 1) * 2 * kChunk;
    const float* const ds_ = ls + kChunk;
    const float* const bs = bias_ring + (j & 1) * kChunk * bias_ld + wrow;
    for (int qt = qt0; qt < nqt; ++qt) {
      float st[2][4], dpt[2][4];  // [key][query] tiles of s^T and dp^T
      {
        // k and v fragments come again from shared memory for each tile,
        // which keeps them out of the registers between tiles
        uint32_t a[4][4];
        load_rows(a, ks, wrow);
        product16(a, qc, qt * 16, st);
        load_rows(a, vs, wrow);
        product16(a, dc, qt * 16, dpt);
      }
      // a mask only where the tile crosses S or the diagonal
      const bool whole = q0 + 16 * qt + 16 <= seq && (!causal || q0 + 16 * qt >= w0 + 15);
      float l2[2][2], dcol[2][2];  // lse2 and D of this thread's query columns
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = qt * 16 + n * 8 + 2 * t + j;
          l2[n][j] = ls[c] * kLog2e;
          dcol[n][j] = ds_[c];
        }
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int c = qt * 16 + n * 8 + 2 * t + (e & 1);  // query in the chunk
          float x = st[n][e];
          if (bias != nullptr) x = fmaf(bs[c * bias_ld + g + 8 * i], kLog2e, x * scale2);
          float p = exp2_approx(fmaf(x, sc, -l2[n][e & 1]));
          if (!whole && (q0 + c >= seq || (causal && q0 + c < w0 + g + 8 * i))) p = 0.f;
          st[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - dcol[n][e & 1]);  // ds^T
        }
      }
      uint32_t hi[4], lo[4];
      a_from_c(st, hi, lo);
      accumulate2(adv, hi, lo, dc, qt * 16);
      a_from_c(dpt, hi, lo);
      accumulate2(adk, hi, lo, qc, qt * 16);
    }
  }
  if (!live) return;
  const long long out0 = (static_cast<long long>(b) * seq * heads + h) * kHeadDim;
  const long long out_stride = static_cast<long long>(heads) * kHeadDim;
  store_rows(adv, 1.f, dv + out0, out_stride, w0, seq);
  store_rows(adk, scale, dk + out0, out_stride, w0, seq);
}

}  // namespace

// q, k, v: [batch, seq, heads, 64] bf16 views sharing `batch_stride` and
// `token_stride`; dout: the same shape with its own strides (elements; heads
// at a stride of 64, 16-byte aligned rows); bias: [seq, seq] fp32 contiguous
// or null; causal != 0 masks keys above the diagonal; lse: the forward's
// [batch, heads, seq] fp32; dq, dk, dv: [batch, seq, heads, 64] bf16
// contiguous; dstat: fp32 scratch [batch, heads, seq] (D). Two launches on
// `stream`, in order; does not synchronise.
ILVLM_API int flash_attention_bwd(const void* q, const void* k, const void* v, const void* bias,
                                  const void* lse, const void* dout, void* dq, void* dk, void* dv,
                                  void* dstat, int batch, int seq, int heads,
                                  long long batch_stride, long long token_stride,
                                  long long dout_batch_stride, long long dout_token_stride,
                                  int causal, float scale, void* stream) {
  if (batch < 1 || batch > 65535 || heads < 1 || heads > 65535 || seq < 1 || seq > kMaxSeq) {
    return cudaErrorInvalidValue;
  }
  static unsigned long long configured_dq = 0, configured_dkdv = 0;
  cudaError_t err = allow_smem(flash_attention_bwd_dq_kernel, dq_smem_bytes(kMaxWarps, true),
                               configured_dq);
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_attention_bwd_dkdv_kernel, dkdv_smem_bytes(kMaxWarps, true),
                   configured_dkdv);
  if (err != cudaSuccess) return err;
  const int warps = block_warps(seq);
  const dim3 grid((seq + 16 * warps - 1) / (16 * warps), heads, batch);
  const bool with_bias = bias != nullptr;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* q_ = static_cast<const __nv_bfloat16*>(q);
  const auto* k_ = static_cast<const __nv_bfloat16*>(k);
  const auto* v_ = static_cast<const __nv_bfloat16*>(v);
  const auto* bias_ = static_cast<const float*>(bias);
  const auto* lse_ = static_cast<const float*>(lse);
  const auto* dout_ = static_cast<const __nv_bfloat16*>(dout);
  flash_attention_bwd_dq_kernel<<<grid, warps * 32, dq_smem_bytes(warps, with_bias), st>>>(
      q_, k_, v_, bias_, dout_, lse_, static_cast<__nv_bfloat16*>(dq),
      static_cast<float*>(dstat), seq, heads, batch_stride, token_stride, dout_batch_stride,
      dout_token_stride, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_attention_bwd_dkdv_kernel<<<grid, warps * 32, dkdv_smem_bytes(warps, with_bias), st>>>(
      q_, k_, v_, bias_, dout_, lse_, static_cast<const float*>(dstat),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), seq, heads,
      batch_stride, token_stride, dout_batch_stride, dout_token_stride, causal, scale);
  return cudaGetLastError();
}
