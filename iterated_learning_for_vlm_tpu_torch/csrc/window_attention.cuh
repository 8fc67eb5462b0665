// Helpers shared by the K4 kernels (window_attention_fwd.cu, window_attention_bwd.cu).
//
// A block owns one head h and one bias slice s = w % nbias and walks a fixed,
// ascending set of that slice's windows (walk_window). The whole block
// stages the slice's fp32 [N, N] bias into shared memory once (stage_bias);
// then its last warp, the producer, stages each window's tiles into a ring
// of stages (Ring), the next windows' copies in flight while the compute
// warps work on the current one. A window's N <= 144 tokens are padded to
// S16 = 16 kT rows (kT = 1 .. 9), and a compute warp takes a row tile of 16
// rows (a query tile, or in the backward's second pass a key tile). The
// head's 32 columns of q, k, v (and the output gradient) are staged as bf16
// tiles [S16][kLdW], rows padded to 40 elements (80 bytes: the eight rows an
// ldmatrix phase reads land on distinct 16-byte bank groups); rows past N
// are zeros. Every product runs on the tensor cores (mma.sync m16n8k16,
// bf16 operands, fp32 sums) from ldmatrix fragments (common.cuh); the
// softmax is K2's (tiny_attention.cuh), with the staged bias.
//
// The cosine form (Swin V2) computes the logits as a per-head scale times the
// cosines of the q and k rows: the raw bf16 product q k^T in fp32, times the
// rows' fp32 inverse norms 1 / (|q| + 1e-12) and 1 / (|k| + 1e-12), which
// the producer takes once per window from the staged tiles (inverse_norms).
// Its backward maps the gradients of the unit rows back through the
// normalisation (project32).
#pragma once

#include <type_traits>

#include "tiny_attention.cuh"

namespace ilvlm {
namespace win {

constexpr int kDim = 32;        // every Swin-B stage's head width
constexpr int kLdW = kDim + 8;  // bf16 row stride of the staged tiles
constexpr int kMaxN = 144;      // 12 x 12 windows

// fp32 row stride of the staged bias: 16 kT + 8 is 8 or 24 words mod 32, so
// the four rows a half-warp's float2 reads at its C fragments' positions
// (softmax_rows) start 8 banks apart, and no two of its lanes share a bank.
template <int kT>
__host__ __device__ constexpr int bias_ld() {
  return 16 * kT + 8;
}

template <int kT>
constexpr size_t bias_bytes() {
  return size_t(16 * kT) * bias_ld<kT>() * sizeof(float);
}

// The window of a block's walk at step k of its bias slice: the slice's
// windows are s, s + nbias, s + 2 nbias, ...; block b = s + nbias j walks
// their indices k = j, j + per, j + 2 per, ... (ops/window_attention.py
// block_windows).
__device__ __forceinline__ long long walk_window(int nbias, int k) {
  return static_cast<long long>(blockIdx.x % nbias) + static_cast<long long>(nbias) * k;
}

// The block's threads start the copies of the [n, n] fp32 bias slice `src`
// into rows of `bs` [n][ld] as one copy group: 16-byte chunks when n is a
// multiple of 4 (then every row starts 16-byte aligned), single words
// otherwise.
__device__ __forceinline__ void stage_bias(const float* __restrict__ src, int n, float* bs,
                                           int ld) {
  if ((n & 3) == 0) {
    const int chunks = n >> 2;  // a row's
    for (int idx = threadIdx.x; idx < n * chunks; idx += blockDim.x) {
      const int r = idx / chunks;
      const int c = (idx - r * chunks) * 4;
      cp_async16(bs + r * ld + c, src + r * n + c, 16);
    }
  } else {
    for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
      const int r = idx / n;
      cp_async4(bs + r * ld + idx - r * n, src + idx, 4);
    }
  }
  cp_async_commit();
}

// The ring of a block's window tiles (kStages stages) and its mbarriers:
// full[st] completes when stage st holds a window (the producer warp's 32
// lanes arrive once its copies have landed), empty[st] when the block's
// compute warps are done with it (a lane 0 arrives for each of the window's
// kT row tiles). The j-th window of a walk takes stage j % kStages, that
// stage's (j / kStages)-th use.
template <int kStages>
struct Ring {
  uint64_t* full;   // [kStages]
  uint64_t* empty;  // [kStages]

  // Thread 0 sets the barriers up; the block syncs before any use.
  __device__ __forceinline__ void init(int row_tiles) const {
    if (threadIdx.x == 0) {
      for (int st = 0; st < kStages; ++st) {
        mbar_init(full + st, 32);
        mbar_init(empty + st, row_tiles);
      }
    }
  }
  // The producer, before filling window j's stage: the compute warps are
  // done with window j - kStages.
  __device__ __forceinline__ void wait_empty(int j) const {
    if (j >= kStages) mbar_wait(empty + j % kStages, (j / kStages - 1) & 1);
  }
  // The producer's lanes, once window j's copies (and what it derived from
  // them) are in its stage.
  __device__ __forceinline__ void fill(int j) const {
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();
    mbar_arrive(full + j % kStages);
  }
  // A compute warp, before reading window j.
  __device__ __forceinline__ void wait_full(int j) const {
    mbar_wait(full + j % kStages, (j / kStages) & 1);
  }
  // A compute warp, done reading window j's stage for one row tile.
  __device__ __forceinline__ void release(int j) const {
    __syncwarp();
    if (lane_id() == 0) mbar_arrive(empty + j % kStages);
  }
};

// A barrier of the block's `threads` compute threads (barrier 1: the producer
// warp takes no part).
__device__ __forceinline__ void compute_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// A barrier of a block's compute warps, split: each warp arrives once its
// lanes are done (arrive), and waits for the others later (wait), so the
// work between the two overlaps the slowest warp's. It completes once per
// window: window j waits on phase parity j & 1.
struct WarpBarrier {
  uint64_t* bar;

  // Thread 0 sets it up for `warps` arrivals a phase; the block syncs
  // before any use.
  __device__ __forceinline__ void init(int warps) const {
    if (threadIdx.x == 0) mbar_init(bar, warps);
  }
  __device__ __forceinline__ void arrive() const {
    __syncwarp();
    if (lane_id() == 0) mbar_arrive(bar);
  }
  __device__ __forceinline__ void wait(int j) const { mbar_wait(bar, j & 1); }
};

// The calling warp starts the copies of rows 0 .. rows - 1 of one head's 32
// columns (`src` at row 0, rows `row_stride` elements apart) into `tile`
// [rows][kLdW]; rows >= n are zero-filled and read nothing. Four 16-byte
// chunks a row.
__device__ __forceinline__ void stage32(const __nv_bfloat16* __restrict__ src,
                                        long long row_stride, int rows, int n,
                                        __nv_bfloat16* tile) {
  for (int idx = lane_id(); idx < rows * 4; idx += 32) {
    const int r = idx >> 2;
    const int c = (idx & 3) * 8;
    const bool live = r < n;
    cp_async16(tile + r * kLdW + c, src + (live ? r : 0) * row_stride + c, live ? 16 : 0);
  }
}

// The key tiles 2 np and 2 np + 1 of product32: s = A (16 x 32, fragments
// a[2] over k) times the transpose of rows 16 np .. 16 np + 15 of a [.][kLdW]
// tile, or 0 when 2 np >= nt_end.
__device__ __forceinline__ void product32_pair(const uint32_t (&a)[2][4],
                                               const __nv_bfloat16* tile, int np, int nt_end,
                                               float (&s)[2][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
  if (2 * np >= nt_end) return;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    uint32_t b[4];
    load_b_nk(b, tile, kLdW, np * 16, kk * 16);
    mma_bf16_16816(s[0], a[kk], b[0], b[1]);
    mma_bf16_16816(s[1], a[kk], b[2], b[3]);
  }
}

// s[nt] = A (16 x 32, fragments a[2] over k) times the transpose of rows
// 8 nt .. 8 nt + 7 of a [.][kLdW] tile, for the tiles nt < nt_end (in
// pairs); the others are left at 0.
template <int kNt>
__device__ __forceinline__ void product32(const uint32_t (&a)[2][4], const __nv_bfloat16* tile,
                                          int nt_end, float (&s)[kNt][4]) {
#pragma unroll
  for (int np = 0; np < kNt / 2; ++np)
    product32_pair(a, tile, np, nt_end, *reinterpret_cast<float(*)[2][4]>(s[2 * np]));
}

// A warp's 16 rows of base-2 logits (C fragments; -inf where masked, the key
// tiles >= nt_end ignored) to p in place, with the operations of K2's softmax
// (tiny::softmax_rows) and so its bits: p = 2^(x - max) times the row's
// 1 / sum, normalised in fp32, exactly 0 where masked and in the tiles >=
// nt_end. The row's max is exact in any order, so it is taken as a tree; the
// sum keeps K2's order. A row masked whole takes 0 as its max, so every
// 2^(x - max) is 0 and p is 0, where K2 tests each x against -inf.
template <int kNt>
__device__ __forceinline__ void normalize_rows(float (&s)[kNt][4], int nt_end) {
  float m[kNt][2];
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      m[nt][half] = nt < nt_end ? fmaxf(s[nt][2 * half], s[nt][2 * half + 1]) : -INFINITY;
#pragma unroll
  for (int stride = 1; stride < kNt; stride *= 2)
#pragma unroll
    for (int nt = 0; nt + stride < kNt; nt += 2 * stride)
#pragma unroll
      for (int half = 0; half < 2; ++half) m[nt][half] = fmaxf(m[nt][half], m[nt + stride][half]);
  float mx[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = quad_max(m[0][i]);
    if (mx[i] == -INFINITY) mx[i] = 0.f;
  }
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) {
    if (nt >= nt_end) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[nt][e] = exp2f(s[nt][e] - mx[e >> 1]);
      sum[e >> 1] += s[nt][e];
    }
  }
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sum[i] = quad_sum(sum[i]);
    inv[i] = sum[i] > 0.f ? 1.f / sum[i] : 0.f;  // a row >= n has sum 0 and p 0
  }
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = nt < nt_end ? s[nt][e] * inv[e >> 1] : 0.f;
}

// The softmax of a warp's 16 query rows from row0 in place, as K2's
// (tiny::softmax_rows, no causal mask): the logits scaled in base 2 plus the
// bias times log2 e, the bias read from the staged slice bs [n][ld] as
// float2 at the C fragments' positions. A full window (n = 8 kNt) has no
// masked row or key, and takes no masks.
template <int kNt>
__device__ __forceinline__ void softmax_rows(float (&s)[kNt][4], int row0, int n, float scale,
                                             int nt_end, const float* bs, int ld) {
  constexpr float kLog2e = 1.4426950408889634f;
  const float scale2 = scale * kLog2e;
  const int l = lane_id();
  if (n == 8 * kNt) {
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float2 b = *reinterpret_cast<const float2*>(
            bs + (row0 + (l >> 2) + 8 * half) * ld + nt * 8 + 2 * (l & 3));
        s[nt][2 * half] = fmaf(b.x, kLog2e, s[nt][2 * half] * scale2);
        s[nt][2 * half + 1] = fmaf(b.y, kLog2e, s[nt][2 * half + 1] * scale2);
      }
    }
    normalize_rows<kNt>(s, kNt);
    return;
  }
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) {
    if (nt >= nt_end) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + (l >> 2) + 8 * half;
      const int c = nt * 8 + 2 * (l & 3);
      float2 b = make_float2(0.f, 0.f);
      if (r < n) b = *reinterpret_cast<const float2*>(bs + r * ld + c);
      float x0 = -INFINITY, x1 = -INFINITY;
      if (r < n && c < n) x0 = fmaf(b.x, kLog2e, s[nt][2 * half] * scale2);
      if (r < n && c + 1 < n) x1 = fmaf(b.y, kLog2e, s[nt][2 * half + 1] * scale2);
      s[nt][2 * half] = x0;
      s[nt][2 * half + 1] = x1;
    }
  }
  normalize_rows<kNt>(s, nt_end);
}

// acc (16 rows x 32 columns, 4 n8 tiles) += A (16 x 16, fragments a) times
// rows k0 .. k0 + 15 of a [.][kLdW] tile.
__device__ __forceinline__ void accumulate32(float (&acc)[4][4], const uint32_t (&a)[4],
                                             const __nv_bfloat16* tile, int k0) {
#pragma unroll
  for (int np = 0; np < 2; ++np) {
    uint32_t b[4];
    load_b_kn(b, tile, kLdW, k0, np * 16);
    mma_bf16_16816(acc[2 * np], a, b[0], b[1]);
    mma_bf16_16816(acc[2 * np + 1], a, b[2], b[3]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
}

// Store a warp's 16 x 32 fp32 result times `mul` as bf16 into rows
// row0 .. row0 + 15 (those < n) of a [rows][row_stride] matrix, `dst` at row
// 0 of the head's 32 columns.
__device__ __forceinline__ void store32(const float (&acc)[4][4], float mul, __nv_bfloat16* dst,
                                        long long row_stride, int row0, int n) {
  const int l = lane_id();
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + (l >> 2) + 8 * half;
    if (r >= n) continue;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      *reinterpret_cast<__nv_bfloat162*>(dst + r * row_stride + nt * 8 + 2 * (l & 3)) =
          __floats2bfloat162_rn(acc[nt][2 * half] * mul, acc[nt][2 * half + 1] * mul);
    }
  }
}

// rn[r] = 1 / (|row r| + 1e-12) of the 16 kT rows of the q tile and, at
// rn[16 kT + r], of the k tile: fp32 sums of the squares of the bf16 values,
// in column order. Lane l of the calling warp takes rows l, l + 32, ... (kT
// of them), their sums interleaved.
template <int kT>
__device__ __forceinline__ void inverse_norms(const __nv_bfloat16* qs, const __nv_bfloat16* ks,
                                              float* rn) {
  constexpr int kRows = 16 * kT;
  const int l = lane_id();
  float ss[kT];
#pragma unroll
  for (int i = 0; i < kT; ++i) ss[i] = 0.f;
#pragma unroll
  for (int c = 0; c < kDim; c += 8) {
#pragma unroll
    for (int i = 0; i < kT; ++i) {
      const int idx = l + 32 * i;
      const __nv_bfloat16* row = idx < kRows ? qs + idx * kLdW : ks + (idx - kRows) * kLdW;
      const uint4 chunk = *reinterpret_cast<const uint4*>(row + c);
      const __nv_bfloat162* const pairs = reinterpret_cast<const __nv_bfloat162*>(&chunk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 v = __bfloat1622float2(pairs[e]);
        ss[i] = fmaf(v.x, v.x, ss[i]);
        ss[i] = fmaf(v.y, v.y, ss[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kT; ++i) rn[l + 32 * i] = 1.f / (sqrtf(ss[i]) + 1e-12f);
}

// The raw products of a warp's 16 query rows from row0 (C fragments s) to
// cosines: s[nt][e] *= rq[row] * rk[col], rq and rk the inverse norms of the
// q and k rows.
template <int kNt>
__device__ __forceinline__ void cosines(float (&s)[kNt][4], const float* rq, const float* rk,
                                        int row0, int nt_end) {
  const int l = lane_id();
  const float fq[2] = {rq[row0 + (l >> 2)], rq[row0 + (l >> 2) + 8]};
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) {
    if (nt >= nt_end) continue;
    const float2 fk = *reinterpret_cast<const float2*>(rk + nt * 8 + 2 * (l & 3));
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] *= fq[e >> 1] * (e & 1 ? fk.y : fk.x);
  }
}

// A warp's 16 x 32 fp32 result acc_i = sum_j g_ij u_j for rows row0 ..
// row0 + 15 (u the other operand's unit rows) is the gradient of the unit
// rows y_i / |y_i| of `tile`; take it back through the normalisation:
// acc_i <- rn_i (acc_i - yhat_i (yhat_i . acc_i)), yhat_i = y_i rn_i (the
// 1e-12 left out of the Jacobian). Returns this thread's share of the sum of
// yhat_i . acc_i over the rows: each row's dot product once, on the quad's
// lane 0.
__device__ __forceinline__ float project32(float (&acc)[4][4], const __nv_bfloat16* tile,
                                           const float* rn, int row0) {
  const int l = lane_id();
  float share = 0.f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + (l >> 2) + 8 * half;
    const float f = rn[r];
    float2 y[4];
    float dot = 0.f;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(tile + r * kLdW + nt * 8 + 2 * (l & 3)));
      y[nt] = make_float2(v.x * f, v.y * f);
      dot = fmaf(y[nt].x, acc[nt][2 * half], dot);
      dot = fmaf(y[nt].y, acc[nt][2 * half + 1], dot);
    }
    dot = quad_sum(dot);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      acc[nt][2 * half] = f * (acc[nt][2 * half] - y[nt].x * dot);
      acc[nt][2 * half + 1] = f * (acc[nt][2 * half + 1] - y[nt].y * dot);
    }
    if ((l & 3) == 0) share += dot;
  }
  return share;
}

// f(std::integral_constant<int, kT>) for the kT = ceil(n / 16) of a window of
// n <= 144 tokens.
template <typename F>
auto by_tiles(int n, F&& f) {
  switch ((n + 15) / 16) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    case 8: return f(std::integral_constant<int, 8>{});
    default: return f(std::integral_constant<int, 9>{});
  }
}

// The blocks of `kernel` an SM holds at `threads` threads and `smem` bytes
// of dynamic shared memory, its cap raised first (`configured`: allow_smem's
// record); -1 on an error.
template <typename Kernel>
int blocks_per_sm(Kernel kernel, int threads, size_t smem, unsigned long long& configured) {
  if (allow_smem(kernel, smem, configured) != cudaSuccess) return -1;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem) !=
      cudaSuccess) {
    return -1;
  }
  return per_sm;
}

// The launch's shape is valid: nbias divides the windows, and `per` blocks a
// (bias slice, head) each walk at least one window.
inline bool valid_walk(int windows, int n, int heads, int nbias, int per) {
  return windows >= 1 && heads >= 1 && heads <= 65535 && n >= 1 && n <= kMaxN && nbias >= 1 &&
         windows % nbias == 0 && per >= 1 && per <= windows / nbias;
}

}  // namespace win
}  // namespace ilvlm
