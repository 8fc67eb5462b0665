/* Fused host-side image augmentation (native tier of the data loader).
 *
 * One call performs the whole per-image augment chain that the PIL path in
 * ../augment.py runs as 6+ separate C round-trips with Python glue:
 *
 *   crop-box bicubic resize -> color jitter (brightness/contrast/saturation/
 *   hue, PIL ImageEnhance semantics, caller-supplied order) -> grayscale ->
 *   separable Gaussian blur -> horizontal flip -> fused normalize to NHWC
 *   float32.
 *
 * Parity targets (reference prototype/data/imagenet_dataloader.py:59-68
 * MOCOV2_single, :100-106 ONECROP — via the PIL implementations):
 *  - resize: PIL bicubic (a = -0.5, support 2, PIL's coefficient window and
 *    normalization; float intermediate instead of PIL's fixed-point/uint8
 *    staging, so results differ by <= ~2/255).
 *  - brightness/contrast/saturation: exact PIL ImageEnhance math (blend with
 *    black / solid L-mean gray / per-pixel L gray; L = ITU-R 601-2 via PIL's
 *    (r*19595 + g*38470 + b*7471 + 0x8000) >> 16 fixed point).
 *  - hue: PIL HSV round trip (uint8 H wheel) with the LUT offset shift of
 *    augment.py:_hue_shift.
 *  - blur: PIL's 3-pass extended box blur cascade (Gwosdek et al.) with a
 *    variance-matched edge weight; float image intermediate quantized once
 *    at the end (PIL rounds per pass — diff <= ~2/255).
 *
 * All randomness stays in Python: the caller draws crop box, jitter order and
 * factors, gates and sigma from the SAME numpy Generator stream as the PIL
 * path, so both paths are parameter-identical per (seed, epoch, sample).
 *
 * No Python API here: compiled with g++ -O3 -shared, bound via ctypes (the
 * call releases the GIL, so the data pipeline's thread pool scales across
 * host cores without GIL contention).
 */
#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#ifdef __cplusplus
extern "C" {
#endif

/* ---------------------------------------------------------------- resize */

/* PIL bicubic kernel, a = -0.5 (ImagingResample "bicubic_filter"). */
static double bicubic(double x) {
    const double a = -0.5;
    x = fabs(x);
    if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
    if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
    return 0.0;
}

/* Precompute PIL-style filter bounds + normalized weights for one axis.
 * b0/blen: crop box along this axis (floats, like PIL's box resize).
 * in_size: source extent; out_size: destination extent.
 * bounds: [out_size][2] = (first source index, count)
 * weights: [out_size][kmax]
 * Returns kmax (max coefficients per output element). */
static int precompute_coeffs(int in_size, double b0, double blen, int out_size,
                             int *bounds, float *weights, int kmax) {
    const double support0 = 2.0; /* bicubic support */
    double scale = blen / out_size;
    double filterscale = scale < 1.0 ? 1.0 : scale;
    double support = support0 * filterscale;
    double *wd = (double *)malloc(sizeof(double) * kmax);
    if (!wd) return -1;
    int i, j;
    for (i = 0; i < out_size; i++) {
        double center = b0 + (i + 0.5) * scale;
        double ww = 0.0;
        int xmin = (int)(center - support + 0.5);
        int xmax = (int)(center + support + 0.5);
        if (xmin < 0) xmin = 0;
        if (xmax > in_size) xmax = in_size;
        int n = xmax - xmin;
        if (n > kmax) n = kmax;
        float *w = weights + (size_t)i * kmax;
        for (j = 0; j < n; j++) {
            wd[j] = bicubic((xmin + j - center + 0.5) / filterscale);
            ww += wd[j];
        }
        for (j = 0; j < n; j++) w[j] = (float)(ww != 0.0 ? wd[j] / ww : wd[j]);
        for (j = n; j < kmax; j++) w[j] = 0.0f;
        bounds[2 * i] = xmin;
        bounds[2 * i + 1] = n;
    }
    free(wd);
    return kmax;
}

static int coeffs_kmax(double blen, int out_size) {
    double scale = blen / out_size;
    double filterscale = scale < 1.0 ? 1.0 : scale;
    return (int)ceil(2.0 * filterscale) * 2 + 2;
}

static uint8_t clamp_u8(double v) {
    if (v < 0.0) return 0;
    if (v > 255.0) return 255;
    return (uint8_t)(v + 0.5);
}

/* Bicubic resize of an HxWx3 uint8 image restricted to a crop box into an
 * out_h x out_w x 3 uint8 image.  Two separable passes, float intermediate. */
static inline uint8_t clamp_u8f(float v) {
    if (v < 0.0f) return 0;
    if (v > 255.0f) return 255;
    return (uint8_t)(v + 0.5f);
}

static int resize_box(const uint8_t *src, int h, int w, double bx, double by,
                      double bw, double bh, uint8_t *dst, int out_w, int out_h) {
    int kx = coeffs_kmax(bw, out_w);
    int ky = coeffs_kmax(bh, out_h);
    int *xb = (int *)malloc(sizeof(int) * 2 * out_w);
    int *yb = (int *)malloc(sizeof(int) * 2 * out_h);
    float *xw = (float *)malloc(sizeof(float) * (size_t)out_w * kx);
    float *yw = (float *)malloc(sizeof(float) * (size_t)out_h * ky);
    float *acc = (float *)malloc(sizeof(float) * (size_t)out_w * 3);
    if (!xb || !yb || !xw || !yw || !acc) {
        free(xb); free(yb); free(xw); free(yw); free(acc);
        return -1;
    }
    if (precompute_coeffs(w, bx, bw, out_w, xb, xw, kx) < 0 ||
        precompute_coeffs(h, by, bh, out_h, yb, yw, ky) < 0) {
        free(xb); free(yb); free(xw); free(yw); free(acc);
        return -1;
    }

    /* vertical source row range actually needed */
    int rmin = yb[0], rmax = yb[2 * (out_h - 1)] + yb[2 * (out_h - 1) + 1];
    int rows = rmax - rmin;
    /* uint8 intermediate, like PIL's two-pass ImagingResample on uint8
     * images: bicubic overshoot clamps between the passes (a float
     * intermediate drifts up to ~20/255 from PIL on noise images) */
    uint8_t *tmp = (uint8_t *)malloc((size_t)rows * out_w * 3);
    if (!tmp) {
        free(xb); free(yb); free(xw); free(yw); free(acc);
        return -1;
    }
    /* horizontal pass */
    for (int r = 0; r < rows; r++) {
        const uint8_t *row = src + (size_t)(r + rmin) * w * 3;
        uint8_t *orow = tmp + (size_t)r * out_w * 3;
        for (int i = 0; i < out_w; i++) {
            int x0 = xb[2 * i], n = xb[2 * i + 1];
            const float *wv = xw + (size_t)i * kx;
            float s0 = 0, s1 = 0, s2 = 0;
            const uint8_t *p = row + (size_t)x0 * 3;
            for (int j = 0; j < n; j++, p += 3) {
                s0 += wv[j] * p[0];
                s1 += wv[j] * p[1];
                s2 += wv[j] * p[2];
            }
            orow[3 * i] = clamp_u8f(s0);
            orow[3 * i + 1] = clamp_u8f(s1);
            orow[3 * i + 2] = clamp_u8f(s2);
        }
    }
    /* vertical pass: tap-outer, row-inner — the inner loop is a sequential
     * saxpy over the row, which the compiler vectorizes */
    int rowlen = out_w * 3;
    for (int o = 0; o < out_h; o++) {
        int y0 = yb[2 * o] - rmin, n = yb[2 * o + 1];
        const float *wv = yw + (size_t)o * ky;
        for (int i = 0; i < rowlen; i++) acc[i] = 0.0f;
        for (int j = 0; j < n; j++) {
            const uint8_t *trow = tmp + (size_t)(y0 + j) * rowlen;
            float wj = wv[j];
            for (int i = 0; i < rowlen; i++) acc[i] += wj * trow[i];
        }
        uint8_t *orow = dst + (size_t)o * rowlen;
        for (int i = 0; i < rowlen; i++) orow[i] = clamp_u8f(acc[i]);
    }
    free(tmp);
    free(xb); free(yb); free(xw); free(yw); free(acc);
    return 0;
}

/* ------------------------------------------------------------- grayscale */

/* PIL convert("L"): ITU-R 601-2, fixed point (libImaging/convert.c L24). */
static inline uint8_t lum(const uint8_t *p) {
    return (uint8_t)((p[0] * 19595u + p[1] * 38470u + p[2] * 7471u + 0x8000u) >> 16);
}

/* ---------------------------------------------------------- color jitter */

/* Bit-exact PIL Image.blend (libImaging/Blend.c): float32 interpolation
 * degenerate + alpha * (image - degenerate), TRUNCATED to uint8, clamped
 * only on the extrapolation (alpha > 1) branch. */
static inline uint8_t blend_u8(int deg, int v, float alpha) {
    float t = (float)deg + alpha * (float)(v - deg);
    if (t <= 0.0f) return 0;
    if (t >= 255.0f) return 255;
    return (uint8_t)t;
}

static void op_brightness(uint8_t *img, int n, double f) {
    /* PIL Brightness: blend(black, img, f) */
    float a = (float)f;
    uint8_t lut[256];
    for (int i = 0; i < 256; i++) lut[i] = blend_u8(0, i, a);
    for (int i = 0; i < n * 3; i++) img[i] = lut[img[i]];
}

static void op_contrast(uint8_t *img, int n, double f) {
    /* PIL Contrast: g0 = int(mean of L image + 0.5); blend(solid g0, img, f) */
    double total = 0.0;
    for (int i = 0; i < n; i++) total += lum(img + 3 * i);
    int g0 = (int)(total / n + 0.5);
    float a = (float)f;
    uint8_t lut[256];
    for (int i = 0; i < 256; i++) lut[i] = blend_u8(g0, i, a);
    for (int i = 0; i < n * 3; i++) img[i] = lut[img[i]];
}

static void op_saturation(uint8_t *img, int n, double f) {
    /* PIL Color: blend(L(img) replicated, img, f), per pixel */
    float a = (float)f;
    for (int i = 0; i < n; i++) {
        uint8_t *p = img + 3 * i;
        int g = lum(p);
        p[0] = blend_u8(g, p[0], a);
        p[1] = blend_u8(g, p[1], a);
        p[2] = blend_u8(g, p[2], a);
    }
}

/* PIL RGB<->HSV (libImaging/convert.c rgb2hsv_row / hsv2rgb): float math on
 * the uint8 wheel.  Validated exhaustively against PIL in the test suite. */
static void rgb2hsv(const uint8_t *in, uint8_t *out) {
    /* bit-exact PIL (libImaging/Convert.c rgb2hsv_row): FLOAT intermediates,
     * fmod(h/6+1, 1) wheel wrap, trunc-to-int scaling; only the two channel
     * quotients the max-branch uses are computed.  Exhaustive 16.7M-value
     * agreement with PIL is pinned by tests/test_native_augment.py. */
    int r = in[0], g = in[1], b = in[2];
    int maxc = r > g ? (r > b ? r : b) : (g > b ? g : b);
    int minc = r < g ? (r < b ? r : b) : (g < b ? g : b);
    out[2] = (uint8_t)maxc;
    if (minc == maxc) {
        out[0] = 0;
        out[1] = 0;
        return;
    }
    float cr = (float)(maxc - minc);
    float s = cr / (float)maxc;
    float h;
    if (r == maxc)
        h = (float)(maxc - b) / cr - (float)(maxc - g) / cr;
    else if (g == maxc)
        h = 2.0 + (float)(maxc - r) / cr - (float)(maxc - b) / cr;
    else
        h = 4.0 + (float)(maxc - g) / cr - (float)(maxc - r) / cr;
    /* fmod((h/6 + 1), 1): h is in [-1, 5] so the quotient is in [0.83, 1.83)
     * and the remainder is a single exact subtract (bit-identical to fmod) */
    double t = h / 6.0 + 1.0;
    if (t >= 1.0) t -= 1.0;
    h = (float)t;
    out[0] = (uint8_t)(h * 255.0);
    out[1] = (uint8_t)(s * 255.0);
}

static void hsv2rgb(const uint8_t *in, uint8_t *out) {
    int h = in[0], s = in[1], v = in[2];
    if (s == 0) {
        out[0] = out[1] = out[2] = (uint8_t)v;
        return;
    }
    double fh = h / 255.0 * 6.0;
    int i = (int)floor(fh);
    double f = fh - i;
    double fs = s / 255.0;
    /* PIL uses round-half-up on the scaled products */
    uint8_t up = (uint8_t)((v * (1.0 - fs)) + 0.5);
    uint8_t uq = (uint8_t)((v * (1.0 - fs * f)) + 0.5);
    uint8_t ut = (uint8_t)((v * (1.0 - fs * (1.0 - f))) + 0.5);
    uint8_t uv = (uint8_t)v;
    switch (i % 6) {
        case 0: out[0] = uv; out[1] = ut; out[2] = up; break;
        case 1: out[0] = uq; out[1] = uv; out[2] = up; break;
        case 2: out[0] = up; out[1] = uv; out[2] = ut; break;
        case 3: out[0] = up; out[1] = uq; out[2] = uv; break;
        case 4: out[0] = ut; out[1] = up; out[2] = uv; break;
        default: out[0] = uv; out[1] = up; out[2] = uq; break;
    }
}

static void op_hue(uint8_t *img, int n, double f_turns) {
    /* augment.py _hue_shift: off = int(f * 255) (trunc toward 0), H LUT shift */
    int off = (int)(f_turns * 255.0);
    off = ((off % 256) + 256) % 256;
    for (int i = 0; i < n; i++) {
        uint8_t hsv[3];
        rgb2hsv(img + 3 * i, hsv);
        hsv[0] = (uint8_t)((hsv[0] + off) & 0xff);
        hsv2rgb(hsv, img + 3 * i);
    }
}

/* ----------------------------------------------------------------- blur */

/* Gaussian blur as a 3-pass extended box blur per axis (Gwosdek et al.,
 * "Theoretical foundations of Gaussian convolution by extended box
 * filtering") — the same O(1)-per-pixel scheme PIL's GaussianBlur uses, so
 * the native path tracks the PIL path closely AND runs ~5x faster than a
 * direct O(k) kernel at sigma 2.  One pass of float radius rb: inner taps
 * weight 1 over [i-l, i+l], two edge taps weight a = rb - l, normalized by
 * 2*rb + 1; borders clamp to edge.
 *
 * Works on a float image in place via a row scratch buffer; quantization to
 * uint8 happens once at the end (PIL rounds per pass — diff <= ~2/255). */
static void box_pass_row(float *row, float *scratch, int n, int stride,
                         int l, float a, float inv) {
    /* running inner sum over [i-l, i+l] with clamp-to-edge */
    float sum = 0.0f;
    for (int j = -l; j <= l; j++) {
        int jj = j < 0 ? 0 : (j >= n ? n - 1 : j);
        sum += row[jj * stride];
    }
    float first = row[0], last = row[(n - 1) * stride];
    for (int i = 0; i < n; i++) {
        int lo = i - l - 1, hi = i + l + 1;
        float e0 = lo < 0 ? first : row[lo * stride];
        float e1 = hi >= n ? last : row[hi * stride];
        scratch[i] = (sum + a * (e0 + e1)) * inv;
        /* slide window to center i+1: add hi, drop i-l */
        int drop = i - l;
        sum += e1 - (drop < 0 ? first : row[drop * stride]);
    }
    for (int i = 0; i < n; i++) row[i * stride] = scratch[i];
}

/* One vertical extended-box pass, streamed row-major: a full row of running
 * sums slides down the image so every memory access is sequential (the
 * per-column strided walk thrashes cache at stride w*3).  Per-column add
 * order matches box_pass_row exactly, so results are bit-identical. */
static void box_pass_down(const float *src, float *dst, int h, int rowlen,
                          int l, float a, float inv, float *sum) {
    for (int x = 0; x < rowlen; x++) sum[x] = 0.0f;
    for (int j = -l; j <= l; j++) {
        const float *row = src + (size_t)(j < 0 ? 0 : (j >= h ? h - 1 : j)) * rowlen;
        for (int x = 0; x < rowlen; x++) sum[x] += row[x];
    }
    const float *first = src, *last = src + (size_t)(h - 1) * rowlen;
    for (int i = 0; i < h; i++) {
        int lo = i - l - 1, hi = i + l + 1, drop = i - l;
        const float *e0 = lo < 0 ? first : src + (size_t)lo * rowlen;
        const float *e1 = hi >= h ? last : src + (size_t)hi * rowlen;
        const float *dr = drop < 0 ? first : src + (size_t)drop * rowlen;
        float *out = dst + (size_t)i * rowlen;
        for (int x = 0; x < rowlen; x++) {
            out[x] = (sum[x] + a * (e0[x] + e1[x])) * inv;
            sum[x] += e1[x] - dr[x];
        }
    }
}

static void gaussian_blur(uint8_t *img, int h, int w, double sigma) {
    const int passes = 3;
    /* Gwosdek eq. 7/11/14-16: per-pass variance v = sigma^2/n; box length
     * L = sqrt(12v + 1); integer radius l = floor((L-1)/2); edge weight
     * alpha chosen so the DISCRETE extended box has variance exactly v:
     *   alpha = (2l+1)(l(l+1) - 3v) / (6(v - (l+1)^2))            */
    double v = sigma * sigma / passes;
    double L = sqrt(12.0 * v + 1.0);
    int l = (int)floor((L - 1.0) / 2.0);
    double alpha = (2.0 * l + 1.0) * (l * (l + 1.0) - 3.0 * v)
                   / (6.0 * (v - (l + 1.0) * (l + 1.0)));
    float a = (float)alpha;
    float inv = (float)(1.0 / (2.0 * l + 1.0 + 2.0 * alpha));
    size_t npx = (size_t)h * w * 3;
    int rowlen = w * 3;
    float *f = (float *)malloc(sizeof(float) * npx);
    float *f2 = (float *)malloc(sizeof(float) * npx);
    int maxdim = (h > rowlen ? h : rowlen);
    float *scratch = (float *)malloc(sizeof(float) * maxdim);
    if (!f || !f2 || !scratch) {
        free(f); free(f2); free(scratch);
        return;
    }
    for (size_t i = 0; i < npx; i++) f[i] = (float)img[i];
    for (int p = 0; p < passes; p++)
        for (int y = 0; y < h; y++)
            for (int c = 0; c < 3; c++)
                box_pass_row(f + (size_t)y * rowlen + c, scratch, w, 3, l, a, inv);
    float *cur = f, *nxt = f2;
    for (int p = 0; p < passes; p++) {
        box_pass_down(cur, nxt, h, rowlen, l, a, inv, scratch);
        float *t = cur; cur = nxt; nxt = t;
    }
    for (size_t i = 0; i < npx; i++) img[i] = clamp_u8(cur[i]);
    free(f);
    free(f2);
    free(scratch);
}

/* ----------------------------------------------------------- entry point */

/* jitter_ops[i] in {0: brightness, 1: contrast, 2: saturation, 3: hue},
 * applied in array order with jitter_factors[i].
 * blur_sigma <= 0 disables blur; grayscale/flip are 0/1 flags.
 * norm_scale/norm_offset are per-channel: out = u8 * scale + offset.
 * Returns 0 on success. */
int fused_augment(const uint8_t *src, int h, int w,
                  double bx, double by, double bw, double bh,
                  int out_size,
                  const int *jitter_ops, const double *jitter_factors, int n_jitter,
                  int grayscale, double blur_sigma, int flip,
                  const float *norm_scale, const float *norm_offset,
                  float *out) {
    int n = out_size * out_size;
    uint8_t *buf = (uint8_t *)malloc((size_t)n * 3);
    if (!buf) return -1;
    if (resize_box(src, h, w, bx, by, bw, bh, buf, out_size, out_size) != 0) {
        free(buf);
        return -1;
    }
    for (int i = 0; i < n_jitter; i++) {
        switch (jitter_ops[i]) {
            case 0: op_brightness(buf, n, jitter_factors[i]); break;
            case 1: op_contrast(buf, n, jitter_factors[i]); break;
            case 2: op_saturation(buf, n, jitter_factors[i]); break;
            case 3: op_hue(buf, n, jitter_factors[i]); break;
            default: free(buf); return -2;
        }
    }
    if (grayscale) {
        for (int i = 0; i < n; i++) {
            uint8_t g = lum(buf + 3 * i);
            buf[3 * i] = buf[3 * i + 1] = buf[3 * i + 2] = g;
        }
    }
    if (blur_sigma > 0.0) gaussian_blur(buf, out_size, out_size, blur_sigma);
    /* flip + normalize fused into the final write */
    for (int y = 0; y < out_size; y++) {
        const uint8_t *row = buf + (size_t)y * out_size * 3;
        float *orow = out + (size_t)y * out_size * 3;
        for (int x = 0; x < out_size; x++) {
            int sx = flip ? (out_size - 1 - x) : x;
            const uint8_t *p = row + (size_t)sx * 3;
            float *q = orow + (size_t)x * 3;
            q[0] = p[0] * norm_scale[0] + norm_offset[0];
            q[1] = p[1] * norm_scale[1] + norm_offset[1];
            q[2] = p[2] * norm_scale[2] + norm_offset[2];
        }
    }
    free(buf);
    return 0;
}

/* Exposed for unit tests. */
int fused_resize_box(const uint8_t *src, int h, int w, double bx, double by,
                     double bw, double bh, uint8_t *dst, int out_w, int out_h) {
    return resize_box(src, h, w, bx, by, bw, bh, dst, out_w, out_h);
}

void fused_rgb2hsv(const uint8_t *in, uint8_t *out, int n) {
    for (int i = 0; i < n; i++) rgb2hsv(in + 3 * i, out + 3 * i);
}

void fused_hsv2rgb(const uint8_t *in, uint8_t *out, int n) {
    for (int i = 0; i < n; i++) hsv2rgb(in + 3 * i, out + 3 * i);
}

void fused_gray(const uint8_t *in, uint8_t *out, int n) {
    for (int i = 0; i < n; i++) out[i] = lum(in + 3 * i);
}

#ifdef __cplusplus
}
#endif
