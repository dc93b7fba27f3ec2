// The photometric term of one scale of the Monodepth2 loss: SSIM + L1 of
// every warped source against the target, the noisy identity channels and
// the per-pixel minimum, NHWC float32, C = 3. Three entry points:
//   photometric_identity  the identity errors [B,H,W,F] of the F unwarped
//                         sources (forward only, once a step);
//   photometric_min_fwd   the minimum [B,H,W] over the channels
//                         [identity + noise, reprojection errors of the F
//                         warps] and a one-byte mask of the channels that
//                         tie at it;
//   photometric_min_bwd   the gradient of each warp [B,H,W,3] from the
//                         minimum's cotangent, the mask and the images.
// The first two are one kernel template (photometric_min_fwd_kernel, in an
// identity and a minimum mode), the last is photometric_min_bwd_kernel.
//
// Replaces no Pallas kernel: the JAX package leaves SSIM to XLA. The
// specification is the plain PyTorch composition in ops/ssim.py and
// losses/reprojection.py (reprojection_error, torch.cat, + noise, amin),
// which ops/cuda/photometric.py keeps as the plain version. Per pixel and
// channel, with 3x3 means over reflect-padded windows (rows 1 and H-2,
// columns 1 and W-2 mirrored past the edges):
//   mu_x, mu_y, sigma_x = mean(x*x) - mu_x^2, sigma_y, sigma_xy
//   d = clip((1 - (2 mu_x mu_y + C1)(2 sigma_xy + C2)
//             / ((mu_x^2 + mu_y^2 + C1)(sigma_x + sigma_y + C2))) / 2, 0, 1)
//   error = 0.85 * mean_c(d) + 0.15 * mean_c(|y - x|)
// The forward rounds as the plain ops do on the card: each window sum is
// the vertical 3-sum then the horizontal one, times 1/9; each product and
// sum an explicit _rn intrinsic, so nothing is contracted into an FMA; the
// channel means are the sum in channel order times float(1/3).
//
// Rules kept, each the plain version's:
//   clip: comparisons, not fminf/fmaxf, so NaN passes; its gradient is 1
//     inside, 0 outside, 0.5 where d is exactly 0 or 1 (jnp.clip, via
//     ops/sampling.clip) and 1 for NaN (torch.maximum/minimum's backward);
//   abs: gradient sign(y - x), 0 at 0 and for NaN;
//   minimum: NaN wherever a channel is NaN, as amin; the mask holds bit k
//     for each channel k equal to the minimum, or, where the minimum is
//     NaN, bit 7 and the bit of the first NaN channel (argmin's index);
//   backward of the minimum: channel k takes bit_k * (g / popcount), amin's
//     even split among ties; a NaN minimum (no channel equal to it) gives
//     every channel 0 * (g / 0) = NaN, as amin's autograd does. A single
//     channel passes g through, as min_reprojection takes it unreduced.
//
// Bound: memory. Per pixel of 12x192x640 (1,474,560), F = 2, automask on:
// the identity launch reads 2 sources and the target and writes 2 errors,
// 44 B (65 MB, 19 us at 3.35 TB/s); a forward reads 2 warps, the target,
// identity and noise and writes the minimum and the mask, 57 B (84 MB,
// 25 us); a backward reads 2 warps, the target, the mask and a per-pixel
// cotangent and writes 2 gradients, 65 B (96 MB, 29 us). Arithmetic is
// about 150 instructions a pixel, source and channel forward (window sums,
// 5 shuffle pairs, the SSIM terms and one IEEE division) and twice that
// backward, all of it in registers, so what limits the kernels in practice
// is issuing those instructions, not the bytes: on an H100 the identity
// and forward launches run at about half their byte bound (38 and 47 us)
// and the backward at about a quarter (109 us). The backward recomputes
// the forward's windows for 1.2x its rows and 1.14x its columns (the
// halo) and adds the gradient and its 3x3 adjoint; its two divisions by
// the denominator are one reciprocal (IEEE division cost it 60% more), and
// the quotient itself stays an IEEE division, so the clip's ties at 0 and
// 1 fall where the plain version's do.
//
// Design. A warp walks a strip of output rows down the image (4 rows
// forward, 12 backward: shorter strips recompute more halo rows, longer
// ones leave too few warps to hide latency), one column a lane, keeping
// the three rows of its 3x3 windows in registers (the next row is loaded
// one iteration ahead, so its latency hides behind the current row's
// arithmetic). Vertical 3-sums stay in the lane; the horizontal neighbours
// come by __shfl_up/down, so every input byte is read once per strip from
// global memory, coalesced across the warp's 32 neighbouring columns, and
// nothing is staged in shared memory. The forward needs one column of halo
// a side (30 output columns a warp); the target's window statistics are
// computed once for all F sources. The backward gathers: each output pixel
// sums the contributions of the windows over its 5x5 footprint, so it
// needs two columns of halo a side (28 output columns a warp) and one
// source a block (gridDim.z = B * F): per window centre q it forms
// d error / d (sum x, sum x^2, sum xy) from the mask's share of the
// cotangent, then each pixel p adds those of the windows that cover it,
// mirrored windows counted twice at rows and columns 1 and N-2, and forms
// dx = A + 2 x B + y C - 0.05 g sign(y - x). No atomics: a replay gives the
// same bits. F = 1, 2, 3 (mono, stereo, mono+stereo) and the mode are
// template parameters of the forward; the backward takes F at run time,
// since a block holds one source.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 3;        // channels
constexpr int kLanes = 32;   // columns a warp holds
constexpr int kWarps = 4;    // warps a block, stacked down the image
constexpr int kFwdRows = 4;  // output rows a warp walks, forward
constexpr int kBwdRows = 12; // and backward
constexpr unsigned kAll = 0xffffffffu;

enum Mode { kIdentity = 0, kMinAutomask = 1, kMin = 2 };

// float() of the plain version's Python constants, computed in double
// as Python does and rounded once.
constexpr float kC1 = (float)(0.01 * 0.01);
constexpr float kC2 = (float)(0.03 * 0.03);
constexpr float kNinth = (float)(1.0 / 9.0);
constexpr float kThird = 1.0f / 3.0f;  // torch's mean factor on the card
constexpr float kSsim = 0.85f;
constexpr float kL1 = 0.15f;

// The row or column read for index j of an axis of n: the reflect pad's
// -1 -> 1 and n -> n - 2; beyond those, clamped (a halo lane's load that
// no output uses).
__device__ __forceinline__ int mirror(int j, int n) {
  return j == -1 ? 1 : (j == n ? n - 2 : (j < 0 ? 0 : (j >= n ? n - 1 : j)));
}

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

// (left + centre) + right across the warp's lanes, the plain version's
// order for the horizontal sum.
__device__ __forceinline__ float hsum(float v) {
  const float left = __shfl_up_sync(kAll, v, 1);
  const float right = __shfl_down_sync(kAll, v, 1);
  return add(add(left, v), right);
}

// The 3x3 window means of one channel at a window centre.
struct Window {
  float mu, sq, xy;  // mean of x, of x*x, of x*y (x*y only for a source)
};

// Vertical 3-sums of x, x*x and (with y) x*y over rows r-1, r, r+1.
__device__ __forceinline__ Window column_sums(float a, float b, float c) {
  return {add(add(a, b), c), add(add(mul(a, a), mul(b, b)), mul(c, c)), 0.f};
}

__device__ __forceinline__ Window column_sums(float a, float b, float c,
                                              float ya, float yb, float yc) {
  Window w = column_sums(a, b, c);
  w.xy = add(add(mul(a, ya), mul(b, yb)), mul(c, yc));
  return w;
}

// The window means from the vertical sums; the target's have no x*y.
__device__ __forceinline__ Window target_means(Window v) {
  return {mul(hsum(v.mu), kNinth), mul(hsum(v.sq), kNinth), 0.f};
}

__device__ __forceinline__ Window source_means(Window v) {
  return {mul(hsum(v.mu), kNinth), mul(hsum(v.sq), kNinth),
          mul(hsum(v.xy), kNinth)};
}

// The raw SSIM distance (1 - num / den) / 2 before the clip, and the
// terms the backward needs.
struct Ssim {
  float a, b, c, d;  // num = a * b, den = c * d
  float num, den, ratio, half;
};

__device__ __forceinline__ Ssim ssim_terms(Window x, Window y) {
  Ssim s;
  const float sigma_x = sub(x.sq, mul(x.mu, x.mu));
  const float sigma_y = sub(y.sq, mul(y.mu, y.mu));
  const float sigma_xy = sub(x.xy, mul(x.mu, y.mu));
  s.a = add(mul(mul(2.f, x.mu), y.mu), kC1);
  s.b = add(mul(2.f, sigma_xy), kC2);
  s.c = add(add(mul(x.mu, x.mu), mul(y.mu, y.mu)), kC1);
  s.d = add(add(sigma_x, sigma_y), kC2);
  s.num = mul(s.a, s.b);
  s.den = mul(s.c, s.d);
  s.ratio = __fdiv_rn(s.num, s.den);
  s.half = mul(sub(1.f, s.ratio), 0.5f);
  return s;
}

// clip(v, 0, 1) with NaN passed through, as torch.minimum(torch.maximum(
// v, 0), 1).
__device__ __forceinline__ float clip01(float v) {
  const float lo = v < 0.f ? 0.f : v;
  return lo > 1.f ? 1.f : lo;
}

// d clip / d v: 1 inside and for NaN, 0.5 at exactly 0 or 1, 0 outside.
__device__ __forceinline__ float clip01_slope(float v) {
  if (v == 0.f || v == 1.f) return 0.5f;
  return (v < 0.f || v > 1.f) ? 0.f : 1.f;
}

__device__ __forceinline__ float sign_of(float v) {
  return (float)((v > 0.f) - (v < 0.f));
}

// The three channels of pixel (row, col) of image `img` ([H, W, 3] plane
// of one batch entry).
__device__ __forceinline__ void load_pixel(const float* __restrict__ img,
                                           int row, int col, int W,
                                           float (&out)[kC]) {
  const float* p = img + ((int64_t)row * W + col) * kC;
#pragma unroll
  for (int c = 0; c < kC; ++c) out[c] = __ldg(p + c);
}

// One image's three rows around the current one: [0] above, [1] the row,
// [2] below; `ahead` is the row after [2], in flight.
struct Rows3 {
  float v[3][kC];
  float ahead[kC];
};

__device__ __forceinline__ void rows_start(Rows3& r, const float* img, int row,
                                           int col, int H, int W) {
  load_pixel(img, mirror(row - 1, H), col, W, r.v[0]);
  load_pixel(img, mirror(row, H), col, W, r.v[1]);
  load_pixel(img, mirror(row + 1, H), col, W, r.v[2]);
  load_pixel(img, mirror(row + 2, H), col, W, r.ahead);
}

// Move down one row: the row below becomes the current one and the row
// in flight the one below; the next is loaded ahead.
__device__ __forceinline__ void rows_step(Rows3& r, const float* img, int row,
                                          int col, int H, int W) {
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    r.v[0][c] = r.v[1][c];
    r.v[1][c] = r.v[2][c];
    r.v[2][c] = r.ahead[c];
  }
  load_pixel(img, mirror(row + 2, H), col, W, r.ahead);
}

// The forward: MODE kIdentity writes each source's error to out[..., f]
// (F channels a pixel); kMinAutomask and kMin write the minimum over
// [identity + noise (kMinAutomask only), errors] to out and its tie mask.
template <int F, int MODE>
__global__ void __launch_bounds__(kLanes * kWarps)
photometric_min_fwd_kernel(const float* __restrict__ target,
                           const float* __restrict__ s0,
                           const float* __restrict__ s1,
                           const float* __restrict__ s2,
                           const float* __restrict__ identity,
                           const float* __restrict__ noise,
                           float* __restrict__ out,
                           uint8_t* __restrict__ mask, int H, int W) {
  const int lane = threadIdx.x;
  const int row0 = (blockIdx.y * kWarps + threadIdx.y) * kFwdRows;
  if (row0 >= H) return;  // the whole warp
  const int row_end = min(row0 + kFwdRows, H);
  const int col = (int)blockIdx.x * (kLanes - 2) - 1 + lane;
  const int lc = mirror(col, W);
  const bool writes = lane >= 1 && lane <= kLanes - 2 && col < W;
  const int64_t plane = (int64_t)H * W;
  const int64_t b = blockIdx.z;
  const float* srcs[3] = {s0, s1, s2};

  Rows3 y;
  Rows3 x[F];
  rows_start(y, target + b * plane * kC, row0, lc, H, W);
#pragma unroll
  for (int f = 0; f < F; ++f)
    rows_start(x[f], srcs[f] + b * plane * kC, row0, lc, H, W);

  for (int row = row0; row < row_end; ++row) {
    Window wy[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c)
      wy[c] = target_means(column_sums(y.v[0][c], y.v[1][c], y.v[2][c]));
    float err[F];
#pragma unroll
    for (int f = 0; f < F; ++f) {
      float ssim_sum = 0.f, l1_sum = 0.f;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const Window wx = source_means(
            column_sums(x[f].v[0][c], x[f].v[1][c], x[f].v[2][c],
                        y.v[0][c], y.v[1][c], y.v[2][c]));
        const float d = clip01(ssim_terms(wx, wy[c]).half);
        const float l1 = fabsf(sub(y.v[1][c], x[f].v[1][c]));
        ssim_sum = c == 0 ? d : add(ssim_sum, d);
        l1_sum = c == 0 ? l1 : add(l1_sum, l1);
      }
      err[f] = add(mul(kSsim, mul(ssim_sum, kThird)),
                   mul(kL1, mul(l1_sum, kThird)));
    }
    if (writes) {
      const int64_t pix = (b * H + row) * W + col;
      if (MODE == kIdentity) {
#pragma unroll
        for (int f = 0; f < F; ++f) out[pix * F + f] = err[f];
      } else {
        constexpr int n = MODE == kMinAutomask ? 2 * F : F;
        float v[n];
#pragma unroll
        for (int f = 0; f < F; ++f) {
          if (MODE == kMinAutomask) {
            v[f] = add(__ldg(identity + pix * F + f), __ldg(noise + pix * F + f));
            v[F + f] = err[f];
          } else {
            v[f] = err[f];
          }
        }
        float m = v[0];
#pragma unroll
        for (int k = 1; k < n; ++k)
          if (v[k] < m || v[k] != v[k]) m = v[k];
        unsigned bits = 0;
        if (m != m) {
          int first = n - 1;
#pragma unroll
          for (int k = n - 1; k >= 0; --k)
            if (v[k] != v[k]) first = k;
          bits = 0x80u | (1u << first);
        } else {
#pragma unroll
          for (int k = 0; k < n; ++k) bits |= (unsigned)(v[k] == m) << k;
        }
        out[pix] = m;
        mask[pix] = (uint8_t)bits;
      }
    }
    if (row + 1 < row_end) {
      rows_step(y, target + b * plane * kC, row + 1, lc, H, W);
#pragma unroll
      for (int f = 0; f < F; ++f)
        rows_step(x[f], srcs[f] + b * plane * kC, row + 1, lc, H, W);
    }
  }
}

// Per channel, what the error at window centre q passes back to the
// window's three sums, each already times 1/9: d/d sum(x), d/d sum(x*x),
// d/d sum(x*y).
struct Back {
  float mu, sq, xy;
};

__device__ __forceinline__ Back window_grads(Window x, Window y, float g) {
  const Ssim s = ssim_terms(x, y);
  // error = 0.85 * mean_c(d) + ...: d's cotangent, through the clip
  const float gd = mul(mul(mul(kSsim, g), kThird), clip01_slope(s.half));
  const float g_ratio = mul(-0.5f, gd);
  const float g_num = mul(g_ratio, __frcp_rn(s.den));
  const float g_den = -mul(g_num, s.ratio);
  const float g_a = mul(g_num, s.b);
  const float g_b = mul(g_num, s.a);
  const float g_c = mul(g_den, s.d);
  const float g_sigma_x = mul(g_den, s.c);  // d = sigma_x + sigma_y + C2
  const float g_sigma_xy = mul(2.f, g_b);
  // mu_x enters a, c, sigma_x = mean(x*x) - mu_x^2, sigma_xy = mean(xy) - mu_x mu_y
  float g_mu = mul(mul(2.f, y.mu), g_a);
  g_mu = add(g_mu, mul(mul(2.f, x.mu), g_c));
  g_mu = sub(g_mu, mul(mul(2.f, x.mu), g_sigma_x));
  g_mu = sub(g_mu, mul(y.mu, g_sigma_xy));
  return {mul(g_mu, kNinth), mul(g_sigma_x, kNinth), mul(g_sigma_xy, kNinth)};
}

// The adjoint of the reflect-padded 3-sum at index j of an axis of n from
// its neighbours' values (zero outside the axis): the mirrored window
// reads j = 1 twice from centre 0, and j = n - 2 twice from centre n - 1.
__device__ __forceinline__ float adjoint3(float before, float at, float after,
                                          int j, int n) {
  const float b = j == 1 ? add(before, before) : before;
  const float a = j == n - 2 ? add(after, after) : after;
  return add(add(b, at), a);
}

__device__ __forceinline__ float hadjoint(float v, int col, int W) {
  return adjoint3(__shfl_up_sync(kAll, v, 1), v, __shfl_down_sync(kAll, v, 1),
                  col, W);
}

// The backward of one source f = blockIdx.z % F of batch entry
// blockIdx.z / F: dsrc = d (sum over pixels of cot * minimum) / d src.
// nch: the minimum's channels (2F with automasking, else F); the source's
// channel is nch - F + f. cot: one float (cot_scalar) or [B,H,W].
__global__ void __launch_bounds__(kLanes * kWarps)
photometric_min_bwd_kernel(const float* __restrict__ target,
                           const float* __restrict__ s0,
                           const float* __restrict__ s1,
                           const float* __restrict__ s2,
                           const uint8_t* __restrict__ mask,
                           const float* __restrict__ cot, int cot_scalar,
                           float* __restrict__ d0, float* __restrict__ d1,
                           float* __restrict__ d2, int F, int nch, int H,
                           int W) {
  const int lane = threadIdx.x;
  const int row0 = (blockIdx.y * kWarps + threadIdx.y) * kBwdRows;
  if (row0 >= H) return;  // the whole warp
  const int row_end = min(row0 + kBwdRows, H);
  const int f = blockIdx.z % F;
  const int64_t b = blockIdx.z / F;
  const int col = (int)blockIdx.x * (kLanes - 4) - 2 + lane;
  const int lc = mirror(col, W);
  const bool in_image = col >= 0 && col < W;
  const bool writes = lane >= 2 && lane <= kLanes - 3 && col < W;
  const int64_t plane = (int64_t)H * W;
  const float* src = (f == 0 ? s0 : (f == 1 ? s1 : s2)) + b * plane * kC;
  float* dsrc = (f == 0 ? d0 : (f == 1 ? d1 : d2)) + b * plane * kC;
  const float* tgt = target + b * plane * kC;
  const int bit = nch - F + f;

  // window centres q run row0 - 1 .. row_end; the rows q - 1, q, q + 1
  Rows3 x, y;
  rows_start(x, src, row0 - 1, lc, H, W);
  rows_start(y, tgt, row0 - 1, lc, H, W);
  float h_prev[3][kC] = {}, h_cur[3][kC] = {};  // horizontal adjoints, q-2, q-1
  float g_cur = 0.f;                            // the cotangent share at q - 1

  for (int q = row0 - 1; q <= row_end; ++q) {
    float h_new[3][kC] = {};
    float g = 0.f;
    if (q >= 0 && q < H) {  // the whole warp
      const int64_t pix = (b * H + q) * W + lc;
      const float gq = cot_scalar ? __ldg(cot) : __ldg(cot + pix);
      if (nch == 1) {
        g = gq;
      } else {
        const unsigned m = __ldg(mask + pix);
        const bool nan_min = (m & 0x80u) != 0;
        const float on = nan_min ? 0.f : (float)((m >> bit) & 1u);
        const float ties = nan_min ? 0.f : (float)__popc(m);
        g = mul(on, __fdiv_rn(gq, ties));
      }
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const Window wy =
            target_means(column_sums(y.v[0][c], y.v[1][c], y.v[2][c]));
        const Window wx = source_means(column_sums(
            x.v[0][c], x.v[1][c], x.v[2][c], y.v[0][c], y.v[1][c], y.v[2][c]));
        Back k = window_grads(wx, wy, g);
        if (!in_image) k = {0.f, 0.f, 0.f};
        h_new[0][c] = hadjoint(k.mu, col, W);
        h_new[1][c] = hadjoint(k.sq, col, W);
        h_new[2][c] = hadjoint(k.xy, col, W);
      }
    }
    const int p = q - 1;  // the output row whose windows are all in hand
    if (p >= row0 && writes) {
      float* out = dsrc + ((int64_t)p * W + col) * kC;
      const float l1 = mul(mul(kL1, g_cur), kThird);
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const float xs = x.v[0][c], ys = y.v[0][c];  // row p
        const float A = adjoint3(h_prev[0][c], h_cur[0][c], h_new[0][c], p, H);
        const float B = adjoint3(h_prev[1][c], h_cur[1][c], h_new[1][c], p, H);
        const float Cxy = adjoint3(h_prev[2][c], h_cur[2][c], h_new[2][c], p, H);
        float dx = add(A, mul(mul(2.f, xs), B));
        dx = add(dx, mul(ys, Cxy));
        dx = sub(dx, mul(l1, sign_of(sub(ys, xs))));
        out[c] = dx;
      }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        h_prev[k][c] = h_cur[k][c];
        h_cur[k][c] = h_new[k][c];
      }
    g_cur = g;
    if (q + 1 <= row_end) {
      rows_step(x, src, q + 1, lc, H, W);
      rows_step(y, tgt, q + 1, lc, H, W);
    }
  }
}

dim3 blocks(int B, int H, int W, int halo, int rows, int z_per_entry) {
  return dim3((unsigned)((W + kLanes - 2 * halo - 1) / (kLanes - 2 * halo)),
              (unsigned)((H + kWarps * rows - 1) / (kWarps * rows)),
              (unsigned)(B * z_per_entry));
}

template <int MODE>
int launch_fwd(const void* target, const void* s0, const void* s1,
               const void* s2, const void* identity, const void* noise,
               void* out, void* mask, int F, int B, int H, int W,
               void* stream) {
  if (B == 0) return 0;
  if (F < 1 || F > 3 || H < 2 || W < 2) return (int)cudaErrorInvalidValue;
  const dim3 grid = blocks(B, H, W, 1, kFwdRows, 1);
  const dim3 block(kLanes, kWarps);
  const cudaStream_t s = (cudaStream_t)stream;
#define PHOTOMETRIC_FWD(NF)                                              \
  photometric_min_fwd_kernel<NF, MODE><<<grid, block, 0, s>>>(           \
      (const float*)target, (const float*)s0, (const float*)s1,         \
      (const float*)s2, (const float*)identity, (const float*)noise,    \
      (float*)out, (uint8_t*)mask, H, W)
  switch (F) {
    case 1: PHOTOMETRIC_FWD(1); break;
    case 2: PHOTOMETRIC_FWD(2); break;
    default: PHOTOMETRIC_FWD(3); break;
  }
#undef PHOTOMETRIC_FWD
  return (int)cudaGetLastError();
}

}  // namespace

// The identity errors: target and s0..s{F-1} [B,H,W,3], errors [B,H,W,F]
// (contiguous float32; unused source pointers may be null). Returns
// cudaGetLastError(), or cudaErrorInvalidValue for F outside 1..3 or H or
// W under 2.
extern "C" int photometric_identity(const void* target, const void* s0,
                                    const void* s1, const void* s2,
                                    void* errors, int F, int B, int H, int W,
                                    void* stream) {
  return launch_fwd<kIdentity>(target, s0, s1, s2, nullptr, nullptr, errors,
                               nullptr, F, B, H, W, stream);
}

// The per-pixel minimum: target and warps w0..w{F-1} [B,H,W,3]; identity
// and noise [B,H,W,F], or both null (automasking off); minimum [B,H,W]
// float32 and mask [B,H,W] uint8 written. Returns as photometric_identity.
extern "C" int photometric_min_fwd(const void* target, const void* w0,
                                   const void* w1, const void* w2,
                                   const void* identity, const void* noise,
                                   void* minimum, void* mask, int F, int B,
                                   int H, int W, void* stream) {
  if (identity != nullptr)
    return launch_fwd<kMinAutomask>(target, w0, w1, w2, identity, noise,
                                    minimum, mask, F, B, H, W, stream);
  return launch_fwd<kMin>(target, w0, w1, w2, nullptr, nullptr, minimum, mask,
                          F, B, H, W, stream);
}

// The gradient of each warp: target and w0..w{F-1} [B,H,W,3], the
// forward's mask [B,H,W], the minimum's cotangent cot ([B,H,W], or one
// float with cot_scalar), automask as in the forward; d0..d{F-1}
// [B,H,W,3] written. Returns as photometric_identity.
extern "C" int photometric_min_bwd(const void* target, const void* w0,
                                   const void* w1, const void* w2,
                                   const void* mask, const void* cot,
                                   int cot_scalar, void* d0, void* d1,
                                   void* d2, int F, int automask, int B, int H,
                                   int W, void* stream) {
  if (B == 0) return 0;
  if (F < 1 || F > 3 || H < 2 || W < 2) return (int)cudaErrorInvalidValue;
  photometric_min_bwd_kernel<<<blocks(B, H, W, 2, kBwdRows, F), dim3(kLanes, kWarps), 0,
                               (cudaStream_t)stream>>>(
      (const float*)target, (const float*)w0, (const float*)w1,
      (const float*)w2, (const uint8_t*)mask, (const float*)cot, cot_scalar,
      (float*)d0, (float*)d1, (float*)d2, F, automask ? 2 * F : F, H, W);
  return (int)cudaGetLastError();
}
