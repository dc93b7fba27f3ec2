// Bilinear warp sample for the view-synthesis loss: border padding,
// align_corners=True, NHWC float32. Four entry points:
//   warp_sample_fwd        the eval (no-gradient) form: out;
//   warp_sample_fwd_grads  the train form: out and the tap differences
//                          gx = d out / d wx, gy = d out / d wy;
//   warp_sample_fwd_shifted, warp_sample_fwd_grads_shifted
//                          the same two forms on a row slab of an image
//                          split by rows across ranks (below).
//
// Replaces: monodepth_tpu/ops/pallas/warp_sample.py:_kernel in its
// with_grads=False launch (warp_sample -> _forward -> pl.pallas_call) and
// its with_grads=True launch (_fwd, the custom-VJP forward of
// warp_sample), and in the shifted launches of warp_sample_shifted and
// _fwd_shifted (_forward with row0 and full_height). The TPU kernel walked 8-row slabs and selected among
// candidate rows because a TPU gather is slow; a Hopper SM gathers from
// L1/L2 directly, so each form is one thread per output pixel over all C
// channels, any H, W >= 2.
//
// Bound: memory. Per output pixel the eval form must read the grid (8 B)
// and write C floats; the image (C floats per pixel) is read at least
// once overall. At 640x192, batch 12, C=3: 1,474,560 px x (8 + 12 + 12) B
// = 47.2 MB, 14.1 us at 3.35 TB/s (H100 SXM). The train form also writes
// gx and gy: 1,474,560 px x (8 + 12 + 3 x 12) B = 82.6 MB, 24.6 us.
// Arithmetic is ~30 (eval) and ~50 (train) flops per pixel. Neighbouring
// threads take neighbouring pixels, so grid reads and all writes coalesce
// and the 2x2 taps of a warp-wide run of pixels share cache lines. gx and
// gy are NHWC like dout, so the backward (torch ops) reads all three
// coalesced.
//
// The shifted forms (K3) take a local slab [B, Himg, W, C] of an image of
// `full_height` rows whose first row is the global row `row0` (negative
// on the first shard: the slab starts with halo rows), and a grid
// [B, Hout, W, 2] whose y coordinates are global. y is clipped over
// full_height; the int anchor is clamped to [0, full_height - 2], shifted
// by -row0 and clamped to [0, Himg - 2]. An anchor outside the slab reads
// the slab's edge: memory-safe but wrong, by design, because the caller
// checks that every tap lies in the slab and otherwise takes an exact
// fallback. Where the taps lie in the slab the result is bit for bit that
// of the unshifted form on the full image. Bound at the {spatial: 2}
// 640x192 b12 shard (Hout 96, halo 64, 224-row slab): grid + out per
// output pixel plus the slab once, 35.4 MB (eval form) and 53.1 MB with
// gx and gy, 10.6 and 15.8 us; the rows a smooth field really reads are
// fewer, and chip_smoke.py counts those. The unshifted forms are the
// case row0 = 0, Himg = Hout = full_height.
//
// Semantics (must match ops/cuda/warp_sample.py's plain versions):
//   x = clamp((gx + 1) * 0.5 * (W - 1), 0, W - 1)     (same for y)
//   x0 = clamp(floor(x), 0, W - 2),  wx = x - x0      (float anchor)
//   int anchor = clamp((int)x0, 0, W - 2)             (memory-safe for NaN)
//   top = v00 + (v01 - v00) * wx,  bot = v10 + (v11 - v10) * wx
//   out = top + (bot - top) * wy
//   gx = (1 - wy) * (v01 - v00) + wy * (v11 - v10),  gy = bot - top
// Clamps use comparisons, not fminf/fmaxf, so a NaN coordinate gives NaN
// at its own pixel. Every product and sum is an explicit _rn intrinsic so
// the compiler cannot contract them into FMAs: the kernel then rounds
// exactly as the plain PyTorch version does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float clamp_keep_nan(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int clamp_int(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float lerp_rn(float a, float b, float w) {
  return __fadd_rn(a, __fmul_rn(__fsub_rn(b, a), w));
}

// The pixel's clipped coordinates: weights and the offset of its top-left
// tap in `image`.
struct Taps {
  float wx, wy;
  int64_t offset;
};

// The output rows, the image's rows and where they lie in the full image.
struct Rows {
  int out;   // Hout: grid and output rows
  int img;   // Himg: rows of `image` (a slab, or the whole image)
  int full;  // rows of the full image, over which y is normalized
  int row0;  // global row of image row 0
};

__device__ __forceinline__ Taps pixel_taps(const float* __restrict__ grid,
                                           int64_t p, int64_t hw, Rows rows,
                                           int W, int C) {
  const int64_t b = p / hw;
  const float xmax = (float)(W - 1), ymax = (float)(rows.full - 1);
  const float gx = grid[2 * p];
  const float gy = grid[2 * p + 1];
  const float x = clamp_keep_nan(
      __fmul_rn(__fmul_rn(__fadd_rn(gx, 1.0f), 0.5f), xmax), 0.0f, xmax);
  const float y = clamp_keep_nan(
      __fmul_rn(__fmul_rn(__fadd_rn(gy, 1.0f), 0.5f), ymax), 0.0f, ymax);
  const float x0f = clamp_keep_nan(floorf(x), 0.0f, (float)(W - 2));
  const float y0f = clamp_keep_nan(floorf(y), 0.0f, (float)(rows.full - 2));
  const int x0 = clamp_int((int)x0f, 0, W - 2);
  const int y0 = clamp_int(clamp_int((int)y0f, 0, rows.full - 2) - rows.row0,
                           0, rows.img - 2);
  return {__fsub_rn(x, x0f), __fsub_rn(y, y0f),
          ((b * rows.img + y0) * W + x0) * C};
}

__global__ void warp_sample_fwd_kernel(const float* __restrict__ image,
                                       const float* __restrict__ grid,
                                       float* __restrict__ out,
                                       int B, Rows rows, int W, int C) {
  const int64_t hw = (int64_t)rows.out * W;
  const int64_t n = (int64_t)B * hw;
  for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; p < n;
       p += (int64_t)gridDim.x * blockDim.x) {
    const Taps t = pixel_taps(grid, p, hw, rows, W, C);
    const float* r0 = image + t.offset;
    const float* r1 = r0 + (int64_t)W * C;
    float* o = out + p * C;
    for (int c = 0; c < C; ++c) {
      const float top = lerp_rn(__ldg(r0 + c), __ldg(r0 + C + c), t.wx);
      const float bot = lerp_rn(__ldg(r1 + c), __ldg(r1 + C + c), t.wx);
      o[c] = lerp_rn(top, bot, t.wy);
    }
  }
}

__global__ void warp_sample_fwd_grads_kernel(const float* __restrict__ image,
                                             const float* __restrict__ grid,
                                             float* __restrict__ out,
                                             float* __restrict__ gx,
                                             float* __restrict__ gy,
                                             int B, Rows rows, int W, int C) {
  const int64_t hw = (int64_t)rows.out * W;
  const int64_t n = (int64_t)B * hw;
  for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; p < n;
       p += (int64_t)gridDim.x * blockDim.x) {
    const Taps t = pixel_taps(grid, p, hw, rows, W, C);
    const float* r0 = image + t.offset;
    const float* r1 = r0 + (int64_t)W * C;
    const float vy = __fsub_rn(1.0f, t.wy);
    for (int c = 0; c < C; ++c) {
      const float v00 = __ldg(r0 + c), v01 = __ldg(r0 + C + c);
      const float v10 = __ldg(r1 + c), v11 = __ldg(r1 + C + c);
      const float d0 = __fsub_rn(v01, v00), d1 = __fsub_rn(v11, v10);
      const float top = __fadd_rn(v00, __fmul_rn(d0, t.wx));
      const float bot = __fadd_rn(v10, __fmul_rn(d1, t.wx));
      const int64_t i = p * C + c;
      out[i] = lerp_rn(top, bot, t.wy);
      gx[i] = __fadd_rn(__fmul_rn(vy, d0), __fmul_rn(t.wy, d1));
      gy[i] = __fsub_rn(bot, top);
    }
  }
}

int64_t launch_blocks(int64_t n, int threads) {
  const int64_t blocks = (n + threads - 1) / threads;
  return blocks > (1 << 20) ? (1 << 20) : blocks;  // grid-stride beyond this
}

int launch_fwd(const void* image, const void* grid, void* out, int B,
               Rows rows, int W, int C, void* stream) {
  const int64_t n = (int64_t)B * rows.out * W;
  if (n == 0) return 0;
  const int threads = 256;
  warp_sample_fwd_kernel<<<(unsigned)launch_blocks(n, threads), threads, 0,
                           (cudaStream_t)stream>>>(
      (const float*)image, (const float*)grid, (float*)out, B, rows, W, C);
  return (int)cudaGetLastError();
}

int launch_fwd_grads(const void* image, const void* grid, void* out, void* gx,
                     void* gy, int B, Rows rows, int W, int C, void* stream) {
  const int64_t n = (int64_t)B * rows.out * W;
  if (n == 0) return 0;
  const int threads = 256;
  warp_sample_fwd_grads_kernel<<<(unsigned)launch_blocks(n, threads), threads,
                                 0, (cudaStream_t)stream>>>(
      (const float*)image, (const float*)grid, (float*)out, (float*)gx,
      (float*)gy, B, rows, W, C);
  return (int)cudaGetLastError();
}

}  // namespace

// image [B,H,W,C], grid [B,H,W,2], out [B,H,W,C]: contiguous float32 on
// the current device. Launches on `stream`; returns cudaGetLastError().
extern "C" int warp_sample_fwd(const void* image, const void* grid, void* out,
                               int B, int H, int W, int C, void* stream) {
  return launch_fwd(image, grid, out, B, Rows{H, H, H, 0}, W, C, stream);
}

// As warp_sample_fwd, plus gx, gy [B,H,W,C] (contiguous float32).
extern "C" int warp_sample_fwd_grads(const void* image, const void* grid,
                                     void* out, void* gx, void* gy, int B,
                                     int H, int W, int C, void* stream) {
  return launch_fwd_grads(image, grid, out, gx, gy, B, Rows{H, H, H, 0}, W, C,
                          stream);
}

// K3, eval form. image: the slab [B,Himg,W,C]; grid [B,Hout,W,2] with
// global y over full_height rows; out [B,Hout,W,C]; row0: the global row
// of slab row 0. Contiguous float32; returns cudaGetLastError().
extern "C" int warp_sample_fwd_shifted(const void* image, const void* grid,
                                       void* out, int B, int Himg, int Hout,
                                       int W, int C, int row0, int full_height,
                                       void* stream) {
  return launch_fwd(image, grid, out, B, Rows{Hout, Himg, full_height, row0},
                    W, C, stream);
}

// K3, train form: as warp_sample_fwd_shifted, plus gx, gy [B,Hout,W,C].
extern "C" int warp_sample_fwd_grads_shifted(const void* image,
                                             const void* grid, void* out,
                                             void* gx, void* gy, int B,
                                             int Himg, int Hout, int W, int C,
                                             int row0, int full_height,
                                             void* stream) {
  return launch_fwd_grads(image, grid, out, gx, gy, B,
                          Rows{Hout, Himg, full_height, row0}, W, C, stream);
}
