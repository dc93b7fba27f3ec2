// Bilinear warp sample for the view-synthesis loss: border padding,
// align_corners=True, NHWC float32. Five entry points:
//   warp_sample_fwd        the eval (no-gradient) form: out;
//   warp_sample_fwd_grads  the train form: out and the tap differences
//                          gx = d out / d wx, gy = d out / d wy;
//   warp_sample_fwd_shifted, warp_sample_fwd_grads_shifted
//                          the same two forms on a row slab of an image
//                          split by rows across ranks (below);
//   warp_sample_bwd_grid   the train form's backward: the gradient with
//                          respect to the grid from dout, gx and gy.
//
// Replaces: monodepth_tpu/ops/pallas/warp_sample.py:_kernel in its
// with_grads=False launch (warp_sample -> _forward -> pl.pallas_call) and
// its with_grads=True launch (_fwd, the custom-VJP forward of
// warp_sample), and in the shifted launches of warp_sample_shifted and
// _fwd_shifted (_forward with row0 and full_height). The TPU kernel walked 8-row slabs and selected among
// candidate rows because a TPU gather is slow; a Hopper SM gathers from
// L1/L2 directly, so the eval form is one thread per output pixel over all
// C channels, any H, W >= 2. warp_sample_bwd_grid computes what JAX's
// _grid_vjp (warp_sample.py:340) does in jnp; it has no Pallas kernel.
//
// Bound: memory. Per output pixel the eval form must read the grid (8 B)
// and write C floats; the image (C floats per pixel) is read at least
// once overall. At 640x192, batch 12, C=3: 1,474,560 px x (8 + 12 + 12) B
// = 47.2 MB, 14.1 us at 3.35 TB/s (H100 SXM). The train form also writes
// gx and gy: 1,474,560 px x (8 + 12 + 3 x 12) B = 82.6 MB, 24.6 us. The
// backward reads grid, dout, gx, gy and writes dgrid: 52 B/px, 76.7 MB,
// 22.9 us. Arithmetic is ~30 (eval), ~50 (train) and ~20 (backward) flops
// per pixel.
//
// The train form takes 2 consecutive pixels a thread (of the flattened
// [B, Hout, W] index), the backward 4. One pixel a thread behind its
// dependent coordinate load left each thread a single chain of loads,
// which is latency-bound even with the data in L2 (the probe P-D,
// csrc/probes.cu). A thread loads its pixels' grid in one 16-byte read,
// computes the 2 anchors, then issues all 2 x 4 x C tap loads before
// their first use (24 independent loads at C = 3), and writes out, gx and
// gy in 8-byte stores. On an H100 2 pixels a thread ran faster than 4 (40
// against 51 registers, so more threads resident: PERF.md). The backward
// streams 2 + 3C 16-byte loads and 2 16-byte stores for each 4 pixels.
// C = 3 is compiled as a constant;
// other C take a runtime-C instantiation. A ragged last group of pixels,
// or a pointer that is not 16-byte aligned (the wrapper passes the flag),
// takes a one-pixel-at-a-time path inside the same kernel. Neighbouring
// threads take neighbouring pixels, so all streams coalesce and the 2x2
// taps of a warp-wide run of pixels share cache lines.
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
// Backward, per pixel (JAX's _grid_vjp, the jnp.clip tie rule):
//   dwx = sum_c dout * gx, dwy = sum_c dout * gy      (channel order 0..C-1)
//   u = (g + 1) * 0.5 * (size - 1),  size = W for x, full_height for y
//   slope = ((0 < u < size - 1) + 0.5 * (u == 0 || u == size - 1))
//           * (0.5 * (size - 1))                      (0 for NaN)
//   dgrid = (dwx * slope_x, dwy * slope_y)
// Clamps use comparisons, not fminf/fmaxf, so a NaN coordinate gives NaN
// at its own pixel. Every product and sum is an explicit _rn intrinsic so
// the compiler cannot contract them into FMAs: the kernel then rounds
// exactly as the plain PyTorch version does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFwdPixels = 2;     // the train form's pixels a thread
constexpr int kFwdThreads = 256;  // and threads a block
constexpr int kBwdPixels = 4;     // the backward's pixels a thread
constexpr int kBwdThreads = 256;  // and threads a block

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

// Taps of the pixel with grid coordinates (gx, gy) in batch entry b.
__device__ __forceinline__ Taps pixel_taps(float gx, float gy, int64_t b,
                                           Rows rows, int W, int C) {
  const float xmax = (float)(W - 1), ymax = (float)(rows.full - 1);
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

// Taps of the flat output pixel p (hw = Hout * W pixels per batch entry).
__device__ __forceinline__ Taps pixel_taps(const float* __restrict__ grid,
                                           int64_t p, int64_t hw, Rows rows,
                                           int W, int C) {
  return pixel_taps(grid[2 * p], grid[2 * p + 1], p / hw, rows, W, C);
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

// out, gx, gy of one channel from its four taps (the train form's
// formulas and order).
struct Blend {
  float out, gx, gy;
};

__device__ __forceinline__ Blend blend_grads(float v00, float v01, float v10,
                                             float v11, float wx, float wy) {
  const float d0 = __fsub_rn(v01, v00), d1 = __fsub_rn(v11, v10);
  const float top = __fadd_rn(v00, __fmul_rn(d0, wx));
  const float bot = __fadd_rn(v10, __fmul_rn(d1, wx));
  const float vy = __fsub_rn(1.0f, wy);
  return {lerp_rn(top, bot, wy), __fadd_rn(__fmul_rn(vy, d0), __fmul_rn(wy, d1)),
          __fsub_rn(bot, top)};
}

// N consecutive floats from a 16-byte aligned `src` (N % 4 == 0).
template <int N>
__device__ __forceinline__ void load_vec(const float* __restrict__ src,
                                         float* v) {
  static_assert(N % 4 == 0, "16-byte loads");
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(src) + i);
    v[4 * i] = f.x;
    v[4 * i + 1] = f.y;
    v[4 * i + 2] = f.z;
    v[4 * i + 3] = f.w;
  }
}

// N consecutive floats to `dst`, in 16-byte stores where N % 4 == 0 (dst
// 16-byte aligned), else 8-byte ones (N even, dst 8-byte aligned).
template <int N>
__device__ __forceinline__ void store_vec(float* __restrict__ dst,
                                          const float* v) {
  static_assert(N % 2 == 0, "8- or 16-byte stores");
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      reinterpret_cast<float4*>(dst)[i] =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i)
      reinterpret_cast<float2*>(dst)[i] = make_float2(v[2 * i], v[2 * i + 1]);
  }
}

// The train form, PX pixels a thread. CT > 0: C = CT, a compile-time
// constant; CT == 0: C from the argument. `vector`: every pointer but the
// image's is 16-byte aligned.
template <int CT, int PX>
__global__ void __launch_bounds__(kFwdThreads)
warp_sample_fwd_grads_kernel(const float* __restrict__ image,
                             const float* __restrict__ grid,
                             float* __restrict__ out, float* __restrict__ gx,
                             float* __restrict__ gy, int B, Rows rows, int W,
                             int C_arg, bool vector) {
  const int C = CT > 0 ? CT : C_arg;
  const int64_t hw = (int64_t)rows.out * W;
  const int64_t n = (int64_t)B * hw;
  const int64_t row = (int64_t)W * C;
  for (int64_t p0 = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * PX;
       p0 < n; p0 += (int64_t)gridDim.x * blockDim.x * PX) {
    if (!vector || p0 + PX > n) {  // one pixel at a time
      for (int64_t p = p0; p < p0 + PX && p < n; ++p) {
        const Taps t = pixel_taps(grid, p, hw, rows, W, C);
        const float* r0 = image + t.offset;
        const float* r1 = r0 + row;
        for (int c = 0; c < C; ++c) {
          const Blend v = blend_grads(__ldg(r0 + c), __ldg(r0 + C + c),
                                      __ldg(r1 + c), __ldg(r1 + C + c), t.wx, t.wy);
          const int64_t i = p * C + c;
          out[i] = v.out;
          gx[i] = v.gx;
          gy[i] = v.gy;
        }
      }
      continue;
    }
    float g[2 * PX];
    load_vec<2 * PX>(grid + 2 * p0, g);
    Taps t[PX];
    int64_t b = p0 / hw, r = p0 - b * hw;
#pragma unroll
    for (int k = 0; k < PX; ++k) {
      t[k] = pixel_taps(g[2 * k], g[2 * k + 1], b, rows, W, C);
      if (++r == hw) {
        r = 0;
        ++b;
      }
    }
    if constexpr (CT > 0) {
      // every tap load of the thread's pixels in flight before the first use
      float v[PX][4][CT];
#pragma unroll
      for (int k = 0; k < PX; ++k) {
        const float* r0 = image + t[k].offset;
        const float* r1 = r0 + row;
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          v[k][0][c] = __ldg(r0 + c);
          v[k][1][c] = __ldg(r0 + CT + c);
          v[k][2][c] = __ldg(r1 + c);
          v[k][3][c] = __ldg(r1 + CT + c);
        }
      }
      float o[PX * CT], ax[PX * CT], ay[PX * CT];
#pragma unroll
      for (int k = 0; k < PX; ++k) {
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          const Blend e = blend_grads(v[k][0][c], v[k][1][c], v[k][2][c],
                                      v[k][3][c], t[k].wx, t[k].wy);
          o[k * CT + c] = e.out;
          ax[k * CT + c] = e.gx;
          ay[k * CT + c] = e.gy;
        }
      }
      store_vec<PX * CT>(out + p0 * CT, o);
      store_vec<PX * CT>(gx + p0 * CT, ax);
      store_vec<PX * CT>(gy + p0 * CT, ay);
    } else {
      for (int c = 0; c < C; ++c) {
        float v[PX][4];
#pragma unroll
        for (int k = 0; k < PX; ++k) {
          const float* r0 = image + t[k].offset;
          const float* r1 = r0 + row;
          v[k][0] = __ldg(r0 + c);
          v[k][1] = __ldg(r0 + C + c);
          v[k][2] = __ldg(r1 + c);
          v[k][3] = __ldg(r1 + C + c);
        }
#pragma unroll
        for (int k = 0; k < PX; ++k) {
          const Blend e = blend_grads(v[k][0], v[k][1], v[k][2], v[k][3],
                                      t[k].wx, t[k].wy);
          const int64_t i = (p0 + k) * C + c;
          out[i] = e.out;
          gx[i] = e.gx;
          gy[i] = e.gy;
        }
      }
    }
  }
}

// d w / d g of one axis: the jnp.clip derivative of the unnormalized
// coordinate (1 inside, 0.5 on a bound, 0 outside and for NaN) times
// 0.5 * (size - 1).
__device__ __forceinline__ float clip_slope(float g, int size) {
  const float top = (float)(size - 1);
  const float u = __fmul_rn(__fmul_rn(__fadd_rn(g, 1.0f), 0.5f), top);
  const float inside = (u > 0.0f && u < top) ? 1.0f : 0.0f;
  const float tie = (u == 0.0f || u == top) ? 1.0f : 0.0f;
  return __fmul_rn(__fadd_rn(inside, __fmul_rn(0.5f, tie)), __fmul_rn(0.5f, top));
}

// sum_c a[c] * b[c] in channel order, from the first product.
template <int N>
__device__ __forceinline__ float dot_rn(const float* a, const float* b) {
  float s = __fmul_rn(a[0], b[0]);
#pragma unroll
  for (int c = 1; c < N; ++c) s = __fadd_rn(s, __fmul_rn(a[c], b[c]));
  return s;
}

__device__ __forceinline__ float dot_rn(const float* __restrict__ a,
                                        const float* __restrict__ b, int n) {
  float s = __fmul_rn(__ldg(a), __ldg(b));
  for (int c = 1; c < n; ++c) s = __fadd_rn(s, __fmul_rn(__ldg(a + c), __ldg(b + c)));
  return s;
}

// The backward, PX pixels a thread; CT and `vector` as in the train form.
template <int CT, int PX>
__global__ void __launch_bounds__(kBwdThreads)
warp_sample_bwd_grid_kernel(const float* __restrict__ grid,
                            const float* __restrict__ dout,
                            const float* __restrict__ gx,
                            const float* __restrict__ gy,
                            float* __restrict__ dgrid, int64_t n, int W,
                            int full_height, int C_arg, bool vector) {
  const int C = CT > 0 ? CT : C_arg;
  for (int64_t p0 = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * PX;
       p0 < n; p0 += (int64_t)gridDim.x * blockDim.x * PX) {
    if (!vector || p0 + PX > n) {  // one pixel at a time
      for (int64_t p = p0; p < p0 + PX && p < n; ++p) {
        const int64_t i = p * C;
        dgrid[2 * p] = __fmul_rn(dot_rn(dout + i, gx + i, C),
                                 clip_slope(__ldg(grid + 2 * p), W));
        dgrid[2 * p + 1] = __fmul_rn(dot_rn(dout + i, gy + i, C),
                                     clip_slope(__ldg(grid + 2 * p + 1), full_height));
      }
      continue;
    }
    float g[2 * PX], d[2 * PX];
    load_vec<2 * PX>(grid + 2 * p0, g);
    if constexpr (CT > 0) {
      float o[PX * CT], a[PX * CT], e[PX * CT];
      load_vec<PX * CT>(dout + p0 * CT, o);
      load_vec<PX * CT>(gx + p0 * CT, a);
      load_vec<PX * CT>(gy + p0 * CT, e);
#pragma unroll
      for (int k = 0; k < PX; ++k) {
        d[2 * k] = __fmul_rn(dot_rn<CT>(o + k * CT, a + k * CT),
                             clip_slope(g[2 * k], W));
        d[2 * k + 1] = __fmul_rn(dot_rn<CT>(o + k * CT, e + k * CT),
                                 clip_slope(g[2 * k + 1], full_height));
      }
    } else {
#pragma unroll
      for (int k = 0; k < PX; ++k) {
        const int64_t i = (p0 + k) * C;
        d[2 * k] = __fmul_rn(dot_rn(dout + i, gx + i, C), clip_slope(g[2 * k], W));
        d[2 * k + 1] = __fmul_rn(dot_rn(dout + i, gy + i, C),
                                 clip_slope(g[2 * k + 1], full_height));
      }
    }
    store_vec<2 * PX>(dgrid + 2 * p0, d);
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
                     void* gy, int B, Rows rows, int W, int C, int aligned,
                     void* stream) {
  const int64_t n = (int64_t)B * rows.out * W;
  if (n == 0) return 0;
  const unsigned blocks =
      (unsigned)launch_blocks((n + kFwdPixels - 1) / kFwdPixels, kFwdThreads);
  const cudaStream_t s = (cudaStream_t)stream;
  if (C == 3)
    warp_sample_fwd_grads_kernel<3, kFwdPixels><<<blocks, kFwdThreads, 0, s>>>(
        (const float*)image, (const float*)grid, (float*)out, (float*)gx,
        (float*)gy, B, rows, W, C, aligned != 0);
  else
    warp_sample_fwd_grads_kernel<0, kFwdPixels><<<blocks, kFwdThreads, 0, s>>>(
        (const float*)image, (const float*)grid, (float*)out, (float*)gx,
        (float*)gy, B, rows, W, C, aligned != 0);
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
// aligned: grid, out, gx and gy all start on 16 bytes.
extern "C" int warp_sample_fwd_grads(const void* image, const void* grid,
                                     void* out, void* gx, void* gy, int B,
                                     int H, int W, int C, int aligned,
                                     void* stream) {
  return launch_fwd_grads(image, grid, out, gx, gy, B, Rows{H, H, H, 0}, W, C,
                          aligned, stream);
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

// K3, train form: as warp_sample_fwd_shifted, plus gx, gy [B,Hout,W,C];
// aligned as in warp_sample_fwd_grads.
extern "C" int warp_sample_fwd_grads_shifted(const void* image,
                                             const void* grid, void* out,
                                             void* gx, void* gy, int B,
                                             int Himg, int Hout, int W, int C,
                                             int row0, int full_height,
                                             int aligned, void* stream) {
  return launch_fwd_grads(image, grid, out, gx, gy, B,
                          Rows{Hout, Himg, full_height, row0}, W, C, aligned,
                          stream);
}

// The backward: grid [B,Hout,W,2], dout, gx, gy [B,Hout,W,C] -> dgrid
// [B,Hout,W,2], y normalized over full_height rows (Hout for the
// same-size warp, the full image's height for a slab). Contiguous
// float32; aligned: all five pointers start on 16 bytes. Returns
// cudaGetLastError().
extern "C" int warp_sample_bwd_grid(const void* grid, const void* dout,
                                    const void* gx, const void* gy, void* dgrid,
                                    int B, int Hout, int W, int C,
                                    int full_height, int aligned, void* stream) {
  const int64_t n = (int64_t)B * Hout * W;
  if (n == 0) return 0;
  const unsigned blocks =
      (unsigned)launch_blocks((n + kBwdPixels - 1) / kBwdPixels, kBwdThreads);
  const cudaStream_t s = (cudaStream_t)stream;
  if (C == 3)
    warp_sample_bwd_grid_kernel<3, kBwdPixels><<<blocks, kBwdThreads, 0, s>>>(
        (const float*)grid, (const float*)dout, (const float*)gx,
        (const float*)gy, (float*)dgrid, n, W, full_height, C, aligned != 0);
  else
    warp_sample_bwd_grid_kernel<0, kBwdPixels><<<blocks, kBwdThreads, 0, s>>>(
        (const float*)grid, (const float*)dout, (const float*)gx,
        (const float*)gy, (float*)dgrid, n, W, full_height, C, aligned != 0);
  return (int)cudaGetLastError();
}
