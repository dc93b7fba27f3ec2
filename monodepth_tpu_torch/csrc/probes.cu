// The warp-gather probes: the building blocks whose cost decides how a
// warp sampler gathers its taps. Four entry points, float32 data and int32
// indices, contiguous, row-major:
//   probe_take_along_axis  out[s,l] = tab[s, idx[s,l]]; an index in [-L, 0)
//                          wraps to idx + L, any other outside [0, L) gives
//                          NaN (jnp.take_along_axis's fill rule);
//   probe_row_gather       out[s,l] = row[s, idx[s,l]] if 0 <= idx < W,
//                          else 0;
//   probe_row_sum          out[0,l] = sum of src[y,l] for y = ymin .. ymax-1
//                          in that order, the bounds read on the device from
//                          lim[0], lim[1] and clamped to [0, H];
//   probe_slab_gather      out[b,r,l] = sum over j < n_y, in j order, of
//                          src[b, 8*(r/8) + j, idx[b,r,l]], each term 0
//                          where idx is outside [0, W).
//
// Replaces: tools/pallas_probe.py, the Pallas kernels of probe_a (P-A),
// probe_b (P-B, the candidate select `_row_gather`), probe_c (P-C, a
// fori_loop with a trip count read from SMEM) and probe_d (P-D, the slab
// loop of n_y candidate row gathers). The TPU has no fast lane gather, so
// those kernels select among 128-lane chunks and walk 8-row slabs. A
// Hopper SM gathers from L1/L2 directly, so each probe here is one thread
// per output element that loads what it needs with __ldg: neighbouring
// threads take neighbouring elements of the last axis, so index reads and
// all writes coalesce. The kernels compute the probes' functions, not
// their block structure.
//
// Bound: memory, or launch latency. P-D at 12x192x640, n_y = 4 reads idx
// and writes out (4 B each per element) and reads at most n_y of every 8
// source rows: 14.7-17.7 MB, 4.4-5.3 us at 3.35 TB/s (H100 SXM); one add
// per term. P-A, P-B and P-C move kilobytes and take the time of a launch.
//
// Sums are explicit __fadd_rn from an accumulator that starts at 0, in the
// order of the Pallas loops, so the results round exactly as the plain
// PyTorch versions in ops/cuda/probes.py do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlab = 8;  // rows per slab of P-D

// P-A (kTakeAlongAxis) and P-B: one thread per output element.
template <bool kTakeAlongAxis>
__global__ void row_gather_kernel(const float* __restrict__ row,
                                  const int* __restrict__ idx,
                                  float* __restrict__ out, int S, int W) {
  const int64_t n = (int64_t)S * W;
  for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; p < n;
       p += (int64_t)gridDim.x * blockDim.x) {
    int i = __ldg(idx + p);
    if (kTakeAlongAxis && i < 0) i += W;
    const float fill = kTakeAlongAxis ? __int_as_float(0x7fc00000) : 0.0f;
    out[p] = (i >= 0 && i < W) ? __ldg(row + (p / W) * W + i) : fill;
  }
}

// P-C: one thread per column; the trip count comes from device memory.
__global__ void row_sum_kernel(const float* __restrict__ src,
                               const int* __restrict__ lim,
                               float* __restrict__ out, int H, int W) {
  const int lo = min(max(__ldg(lim), 0), H);
  const int hi = min(max(__ldg(lim + 1), 0), H);
  for (int l = blockIdx.x * blockDim.x + threadIdx.x; l < W;
       l += gridDim.x * blockDim.x) {
    float acc = 0.0f;
    for (int y = lo; y < hi; ++y) acc = __fadd_rn(acc, __ldg(src + (int64_t)y * W + l));
    out[l] = acc;
  }
}

// P-D: one thread per output element; n_y loads down one column of the
// element's slab.
__global__ void slab_gather_kernel(const float* __restrict__ src,
                                   const int* __restrict__ idx,
                                   float* __restrict__ out, int B, int H,
                                   int W, int n_y) {
  const int64_t hw = (int64_t)H * W;
  const int64_t n = (int64_t)B * hw;
  for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; p < n;
       p += (int64_t)gridDim.x * blockDim.x) {
    const int i = __ldg(idx + p);
    float acc = 0.0f;
    if (i >= 0 && i < W) {
      const int64_t r = (p % hw) / W;
      const float* col = src + (p / hw) * hw + (r - r % kSlab) * W + i;
      for (int j = 0; j < n_y; ++j) acc = __fadd_rn(acc, __ldg(col + (int64_t)j * W));
    }
    out[p] = acc;
  }
}

unsigned launch_blocks(int64_t n, int threads) {
  const int64_t blocks = (n + threads - 1) / threads;
  return (unsigned)(blocks > (1 << 20) ? (1 << 20) : blocks);  // grid-stride beyond
}

constexpr int kThreads = 256;

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError().
// tab, idx, out [S, L].
extern "C" int probe_take_along_axis(const void* tab, const void* idx,
                                     void* out, int S, int L, void* stream) {
  const int64_t n = (int64_t)S * L;
  if (n == 0) return 0;
  row_gather_kernel<true><<<launch_blocks(n, kThreads), kThreads, 0,
                            (cudaStream_t)stream>>>(
      (const float*)tab, (const int*)idx, (float*)out, S, L);
  return (int)cudaGetLastError();
}

// row, idx, out [S, W].
extern "C" int probe_row_gather(const void* row, const void* idx, void* out,
                                int S, int W, void* stream) {
  const int64_t n = (int64_t)S * W;
  if (n == 0) return 0;
  row_gather_kernel<false><<<launch_blocks(n, kThreads), kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const float*)row, (const int*)idx, (float*)out, S, W);
  return (int)cudaGetLastError();
}

// src [H, W], lim [2] (int32, on the device), out [1, W].
extern "C" int probe_row_sum(const void* src, const void* lim, void* out,
                             int H, int W, void* stream) {
  if (W == 0) return 0;
  row_sum_kernel<<<launch_blocks(W, 128), 128, 0, (cudaStream_t)stream>>>(
      (const float*)src, (const int*)lim, (float*)out, H, W);
  return (int)cudaGetLastError();
}

// src, idx, out [B, H, W]; H % 8 == 0 and 1 <= n_y <= 8 (the wrapper checks).
extern "C" int probe_slab_gather(const void* src, const void* idx, void* out,
                                 int B, int H, int W, int n_y, void* stream) {
  const int64_t n = (int64_t)B * H * W;
  if (n == 0) return 0;
  slab_gather_kernel<<<launch_blocks(n, kThreads), kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const float*)src, (const int*)idx, (float*)out, B, H, W, n_y);
  return (int)cudaGetLastError();
}
