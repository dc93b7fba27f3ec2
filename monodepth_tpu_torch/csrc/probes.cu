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
// Hopper SM gathers from L1/L2 and shared memory directly. P-A..P-C are
// one thread per output element that loads what it needs with __ldg:
// neighbouring threads take neighbouring elements of the last axis, so
// index reads and all writes coalesce. The kernels compute the probes'
// functions, not their block structure.
//
// Bound. P-D at 12x192x640, n_y = 4 reads idx and writes out (4 B each per
// element) and reads n_y of every 8 source rows once: 14.7 MB, 4.4 us at
// 3.35 TB/s (H100 SXM); one add per term. A thread per element, with one
// 4-byte index load, n_y dependent 4-byte loads through L1/L2 and one
// 4-byte store, kept a few KB in flight per SM where the memory rate needs
// some 20 KB, and fetched each source element once per output row that
// used it: latency-bound at 29% of the bound. So P-D is one block per 2
// output rows (4 blocks a slab, 1,152 at the probe's shape: one wave, no
// tail). Its first thread copies the slab's n_y source rows into shared
// memory with one bulk copy (cp.async.bulk, completing on an mbarrier)
// while every thread loads its indices as int4, 16 bytes a row, all before
// the first use; the n_y gathers a term then read shared memory, and each
// thread stores 4 outputs as one float4. A block holds n_y whole rows:
// 16 + 4 * n_y * W bytes within the 232,448 of a Hopper block (W <= 7,168
// at n_y = 8 with W % 128 == 0; the wrapper raises beyond). The bulk copy,
// int4 and float4 need 16-byte aligned src, idx and out (the wrapper
// raises otherwise). P-A, P-B and P-C move kilobytes and take the time of
// a launch.
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

// P-D: one block per kSlabRows output rows of a slab. The slab's n_y source
// rows arrive in shared memory by one bulk copy while the threads load
// their indices; each thread then takes 4 neighbouring columns of each of
// the block's rows: one int4 of indices, NY gathers from shared memory per
// output, one float4 store.
constexpr int kSlabRows = 2;       // output rows a block: 4 blocks a slab
constexpr int kSlabThreads = 256;  // most threads a block; W / 4 when fewer
constexpr int kBarrierBytes = 16;  // the mbarrier, ahead of the rows

__device__ __forceinline__ float slab_term(const float* rows, int j, int W, int i) {
  const bool inside = (unsigned)i < (unsigned)W;
  const float v = rows[j * W + (inside ? i : 0)];
  return inside ? v : 0.0f;
}

template <int NY>
__device__ __forceinline__ float slab_sum(const float* rows, int W, int i) {
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < NY; ++j) acc = __fadd_rn(acc, slab_term(rows, j, W, i));
  return acc;
}

template <int NY>
__global__ void __launch_bounds__(kSlabThreads)
slab_gather_kernel(const float* __restrict__ src, const int* __restrict__ idx,
                   float* __restrict__ out, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  const float* rows = reinterpret_cast<const float*>(smem + kBarrierBytes);
  const uint32_t bar = (uint32_t)__cvta_generic_to_shared(smem);
  // output rows row0 .. row0 + kSlabRows - 1 of the [B * H, W] view; a slab
  // never crosses an image since H % 8 == 0
  const int64_t row0 = (int64_t)blockIdx.x * kSlabRows;
  if (threadIdx.x == 0) {
    const uint32_t bytes = (uint32_t)(NY * W * sizeof(float));
    const uint32_t dst = (uint32_t)__cvta_generic_to_shared(rows);
    const float* from = src + (row0 - row0 % kSlab) * W;
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];"
        :: "r"(dst), "l"(from), "r"(bytes), "r"(bar) : "memory");
  }
  __syncthreads();  // the barrier is initialised before anyone waits on it

  const int cols = W / 4;  // int4 / float4 columns a row
  const int4* idx4 = reinterpret_cast<const int4*>(idx + row0 * W);
  float4* out4 = reinterpret_cast<float4*>(out + row0 * W);
  bool staged = false;
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    int4 id[kSlabRows];
#pragma unroll
    for (int k = 0; k < kSlabRows; ++k) id[k] = __ldg(idx4 + k * cols + c);
    if (!staged) {  // wait for the slab (phase 0 of the barrier)
      uint32_t done = 0;
      while (!done) {
        asm volatile(
            "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
            "selp.u32 %0, 1, 0, p; }"
            : "=r"(done) : "r"(bar), "r"(0) : "memory");
      }
      staged = true;
    }
#pragma unroll
    for (int k = 0; k < kSlabRows; ++k) {
      out4[k * cols + c] = make_float4(slab_sum<NY>(rows, W, id[k].x),
                                       slab_sum<NY>(rows, W, id[k].y),
                                       slab_sum<NY>(rows, W, id[k].z),
                                       slab_sum<NY>(rows, W, id[k].w));
    }
  }
}

template <int NY>
int launch_slab_gather(const float* src, const int* idx, float* out,
                       int64_t rows, int W, cudaStream_t stream) {
  const int smem = kBarrierBytes + NY * W * (int)sizeof(float);
  if (smem > 48 * 1024) {  // above the default, by request
    const cudaError_t err = cudaFuncSetAttribute(
        slab_gather_kernel<NY>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = W / 4 < kSlabThreads ? W / 4 : kSlabThreads;
  slab_gather_kernel<NY><<<(unsigned)(rows / kSlabRows), threads, smem, stream>>>(
      src, idx, out, W);
  return (int)cudaGetLastError();
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

// src, idx, out [B, H, W], 16-byte aligned; H % 8 == 0, W % 128 == 0,
// 1 <= n_y <= 8 and 16 + 4 * n_y * W bytes of shared memory (the wrapper
// checks).
extern "C" int probe_slab_gather(const void* src, const void* idx, void* out,
                                 int B, int H, int W, int n_y, void* stream) {
  const int64_t rows = (int64_t)B * H;
  if (rows * W == 0) return 0;
  const float* s = (const float*)src;
  const int* i = (const int*)idx;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (n_y) {
    case 1: return launch_slab_gather<1>(s, i, o, rows, W, st);
    case 2: return launch_slab_gather<2>(s, i, o, rows, W, st);
    case 3: return launch_slab_gather<3>(s, i, o, rows, W, st);
    case 4: return launch_slab_gather<4>(s, i, o, rows, W, st);
    case 5: return launch_slab_gather<5>(s, i, o, rows, W, st);
    case 6: return launch_slab_gather<6>(s, i, o, rows, W, st);
    case 7: return launch_slab_gather<7>(s, i, o, rows, W, st);
    case 8: return launch_slab_gather<8>(s, i, o, rows, W, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
