// Phase marks of the train step: one empty kernel per phase boundary.
//
// Replaces no TPU kernel. A CUDA graph replay carries none of the host's
// profiler ranges, but the device trace records every kernel node of a
// replay by name, so the step launches one of these kernels where each
// of its phases begins (monodepth_tpu_torch/training/phases.py), and a
// capture keeps them as nodes of the graph. A trace then cuts a replay
// into phases by the marks' names alone: a phase runs from the end of its
// mark to the start of the next.
//
// Bound: none. Each mark is 1 thread of 1 block with an empty body that
// touches no memory: its cost is one graph node, a launch's latency
// (about a microsecond on an H100), nine a step. The names are unmangled
// (extern "C") and hold none of the patterns by which the benchmark sorts
// kernels into classes (benchmark/kernel_classes.json).

#include <cuda_runtime.h>

extern "C" __global__ void phase_mark_decode() {}
extern "C" __global__ void phase_mark_networks_fwd() {}
extern "C" __global__ void phase_mark_loss_fwd() {}
extern "C" __global__ void phase_mark_loss_bwd() {}
extern "C" __global__ void phase_mark_networks_bwd() {}
extern "C" __global__ void phase_mark_grad_sync() {}
extern "C" __global__ void phase_mark_optimizer() {}
extern "C" __global__ void phase_mark_metrics() {}
extern "C" __global__ void phase_mark_end() {}

// Launch mark `phase` (its index in phases.PHASES, the order above) on
// `stream`; returns cudaGetLastError(), or cudaErrorInvalidValue for an
// index outside 0..8.
extern "C" int phase_mark(int phase, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (phase) {
    case 0: phase_mark_decode<<<1, 1, 0, s>>>(); break;
    case 1: phase_mark_networks_fwd<<<1, 1, 0, s>>>(); break;
    case 2: phase_mark_loss_fwd<<<1, 1, 0, s>>>(); break;
    case 3: phase_mark_loss_bwd<<<1, 1, 0, s>>>(); break;
    case 4: phase_mark_networks_bwd<<<1, 1, 0, s>>>(); break;
    case 5: phase_mark_grad_sync<<<1, 1, 0, s>>>(); break;
    case 6: phase_mark_optimizer<<<1, 1, 0, s>>>(); break;
    case 7: phase_mark_metrics<<<1, 1, 0, s>>>(); break;
    case 8: phase_mark_end<<<1, 1, 0, s>>>(); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
