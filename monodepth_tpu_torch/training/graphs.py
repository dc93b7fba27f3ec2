"""The steps as CUDA graphs: the port's counterpart of JAX's `jax.jit`
regions.

Each JAX entry point is one jitted program, so each call is one dispatch:
the train step (`monodepth_tpu/training/step.py:334`), K train steps as
one `lax.scan` (`:352`, `--steps_per_call`), the eval step (`:376`) and
the infer step (`:393`). Run eagerly, the port's train step issues some
5,100 kernel launches from Python a call, and the card waits between
them. `GraphedStep` captures a step's body once per input signature and
then replays it: one graph launch a call. The step makers of
`training/step.py` use it on a card (`graph=None`) without a mesh and on
any mesh over NCCL, as JAX's `jax.jit` on a mesh is one dispatch with
GSPMD's collectives inside. A gloo mesh stays eager: gloo's collectives
run on host tensors. A captured spatial mesh's warps take no branch: each
gathers its group's rows and warps them exactly (`training.step`
`_spatial_sampler`), where the eager step reads the group's slab flag on
the host and JAX branches on the device with `lax.cond`.

What a captured step needs, and where it is done:
- static inputs: the inputs are a tree of dicts, lists and tensors (or
  Python floats, which become 0-d f32 tensors); a capture is keyed on the
  tree's keys, shapes and dtypes, as `jax.jit` traces once per shape, and
  on cuDNN's and cuBLAS's switches, which pick the kernels a capture
  keeps. Every call copies its inputs into its key's buffers on the
  current stream.
- warm-up: a key's first call runs the body eagerly on a side stream.
  It is a real call: its updates stay and its outputs are returned. The
  second call captures, then replays.
- outputs: every call returns clones, so the next replay cannot change
  what a caller kept (the Trainer's `_Meter` keeps the first value it sees
  by reference).
- Python side effects of the body happen once, while it is captured. What
  must change per call comes in as an input (the step makers pass the
  tie-break noise, drawn by the host's generators, and the learning
  rates). After a capture the counters of `COUNTED` (the kernel
  wrappers' launches, the spatial warps') and `state.step` are put back,
  and every replay advances them by what the capture recorded, so the
  counters go on counting kernel executions.
- bound tensors: a graph holds the addresses of the tensors the body
  reads and updates in place (parameters, buffers, gradients, optimizer
  state). They are read at every call; if one moved since the key was
  captured (a restore replaces Adam's moments; another key's capture
  made new gradients), the key is captured again, so no replay works on
  memory that is no longer the state's.
- capture_error_mode "thread_local": a CUDA call from another thread
  (the loader's, the async checkpoint writer's, NCCL's watchdog querying
  the events of eager collectives) cannot break a capture.
- a capture that fails raises; nothing falls back to the eager step.
- `torch.profiler` ranges: "graphed_step/warm_up", "graphed_step/capture"
  (so a capture shows in any trace) and "graphed_step/stage", the copy of
  a call's inputs into its buffers.

Collectives (NCCL). A captured NCCL collective is a
node of the graph, issued on the process group's internal stream, which
the capture forks from and joins back to the capturing stream; its
communicator must exist before the capture, which the warm-up call makes
sure of (it runs the collectives eagerly on the side stream; the step
makers' callers also run `parallel.mesh.warm_collectives`). The body
reads nothing back to the host and issues its collectives in one order
on every rank, so a replay issues the warm-up's collectives in the
warm-up's order, and every call runs each of them once on every rank: a
warm-up runs them eagerly, a capture records them without running them
and then replays. A key is captured again on every rank in the same
call: its bound tensors move only through calls that every rank makes
alike, in the same order (each rank has the same keys, so another key's
capture makes new gradients on every rank at once; the Trainer restores
the same checkpoint on every rank in the same call, and each restore
allocates Adam's moments anew while the old ones are still alive, so
they move on every rank).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch
from torch.profiler import record_function

from monodepth_tpu_torch.ops.cuda import photometric as ph
from monodepth_tpu_torch.ops.cuda import warp_sample as ws

Tensor = torch.Tensor

# the counters a replay advances, (owner, attribute): the kernel wrappers'
# launches; `training.step` adds the spatial warps' calls
COUNTED: List[Tuple[Any, str]] = [
    (w, "launches") for w in (ws.warp_sample, ws.warp_sample_grads,
                              ws.warp_sample_shifted, ws.warp_sample_grads_shifted,
                              ws.grid_vjp, ph.identity_errors, ph.photometric_min,
                              ph.photometric_min_grads)]


def _signature(tree) -> Any:
    if isinstance(tree, dict):
        return tuple((k, _signature(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return (len(tree),) + tuple(_signature(v) for v in tree)
    if isinstance(tree, float):
        return float
    return tuple(tree.shape), tree.dtype


def _backend_switches() -> Tuple[bool, ...]:
    return (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
            torch.are_deterministic_algorithms_enabled())


def _map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _empty(tree, device: torch.device):
    def empty(leaf):
        if isinstance(leaf, float):
            return torch.empty((), dtype=torch.float32, device=device)
        return torch.empty(leaf.shape, dtype=leaf.dtype, device=device)

    return _map(empty, tree)


def _copy_into(static, tree) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _copy_into(static[k], v)
    elif isinstance(tree, (list, tuple)):
        for s, v in zip(static, tree):
            _copy_into(s, v)
    elif isinstance(tree, float):
        static.fill_(tree)
    else:
        static.copy_(tree)


def _addresses(tensors: Sequence[Tensor | None]) -> List[int]:
    return [0 if t is None else t.data_ptr() for t in tensors]


@dataclasses.dataclass
class _Capture:
    graph: Any             # torch.cuda.CUDAGraph
    static: Any            # the input buffers
    out: Any               # the output buffers
    counts: List[Tuple[Tuple[Any, str], int]]  # ((fn, attr), its count a replay)
    binding: List[int]     # the bound tensors' addresses


class GraphedStep:
    """`body(inputs)` -> a tree of tensors, run as a CUDA graph on `device`
    (module docstring). `bound()` lists the tensors whose addresses a
    capture holds (None entries allowed: a missing gradient)."""

    def __init__(self, body: Callable[[Any], Any], device: torch.device,
                 bound: Callable[[], Sequence[Tensor | None]]):
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, not {device}")
        self.body = body
        self.device = device
        self.bound = bound
        self.stream = torch.cuda.Stream(device)
        self.warm: set = set()
        self.captures: Dict[Any, _Capture] = {}

    def __call__(self, inputs, state=None, steps: int = 0):
        """Run the body on `inputs` (host or device tensors, floats);
        `steps`: how far one call advances `state.step`."""
        key = (_signature(inputs), _backend_switches())
        if key not in self.warm:
            with record_function("graphed_step/warm_up"):
                out = self._warm_up(inputs)
            self.warm.add(key)
            return out
        capture = self.captures.get(key)
        if capture is not None and _addresses(self.bound()) != capture.binding:
            del self.captures[key], capture  # free its pool before capturing
            capture = None
        if capture is None:
            with record_function("graphed_step/capture"):
                capture = self.captures[key] = self._capture(inputs, state)
        with record_function("graphed_step/stage"):
            _copy_into(capture.static, inputs)
        capture.graph.replay()
        for (fn, attr), n in capture.counts:
            setattr(fn, attr, getattr(fn, attr) + n)
        if state is not None:
            state.step += steps
        return _map(torch.clone, capture.out)

    def _warm_up(self, inputs):
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            args = _empty(inputs, self.device)
            _copy_into(args, inputs)
            out = self.body(args)
        current.wait_stream(self.stream)
        return out

    def _capture(self, inputs, state) -> _Capture:
        static = _empty(inputs, self.device)
        counters = list(COUNTED)
        before = [getattr(fn, attr) for fn, attr in counters]
        step = None if state is None else state.step
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, stream=self.stream,
                                  capture_error_mode="thread_local"):
                out = self.body(static)
        finally:
            counts = [((fn, attr), getattr(fn, attr) - n)
                      for (fn, attr), n in zip(counters, before) if getattr(fn, attr) != n]
            for (fn, attr), n in zip(counters, before):
                setattr(fn, attr, n)
            if state is not None:
                state.step = step
        return _Capture(graph, static, out, counts, _addresses(self.bound()))
