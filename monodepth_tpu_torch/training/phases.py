"""The train step's phases: a profiler range on the host and a mark on the
device where each begins.

A step runs, in this order (`PHASES`): decode (the frames to colour, the
jitter), networks_fwd (the depth and pose networks), loss_fwd (geometry,
warps, pyramid, reprojection, automasking, smoothness and their sum),
loss_bwd (their backward), networks_bwd (the networks' backward; on a
mesh with synced batch norm's sums), grad_sync (the gradient all-reduce,
on a mesh only), optimizer (Adam) and metrics; `end` marks where the
step's work ends.

`phase(name, like)` opens the `torch.profiler` range "train_step/<name>"
and, when `like` is a CUDA tensor, launches `phase_mark_<name>` of
`csrc/phase_mark.cu` on the current stream: an empty kernel, one thread.
A CUDA graph keeps the marks as nodes of the captured step, so a device
trace of a replay, which holds no host range, still cuts each step into
its phases by kernel name: a phase runs from the end of its mark to the
start of the next. On a CPU tensor nothing is launched.
`backward_boundary(outputs)` hands the networks' outputs on unchanged;
its backward launches `phase_mark_networks_bwd` once autograd holds every
gradient of the loss with respect to them, and hands those on unchanged.
`mark.launches` counts the marks launched.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch
from torch.profiler import record_function
from torch.utils._pytree import tree_flatten, tree_unflatten

from monodepth_tpu_torch.ops.cuda.build import load_library
from monodepth_tpu_torch.training.graphs import COUNTED

Tensor = torch.Tensor

PHASES = ("decode", "networks_fwd", "loss_fwd", "loss_bwd", "networks_bwd",
          "grad_sync", "optimizer", "metrics", "end")


def mark(name: str, device: torch.device) -> None:
    """Launch `phase_mark_<name>` on the current stream of `device`;
    nothing on a device other than a card."""
    if device.type != "cuda":
        return
    index = PHASES.index(name)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _library().phase_mark(index, stream)
    if err != 0:
        raise RuntimeError(f"phase_mark_{name} launch failed: CUDA error {err}")
    mark.launches += 1


mark.launches = 0
COUNTED.append((mark, "launches"))


@contextlib.contextmanager
def phase(name: str, like: Tensor):
    """The range "train_step/<name>" around the block, which starts with
    the phase's mark on `like`'s device."""
    with record_function(f"train_step/{name}"):
        mark(name, like.device)
        yield


class _Boundary(torch.autograd.Function):
    """The identity on the networks' outputs, whose backward marks where
    the networks' backward begins."""

    @staticmethod
    def forward(ctx, *tensors: Tensor):
        # an output that gets no gradient costs no zero-fill kernel
        ctx.set_materialize_grads(False)
        ctx.device = tensors[0].device
        return tensors

    @staticmethod
    def backward(ctx, *grads):
        mark("networks_bwd", ctx.device)
        return grads


def backward_boundary(outputs):
    """`outputs` (a tree of tensors) unchanged, through `_Boundary` where
    autograd records: values and gradients keep their bits."""
    leaves, spec = tree_flatten(outputs)
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in leaves)):
        return outputs
    return tree_unflatten(list(_Boundary.apply(*leaves)), spec)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library("phase_mark")
    lib.phase_mark.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.phase_mark.restype = ctypes.c_int
    return lib
