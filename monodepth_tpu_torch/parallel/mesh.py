"""Process mesh, batch layout and the collectives of the multi-GPU steps.

Counterpart of `monodepth_tpu.parallel.mesh`. One process drives one
device (a card, or the CPU with gloo in the tests), and the processes form
a ("data", "spatial") grid, rank = data_index · spatial + spatial_index,
laid out row-major as JAX's `devices.reshape(data, spatial)`:

  data     the global batch splits across the data ranks; the train step
           averages gradients and normalizes batch norm with the global
           batch's statistics.
  spatial  each data rank's frames split by rows across its spatial group;
           the warps run on row slabs with a halo from the neighbours
           (training/step.py `_spatial_sampler`).

`init_distributed` starts the process group from torchrun's environment,
`make_mesh` builds the groups, `shard_batch` cuts this rank's piece of a
host batch, `replicate` broadcasts the state from rank 0 and
`warm_collectives` touches every group before the first step. The
differentiable collectives (`all_reduce_sum`, `split_rows`, `gather_rows`)
carry gradients through batch norm's statistics and the row split of the
warps.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import TYPE_CHECKING, Any, Dict, Mapping, Tuple

import torch
import torch.distributed as dist

if TYPE_CHECKING:  # the models import this module: no import of training here
    from monodepth_tpu_torch.training.state import TrainState

Tensor = torch.Tensor

# batch key -> H axis for spatial sharding. frames are [B, F, H, W, 3];
# depth_gt (375 rows, read only by the metrics) splits over data only
_SPATIAL_KEYS = {"frames": 2}


def init_distributed(device=None, timeout_s: float = 300.0) -> bool:
    """Join the process group that torchrun's environment describes
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT): NCCL on the
    card LOCAL_RANK, which becomes the current device, or gloo when
    `device` is the CPU. Collectives give up after `timeout_s` seconds. A
    single process (WORLD_SIZE unset or 1) is a no-op. Returns True when
    this process is in a group of more than one."""
    from monodepth_tpu_torch.training.state import resolve_device

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    if dist.is_initialized():
        return True
    device = resolve_device(device)
    rank = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    if device.type == "cuda":
        torch.cuda.set_device(local)
        backend = "nccl"
    else:
        backend = "gloo"
    address = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    dist.init_process_group(backend, init_method=address, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the ("data", "spatial") grid, its device and
    its process groups: `data_group` holds the ranks of this rank's
    spatial index (None when data == 1), `spatial_group` those of its data
    index (None when spatial == 1)."""

    data: int
    spatial: int
    rank: int
    device: torch.device
    data_group: Any = None
    spatial_group: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "spatial": self.spatial}

    @property
    def size(self) -> int:
        return self.data * self.spatial

    @property
    def data_index(self) -> int:
        return self.rank // self.spatial

    @property
    def spatial_index(self) -> int:
        return self.rank % self.spatial

    def spatial_rank(self, index: int) -> int:
        """The global rank at spatial `index` of this rank's data row."""
        return self.data_index * self.spatial + index


def mesh_shape(n: int, data: int = 0, spatial: int = 1) -> Tuple[int, int]:
    """(data, spatial) of a mesh over `n` processes; data=0 takes all of
    them. Raises as JAX's `make_mesh` does, and also when the mesh leaves
    processes out (each process drives one device of the mesh)."""
    if data == 0:
        if n % spatial:
            raise ValueError(f"{n} devices not divisible by spatial={spatial}")
        data = n // spatial
    if data * spatial > n:
        raise ValueError(f"mesh {data}x{spatial} needs {data * spatial} "
                         f"devices, have {n}")
    if data * spatial < n:
        raise ValueError(f"mesh {data}x{spatial} leaves {n - data * spatial} "
                         f"of {n} processes without a device of the mesh")
    return data, spatial


def make_mesh(data: int = 0, spatial: int = 1, device=None) -> Mesh:
    """The ("data", "spatial") mesh over every process of the group (or
    this process alone), with its process groups. Every process must call
    it with the same arguments: each group is created by all of them.
    `device` defaults to the current card."""
    from monodepth_tpu_torch.training.state import resolve_device

    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    n = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    data, spatial = mesh_shape(n, data, spatial)
    data_group = spatial_group = None
    if data > 1:
        for s in range(spatial):
            group = dist.new_group([d * spatial + s for d in range(data)])
            if s == rank % spatial:
                data_group = group
    if spatial > 1:
        for d in range(data):
            group = dist.new_group([d * spatial + s for s in range(spatial)])
            if d == rank // spatial:
                spatial_group = group
    return Mesh(data, spatial, rank, device, data_group, spatial_group)


def shard_batch(mesh: Mesh, batch: Mapping[str, Any]) -> Dict[str, Tensor]:
    """This rank's piece of a host batch, on its device, laid out as JAX's
    `batch_sharding`: the batch axis over "data", the H axis of `frames`
    over "spatial", every other entry over "data" only."""
    out = {}
    for key, value in batch.items():
        t = torch.as_tensor(value)
        pieces = [(0, mesh.data, mesh.data_index)]
        axis = _SPATIAL_KEYS.get(key)
        if axis is not None and mesh.spatial > 1:
            pieces.append((axis, mesh.spatial, mesh.spatial_index))
        for dim, parts, index in pieces:
            if t.shape[dim] % parts:
                raise ValueError(f"{key}: axis {dim} of size {t.shape[dim]} "
                                 f"does not split over {parts} ranks")
            size = t.shape[dim] // parts
            t = t.narrow(dim, index * size, size)
        out[key] = t.contiguous().to(mesh.device)
    return out


def replicate(mesh: Mesh, state: TrainState) -> TrainState:
    """Broadcast the model's parameters and buffers from rank 0, in place,
    so every rank starts from rank 0's state. Call it before the first
    step: the optimizer's state is not sent."""
    if not dist.is_initialized():
        return state
    if state.optimizer is not None and state.optimizer.state:
        raise ValueError("replicate the state before its first step: the "
                         "optimizer's moments are not broadcast")
    with torch.no_grad():
        for t in list(state.model.parameters()) + list(state.model.buffers()):
            dist.broadcast(t.data, src=0)
    return state


def warm_collectives(mesh: Mesh) -> float:
    """Touch every group this rank's steps use (the world, the data and
    spatial groups, the halo pairs) with tiny collectives, so connection
    set-up happens before the first step. Returns the world size as summed
    on the device."""
    one = torch.ones(1, device=mesh.device)
    if not dist.is_initialized():
        return float(one)
    total = one.clone()
    dist.all_reduce(total)
    for group in (mesh.data_group, mesh.spatial_group):
        if group is not None:
            dist.all_reduce(one.clone(), group=group)
    if mesh.spatial > 1:
        exchange_halo(one.reshape(1, 1).expand(1, 2).contiguous(), 1, mesh)
    dist.barrier()
    return float(total)


def all_gather_cat(x: Tensor, group, dim: int) -> Tensor:
    """The group's tensors concatenated along `dim`, in rank order (no
    gradient)."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim)


def exchange_halo(own: Tensor, halo: int, mesh: Mesh):
    """Send the first `halo` rows (axis 1) of `own` to the previous rank
    of the spatial group and the last `halo` to the next, one
    `batch_isend_irecv` -> (rows from the previous rank, rows from the
    next). The edge ranks get zeros where they have no neighbour."""
    shape = (own.shape[0], halo) + tuple(own.shape[2:])
    from_prev = own.new_zeros(shape)
    from_next = own.new_zeros(shape)
    s, n = mesh.spatial_index, mesh.spatial
    if halo == 0 or n == 1:
        return from_prev, from_next
    ops = []
    if s > 0:
        prev = mesh.spatial_rank(s - 1)
        ops += [dist.P2POp(dist.isend, own[:, :halo].contiguous(), prev,
                           mesh.spatial_group),
                dist.P2POp(dist.irecv, from_prev, prev, mesh.spatial_group)]
    if s < n - 1:
        nxt = mesh.spatial_rank(s + 1)
        ops += [dist.P2POp(dist.isend, own[:, own.shape[1] - halo:].contiguous(),
                           nxt, mesh.spatial_group),
                dist.P2POp(dist.irecv, from_next, nxt, mesh.spatial_group)]
    for request in dist.batch_isend_irecv(ops):
        request.wait()
    return from_prev, from_next


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: Tensor, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: Tensor):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: Tensor, group) -> Tensor:
    """Sum of `x` over `group`, differentiable: the cotangents are summed
    over the group too, so each rank's backward sees every rank's use of
    the sum (batch norm's global statistics)."""
    return _AllReduceSum.apply(x, group)


class _SplitRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: Tensor, mesh: Mesh):
        ctx.mesh = mesh
        rows = x.shape[1] // mesh.spatial
        return x[:, mesh.spatial_index * rows:(mesh.spatial_index + 1) * rows] \
            .contiguous()

    @staticmethod
    def backward(ctx, grad: Tensor):
        return all_gather_cat(grad, ctx.mesh.spatial_group, 1), None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: Tensor, mesh: Mesh):
        ctx.mesh = mesh
        return all_gather_cat(x, mesh.spatial_group, 1)

    @staticmethod
    def backward(ctx, grad: Tensor):
        mesh = ctx.mesh
        rows = grad.shape[1] // mesh.spatial
        return grad[:, mesh.spatial_index * rows:
                    (mesh.spatial_index + 1) * rows].contiguous(), None


def split_rows(x: Tensor, mesh: Mesh) -> Tensor:
    """This rank's rows (axis 1) of `x`, which every rank of the spatial
    group holds whole. Backward: the group's row cotangents gathered, so
    each rank gets the whole cotangent of `x`."""
    return _SplitRows.apply(x, mesh)


def gather_rows(x: Tensor, mesh: Mesh) -> Tensor:
    """The spatial group's row pieces (axis 1) stitched in order. Backward:
    this rank's rows of the cotangent, which the ranks hold alike (the
    loss downstream is replicated), so nothing is summed n times."""
    return _GatherRows.apply(x, mesh)


def average_gradients(model: torch.nn.Module, mesh: Mesh) -> None:
    """Average the parameters' gradients over all ranks, in one flat
    all-reduce. The spatial ranks of a data row hold the same gradient, so
    this is the mean over data ranks, and every rank ends with the same
    bits."""
    if not dist.is_initialized() or mesh.size == 1:
        return
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= mesh.size
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()

