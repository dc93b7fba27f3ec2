"""Process mesh, batch layout and the collectives of the multi-GPU steps.

Counterpart of `monodepth_tpu.parallel.mesh`. One process drives one
device (a card, or the CPU with gloo in the tests), and the processes form
a ("data", "spatial") grid, rank = data_index · spatial + spatial_index,
laid out row-major as JAX's `devices.reshape(data, spatial)`:

  data     the global batch splits across the data ranks; the train step
           averages gradients and normalizes batch norm with the global
           batch's statistics.
  spatial  each data rank's frames split by rows across its spatial group,
           and the step runs on those rows from the first op to the loss
           (`parallel.rows`): convolutions, pools, pads and resizes read
           halo rows from the neighbours (`extend_rows`), and the warps run
           on row slabs (training/step.py `_spatial_sampler`).

`init_distributed` starts the process group from torchrun's environment,
`make_mesh` builds the groups, `shard_batch` cuts this rank's piece of a
host batch, `replicate` broadcasts the state from rank 0 and
`warm_collectives` touches every group before the first step. The
differentiable collectives (`all_reduce_sum`, `extend_rows`, `split_rows`,
`gather_rows`) carry gradients through batch norm's statistics, the halo
rows and the levels that run whole on every rank.

The collectives of a `{data: n}` step (`all_reduce_sum` in synced batch
norm, forward and backward; `average_gradients`; the metrics' all-reduces
and `all_gather_cat`) read nothing back to the host, allocate only
through the caching allocator (so inside a capture, from the graph's
pool) and come in one order on every rank: over NCCL a CUDA graph
captures them (`training/graphs.py`). gloo's collectives run on host
tensors and cannot be captured.
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


def init_distributed(device=None, timeout_s: float = 300.0,
                     backend: str | None = None) -> bool:
    """Join the process group that torchrun's environment describes
    (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT). `backend` None takes NCCL on the card and gloo on the
    CPU. NCCL puts one rank on each card: the card LOCAL_RANK, which
    becomes the current device, and a `ValueError` when the host runs more
    ranks than it has cards. An explicit "gloo" may run on cards too, where
    its collectives stage through host memory: the card is LOCAL_RANK
    modulo the card count, so two ranks can share one card. Collectives
    give up after `timeout_s` seconds. A single process (WORLD_SIZE unset
    or 1) is a no-op. Returns True when this process is in a group of
    more than one."""
    from monodepth_tpu_torch.training.state import resolve_device

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    if dist.is_initialized():
        return True
    device = resolve_device(device)
    rank = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: nccl or gloo")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("NCCL runs on cards only; the CPU takes gloo")
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if backend == "nccl" and max(local_world, local + 1) > cards:
            raise ValueError(
                f"NCCL puts one rank on each card: {local_world} ranks on this "
                f"host, {cards} card(s); pass backend gloo to share a card")
        torch.cuda.set_device(local % cards)
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
    index (None when spatial == 1); `backend` is the process group's
    ("nccl" or "gloo"; None without one)."""

    data: int
    spatial: int
    rank: int
    device: torch.device
    data_group: Any = None
    spatial_group: Any = None
    backend: str | None = None

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
    backend = dist.get_backend() if dist.is_initialized() else None
    return Mesh(data, spatial, rank, device, data_group, spatial_group, backend)


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


def _broadcast(t: Tensor, device: torch.device) -> None:
    """Broadcast `t` from rank 0 in place; a host tensor goes through
    `device` when the backend is NCCL (Adam's step counts stay on the
    host on the CPU, and lie on the card when Adam is capturable)."""
    if t.device.type == "cpu" and dist.get_backend() == "nccl":
        staged = t.to(device)
        dist.broadcast(staged, src=0)
        t.copy_(staged)
    else:
        dist.broadcast(t, src=0)


def replicate(mesh: Mesh, state: TrainState) -> TrainState:
    """Broadcast the model's parameters and buffers and the optimizer's
    state from rank 0, in place, so every rank holds rank 0's state: before
    the first step, and after a resume. The optimizer's state must have
    the same entries on every rank (none before the first step, or those
    of one checkpoint)."""
    if not dist.is_initialized():
        return state
    tensors = list(state.model.parameters()) + list(state.model.buffers())
    if state.optimizer is not None:
        tensors += [v for entry in state.optimizer.state.values()
                    for v in entry.values() if isinstance(v, Tensor)]
    with torch.no_grad():
        for t in tensors:
            _broadcast(t.data, mesh.device)
    return state


def agree_max(mesh: Mesh, value: float) -> float:
    """The largest of every rank's `value` (one all-reduce; the value
    itself without a process group): the ranks' stop flag at an epoch
    boundary."""
    if not dist.is_initialized():
        return value
    t = torch.tensor([float(value)], dtype=torch.float64, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t)


def warm_collectives(mesh: Mesh) -> float:
    """Touch every group this rank's steps use (the world, the data and
    spatial groups, the halo pairs, and the spatial group's all-gather of
    the exact warps) with tiny collectives, so connection set-up happens
    before the first step and before any capture. Returns the world size
    as summed on the device."""
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
        all_gather_cat(one, mesh.spatial_group, 0)
    dist.barrier()
    return float(total)


def all_gather_cat(x: Tensor, group, dim: int) -> Tensor:
    """The group's tensors concatenated along `dim`, in rank order (no
    gradient)."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim)


def _swap(to_prev: Tensor, to_next: Tensor, from_prev: int, from_next: int,
          mesh: Mesh, dim: int, fill: float = 0.0):
    """Send `to_prev` to the previous rank of the spatial group and
    `to_next` to the next, and receive `from_prev` rows (axis `dim`) from
    the previous and `from_next` from the next, in one `batch_isend_irecv`
    -> (rows from the previous rank, rows from the next). An edge rank
    gets `fill` where it has no neighbour. Under gloo a card's rows go
    through host memory: gloo sends and receives host tensors only."""
    s, n = mesh.spatial_index, mesh.spatial
    like = to_prev if to_prev.shape[dim] else to_next

    def shape(rows):
        out = list(like.shape)
        out[dim] = rows
        return out

    wire = "cpu" if like.is_cuda and dist.get_backend(mesh.spatial_group) == "gloo" \
        else like.device
    ops, received = [], {}
    for side, peer, rows, send in ((-1, s - 1, from_prev, to_prev),
                                   (1, s + 1, from_next, to_next)):
        if not 0 <= peer < n:
            continue
        rank = mesh.spatial_rank(peer)
        if send.shape[dim]:
            ops.append(dist.P2POp(dist.isend, send.to(wire).contiguous(), rank,
                                  mesh.spatial_group))
        if rows:
            received[side] = torch.empty(shape(rows), dtype=like.dtype, device=wire)
            ops.append(dist.P2POp(dist.irecv, received[side], rank, mesh.spatial_group))
    if ops:
        for request in dist.batch_isend_irecv(ops):
            request.wait()
    return tuple(received[side].to(like.device) if side in received
                 else like.new_full(shape(rows), fill)
                 for side, rows in ((-1, from_prev), (1, from_next)))


def exchange_halo(own: Tensor, halo: int, mesh: Mesh):
    """Send the first `halo` rows (axis 1) of `own` to the previous rank
    of the spatial group and the last `halo` to the next, one
    `batch_isend_irecv` -> (rows from the previous rank, rows from the
    next). The edge ranks get zeros where they have no neighbour. Under
    gloo a card's rows go through host memory. No gradient (the warp's
    sources carry none); `extend_rows` is the differentiable form."""
    shape = (own.shape[0], halo) + tuple(own.shape[2:])
    if halo == 0 or mesh.spatial == 1:
        return own.new_zeros(shape), own.new_zeros(shape)
    return _swap(own[:, :halo], own[:, own.shape[1] - halo:], halo, halo, mesh, 1)


class _ExtendRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: Tensor, top: int, bottom: int, mesh: Mesh, dim: int,
                fill: float):
        ctx.top, ctx.bottom, ctx.mesh, ctx.dim = top, bottom, mesh, dim
        h = x.shape[dim]
        # my first `bottom` rows are the previous rank's bottom halo, my
        # last `top` rows the next rank's top halo
        above, below = _swap(x.narrow(dim, 0, bottom), x.narrow(dim, h - top, top),
                             top, bottom, mesh, dim, fill)
        return torch.cat([above, x, below], dim)

    @staticmethod
    def backward(ctx, grad: Tensor):
        top, bottom, dim = ctx.top, ctx.bottom, ctx.dim
        h = grad.shape[dim] - top - bottom
        # each halo row's cotangent goes back to the rank that owns the row;
        # the edge ranks' fill rows own no input, so theirs is dropped
        from_prev, from_next = _swap(grad.narrow(dim, 0, top),
                                     grad.narrow(dim, top + h, bottom),
                                     bottom, top, ctx.mesh, dim)
        out = grad.narrow(dim, top, h).clone()
        out.narrow(dim, 0, bottom).add_(from_prev)
        out.narrow(dim, h - top, top).add_(from_next)
        return out, None, None, None, None, None


def extend_rows(x: Tensor, top: int, bottom: int, mesh: Mesh, dim: int = 1,
                fill: float = 0.0) -> Tensor:
    """This rank's rows (axis `dim`) of a row-sharded tensor with `top`
    rows of the previous rank above and `bottom` rows of the next below,
    `fill` where the image ends; each side's halo needs that many rows a
    rank. Differentiable: the backward sends each halo row's cotangent
    back to its owner, where it adds to that rank's edge rows."""
    return _ExtendRows.apply(x, top, bottom, mesh, dim, fill)


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
    def forward(ctx, x: Tensor, mesh: Mesh, dim: int):
        ctx.mesh, ctx.dim, ctx.shape = mesh, dim, x.shape
        rows = x.shape[dim] // mesh.spatial
        return x.narrow(dim, mesh.spatial_index * rows, rows).contiguous()

    @staticmethod
    def backward(ctx, grad: Tensor):
        out = grad.new_zeros(ctx.shape)
        out.narrow(ctx.dim, ctx.mesh.spatial_index * grad.shape[ctx.dim],
                   grad.shape[ctx.dim]).copy_(grad)
        return out, None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: Tensor, mesh: Mesh, dim: int):
        ctx.mesh, ctx.dim = mesh, dim
        return all_gather_cat(x, mesh.spatial_group, dim)

    @staticmethod
    def backward(ctx, grad: Tensor):
        mesh, dim = ctx.mesh, ctx.dim
        grad = grad.contiguous()
        dist.all_reduce(grad, group=mesh.spatial_group)
        rows = grad.shape[dim] // mesh.spatial
        return grad.narrow(dim, mesh.spatial_index * rows, rows).contiguous(), \
            None, None


def split_rows(x: Tensor, mesh: Mesh, dim: int = 1) -> Tensor:
    """This rank's rows (axis `dim`) of `x`, which every rank of the
    spatial group holds alike. Each rank's loss is its own part of the
    step's loss, so a rank's copy of `x` reaches that part through its own
    rows only: the backward puts the rows' cotangent in zeros of `x`'s
    shape, and `gather_rows` upstream sums the ranks' copies."""
    return _SplitRows.apply(x, mesh, dim)


def gather_rows(x: Tensor, mesh: Mesh, dim: int = 1) -> Tensor:
    """The spatial group's row pieces (axis `dim`) stitched in order, held
    alike by every rank. Backward: the ranks' cotangents of the whole,
    each from that rank's part of the loss, summed over the group; this
    rank's rows of the sum."""
    return _GatherRows.apply(x, mesh, dim)


def average_gradients(model: torch.nn.Module, mesh: Mesh) -> None:
    """Sum the parameters' gradients over all ranks, in one flat
    all-reduce, and divide by the data ranks. Each rank's gradient is that
    of its own part of the loss: its items on a data mesh, its rows of its
    data row's items on a spatial mesh (the spatial ranks' parts sum to the
    data row's loss). So every rank ends with the same bits: the mean over
    data ranks of the sum over spatial ranks."""
    if not dist.is_initialized() or mesh.size == 1:
        return
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= mesh.data
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
