"""Row-sharded primitives of the spatial mesh, each equal to its
whole-image op on this rank's rows.

Under a {data, spatial} mesh a rank holds Hl = H / n rows of its data
row's frames, and the train and eval steps run on those rows from the
first op to the loss, as GSPMD splits every op of the JAX step by rows
(`monodepth_tpu/parallel/mesh.py`). `row_sharding(mesh, height)` switches
the helpers here on around a step's forward and loss; outside it, and on a
mesh without a spatial axis, each helper is the plain op, so the
one-device step is unchanged.

The level rule. A feature level runs row-sharded when the level above it
does and is twice as tall, and its rows split into n equal pieces, each at
least as tall as the widest halo that an op reading the level needs: 3
for the 7x7 stem, 2 for PoseCNN's 5x5, 1 for the 3x3 convolutions, the max
pool, the reflection pads and the bilinear resize. The first level, going
deeper, that fails gathers its input (`relevel`, `gather_rows`); it and
every deeper level run whole on every rank, and the depth decoder splits
back (`split_rows`) at the first sharded level. `level(sharded)` tells the
helpers which kind the ops now running read and write.

Each rank's loss is its part of its data row's loss: a mean over pixels is
this rank's sum over the whole image's count (`loss_mean`), and a mean
inside a nonlinearity (the contrast jitter's gray mean, the smoothness
normalization, the pose decoders' averages, PoseCNN's inverse-depth scale)
is summed over the spatial group first (`spatial_mean`); a loss term of a
level that runs whole is held alike by every rank, which adds 1/n of it.
Every rank builds the same autograd graph (edge ranks exchange fill rows),
so the backward's halo exchanges run in the same order everywhere.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Iterator, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from monodepth_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_sum,
    extend_rows,
    gather_rows,
    split_rows,
)

Tensor = torch.Tensor


@dataclasses.dataclass
class RowSharding:
    """The spatial mesh of a step, the frames' global rows `height`, and
    whether the ops now running read and write row pieces (`sharded`)."""

    mesh: Mesh
    height: int
    sharded: bool = True

    @property
    def n(self) -> int:
        return self.mesh.spatial

    @property
    def first(self) -> bool:
        return self.mesh.spatial_index == 0

    @property
    def last(self) -> bool:
        return self.mesh.spatial_index == self.mesh.spatial - 1

    def row0(self, rows: int) -> int:
        """The global row of this rank's first row, at `rows` rows a rank."""
        return self.mesh.spatial_index * rows


_active: RowSharding | None = None


@contextlib.contextmanager
def row_sharding(mesh: Mesh | None, height: int) -> Iterator[None]:
    """Within the block the helpers run on this rank's rows of frames
    `height` rows high; a no-op without a mesh or a spatial axis."""
    global _active
    if mesh is None or mesh.spatial == 1:
        yield
        return
    outer, _active = _active, RowSharding(mesh, height)
    try:
        yield
    finally:
        _active = outer


def current() -> RowSharding | None:
    """The active row sharding, whichever kind of level runs now."""
    return _active


def sharded() -> RowSharding | None:
    """The active row sharding while the ops now running read and write
    row pieces, else None."""
    return _active if _active is not None and _active.sharded else None


@contextlib.contextmanager
def level(is_sharded: bool) -> Iterator[None]:
    """Within the block the ops read and write row pieces (True) or whole
    levels (False); a no-op outside `row_sharding`."""
    if _active is None:
        yield
        return
    outer, _active.sharded = _active.sharded, is_sharded
    try:
        yield
    finally:
        _active.sharded = outer


def swap_state(saved: Tuple[RowSharding | None, bool]):
    """Make `saved` (an earlier return value, or `(current(), flag)`) the
    active state -> the state it replaces. `Recomputation` uses it to
    rerun a block in the backward as its forward ran."""
    global _active
    outer = (_active, _active.sharded if _active is not None else False)
    _active = saved[0]
    if _active is not None:
        _active.sharded = saved[1]
    return outer


def state() -> Tuple[RowSharding | None, bool]:
    return _active, _active.sharded if _active is not None else False


def plan(heights: Sequence[int], halos: Sequence[int]) -> List[bool]:
    """The level rule (module docstring) over a chain of levels from the
    input down: whether each level, `heights[k]` global rows read with
    `halos[k]` halo rows, runs row-sharded. All False outside
    `row_sharding`."""
    r, out, ok = _active, [], _active is not None
    for k, (rows, halo) in enumerate(zip(heights, halos)):
        ok = ok and rows % r.n == 0 and rows // r.n >= max(halo, 1) \
            and (k == 0 or heights[k - 1] == 2 * rows)
        out.append(ok)
    return out


def _conv_rows(rows: int, kernel: int, stride: int, pad: int) -> int:
    return (rows + 2 * pad - kernel) // stride + 1


def resnet_levels() -> List[bool]:
    """The level rule for the ResNet encoder and the depth decoder:
    [input, relu1, layer1, layer2, layer3, layer4] (the decoder's level i
    is entry i)."""
    height = _active.height if _active is not None else 0
    heights = [height, _conv_rows(height, 7, 2, 3)]
    for _ in range(4):  # the max pool, then layer2..layer4's stride-2 blocks
        heights.append(_conv_rows(heights[-1], 3, 2, 1))
    return plan(heights, (3, 1, 1, 1, 1, 1))


def posecnn_levels(kernels: Sequence[int]) -> List[bool]:
    """The level rule for PoseCNN's stride-2 convolutions of `kernels`:
    [input, each conv's output]; the last level is read by a 1x1."""
    heights = [_active.height if _active is not None else 0]
    for k in kernels:
        heights.append(_conv_rows(heights[-1], k, 2, (k - 1) // 2))
    return plan(heights, [(k - 1) // 2 for k in kernels] + [0])


def relevel(x: Tensor, was: bool, now: bool, dim: int = 2) -> Tensor:
    """`x` at a level that runs `now` sharded or whole, from one that ran
    `was`: its rows gathered (sharded -> whole) or split (whole ->
    sharded) along `dim`, else `x`."""
    if _active is None or was == now:
        return x
    return split_rows(x, _active.mesh, dim) if now else gather_rows(x, _active.mesh, dim)


def global_rows(rows: int) -> int:
    """The whole level's rows of a tensor with `rows` rows here."""
    r = sharded()
    return rows if r is None else rows * r.n


def conv2d(conv: nn.Conv2d, x: Tensor) -> Tensor:
    """`conv(x)` (NCHW); on row pieces the rows it pads come from the
    neighbours (zeros at the image's edges) and it runs with H padding 0:
    the same output rows for any kernel and stride that divides the
    piece."""
    r = sharded()
    if r is None:
        return conv(x)
    pad_h, pad_w = conv.padding
    if pad_h:
        x = extend_rows(x, pad_h, pad_h, r.mesh, 2)
    return F.conv2d(x, conv.weight, conv.bias, conv.stride, (0, pad_w),
                    conv.dilation, conv.groups)


def max_pool2d(pool: nn.MaxPool2d, x: Tensor) -> Tensor:
    """`pool(x)` (NCHW); on row pieces its padding rows come from the
    neighbours, -inf at the image's edges as the pool pads."""
    r = sharded()
    if r is None:
        return pool(x)
    pad = pool.padding
    x = extend_rows(x, pad, pad, r.mesh, 2, fill=-math.inf)
    return F.max_pool2d(x, pool.kernel_size, pool.stride, (0, pad),
                        pool.dilation, pool.ceil_mode)


def reflect_rows(x: Tensor, dim: int) -> Tensor:
    """`x` with one reflected row at each end of axis `dim` (rows 1 and
    H-2; a single row repeats, as numpy's and jax's reflect pad do). On
    row pieces a rank takes its neighbours' rows, and the image's edge
    ranks reflect, from their halo where a piece is one row high."""
    if sharded() is None:
        n = x.shape[dim]
        lo = x.narrow(dim, 1, 1) if n > 1 else x
        hi = x.narrow(dim, n - 2, 1) if n > 1 else x
        return torch.cat([lo, x, hi], dim)
    top, bottom = reflect_halo(x, dim)
    return torch.cat([top, x, bottom], dim)


def reflect_halo(x: Tensor, dim: int) -> Tuple[Tensor, Tensor] | None:
    """On row pieces, the rows `reflect_rows` puts above and below `x`:
    (top, bottom), one row each, copies that keep no full-size tensor
    alive (SSIM pads its products with their products); None when the
    ops run on whole levels."""
    r = sharded()
    if r is None:
        return None
    n = x.shape[dim]
    ext = extend_rows(x, 1, 1, r.mesh, dim)
    return (ext.narrow(dim, 2 if r.first else 0, 1).clone(),
            ext.narrow(dim, n - 1 if r.last else n + 1, 1).clone())


def with_next_row(x: Tensor, dim: int = 1) -> Tensor:
    """`x`, and on row pieces the next rank's first row below it (none on
    the image's last rank): the rows whose neighbour differences along
    `dim` are this rank's."""
    r = sharded()
    if r is None:
        return x
    ext = extend_rows(x, 0, 1, r.mesh, dim)
    return ext.narrow(dim, 0, x.shape[dim] + (0 if r.last else 1))


def spatial_mean(x: Tensor, dims: Sequence[int], keepdim: bool = False) -> Tensor:
    """`x.mean(dims)` over dims that hold the row axis; on row pieces the
    sums are added over the spatial group (differentiably) and divided by
    the whole image's count, so every rank holds the image's mean."""
    r = sharded()
    if r is None:
        return x.mean(dim=tuple(dims), keepdim=keepdim)
    count = math.prod(x.shape[d] for d in dims) * r.n
    return all_reduce_sum(x.sum(dim=tuple(dims), keepdim=keepdim),
                          r.mesh.spatial_group) / count


def loss_mean(x: Tensor, count: int | None = None) -> Tensor:
    """`x.mean()`; on row pieces this rank's part of the whole image's
    mean: its sum over the whole count (`count`, default x.numel() times
    the ranks). The spatial ranks' parts add up to the mean."""
    r = sharded()
    if r is None:
        return x.mean()
    return x.sum() / (x.numel() * r.n if count is None else count)


@functools.lru_cache(maxsize=None)
def _resize_block(in_rows: int, out_rows: int, align_corners: bool, n: int,
                  s: int, dtype: torch.dtype, device: torch.device):
    """(halo, rank s's block of the [out_rows, in_rows] row-resize matrix
    over its input rows and `halo` rows each side) for n ranks; the halo
    is the widest any rank needs, so every rank exchanges alike."""
    from monodepth_tpu_torch.ops.sampling import _linear_resize_matrix

    mat = _linear_resize_matrix(in_rows, out_rows, align_corners)
    hi, ho = in_rows // n, out_rows // n
    halo = 0
    for rank in range(n):
        cols = np.nonzero(mat[rank * ho:(rank + 1) * ho].any(0))[0]
        halo = max(halo, int(rank * hi - cols.min()),
                   int(cols.max() + 1 - (rank + 1) * hi))
    if halo > hi:
        raise ValueError(f"resizing {in_rows} to {out_rows} rows reads {halo} rows "
                         f"of a neighbour's {hi}")
    padded = np.pad(mat, ((0, 0), (halo, halo)))
    block = padded[s * ho:(s + 1) * ho, s * hi:(s + 1) * hi + 2 * halo]
    with torch.inference_mode(False), torch.no_grad():
        return halo, torch.from_numpy(np.ascontiguousarray(block)).to(device, dtype)


def resize_rows(image: Tensor, height: int, align_corners: bool) -> Tensor:
    """The row product of the separable bilinear resize of row pieces of
    [B, h, W, C] to `height` global rows -> this rank's [B, height / n, W,
    C]: its rows of the global interpolation matrix, over its input rows
    and the halo the matrix reads (1 row a side for an upsample with
    align_corners=False)."""
    r = sharded()
    halo, block = _resize_block(image.shape[1] * r.n, height, align_corners, r.n,
                                r.mesh.spatial_index, image.dtype, image.device)
    if halo:
        image = extend_rows(image, halo, halo, r.mesh, 1)
    return torch.einsum("oh,bhwc->bowc", block, image)
