"""Image sampling primitives as plain torch ops, NHWC: grid-sample,
bilinear resize, nearest 2x upsample, 2x area downsample, pyramids.

Counterpart of `monodepth_tpu.ops.sampling`, with the same arithmetic
so the two packages agree to f32 rounding.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

Tensor = torch.Tensor


def clip(x: Tensor, lo: float, hi: float) -> Tensor:
    """`jnp.clip(x, lo, hi)`: the max, then the min, against tensor bounds.
    The values are those of `torch.clamp`; the gradient is JAX's: 1
    inside, 0 outside and 0.5 at a tie (x == lo or x == hi), where
    `torch.clamp` passes 1."""
    lo_t = torch.full((), lo, dtype=x.dtype, device=x.device)
    hi_t = torch.full((), hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo_t), hi_t)


def bilinear_taps(image: Tensor, grid: Tensor, full_height: int | None = None,
                  row0: int = 0):
    """The 2x2 taps and weights of a bilinear sample of `image`
    [B, H, W, C] at `grid` [B, Ho, Wo, 2] ((x, y) in [-1, 1]), border
    padding, align_corners=True: (v00, v01, v10, v11) [B, Ho, Wo, C] and
    (wx, wy) [B, Ho, Wo, 1].

    The continuous coordinate is clipped to [0, size-1] and the anchor to
    [0, size-2], so a coordinate on the far border becomes (size-2, w=1).
    The int anchors are clamped again after the cast: a NaN coordinate
    stays memory-safe and gives NaN at its own pixel only. The weights
    carry the gradient with respect to the grid; the anchors carry none.

    With `full_height`, `image` is a slab of rows of a taller image: y is
    normalized over `full_height` rows, and the row anchor, clamped to
    [0, full_height - 2], is shifted by -`row0` (the global row of the
    slab's first row) and clamped to [0, H - 2]. A tap outside the slab
    then reads the slab's edge row."""
    B, H, W, C = image.shape
    Ho, Wo = grid.shape[1], grid.shape[2]
    Hf = H if full_height is None else full_height
    x = clip((grid[..., 0] + 1.0) * 0.5 * (W - 1), 0.0, W - 1)
    y = clip((grid[..., 1] + 1.0) * 0.5 * (Hf - 1), 0.0, Hf - 1)
    x0 = torch.clamp(torch.floor(x), 0, W - 2)
    y0 = torch.clamp(torch.floor(y), 0, Hf - 2)
    wx = (x - x0).to(image.dtype)[..., None]
    wy = (y - y0).to(image.dtype)[..., None]
    x0i = torch.clamp(x0.to(torch.int64), 0, W - 2)
    y0i = torch.clamp(y0.to(torch.int64), 0, Hf - 2)
    if full_height is not None:
        y0i = torch.clamp(y0i - row0, 0, H - 2)

    flat = image.reshape(B, H * W, C)

    def tap(yi, xi):
        idx = (yi * W + xi).reshape(B, Ho * Wo, 1).expand(B, Ho * Wo, C)
        return flat.gather(1, idx).reshape(B, Ho, Wo, C)

    return (tap(y0i, x0i), tap(y0i, x0i + 1), tap(y0i + 1, x0i),
            tap(y0i + 1, x0i + 1)), (wx, wy)


def grid_sample(image: Tensor, grid: Tensor) -> Tensor:
    """Bilinear sample `image` [B, H, W, C] at `grid` [B, Ho, Wo, 2]
    ((x, y) in [-1, 1]), border padding, align_corners=True -> [B, Ho, Wo, C]
    (coordinates as in `bilinear_taps`). Each blend is a + (b - a)·w, the
    formula (and rounding) of the CUDA warp kernel, whose plain version
    this is (`ops.cuda.warp_sample`)."""
    (v00, v01, v10, v11), (wx, wy) = bilinear_taps(image, grid)
    top = v00 + (v01 - v00) * wx
    bot = v10 + (v11 - v10) * wx
    return top + (bot - top) * wy


@functools.lru_cache(maxsize=None)
def _linear_resize_matrix(in_size: int, out_size: int,
                          align_corners: bool) -> np.ndarray:
    """[out, in] row-stochastic bilinear interpolation matrix, f64 (no
    antialias; `F.interpolate` coordinate conventions)."""
    if in_size == out_size:
        return np.eye(in_size, dtype=np.float64)
    if align_corners and out_size > 1:
        src = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    else:
        src = (np.arange(out_size, dtype=np.float64) + 0.5) * (in_size / out_size) - 0.5
    src = np.clip(src, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    w = src - lo
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    rows = np.arange(out_size)
    np.add.at(mat, (rows, lo), 1.0 - w)
    np.add.at(mat, (rows, hi), w)
    return mat


def resize_bilinear(image: Tensor, height: int, width: int,
                    align_corners: bool = False) -> Tensor:
    """Separable bilinear resize of [B, H, W, C] as two products with
    constant interpolation matrices; matches `F.interpolate(...,
    mode="bilinear", align_corners=...)`."""
    B, H, W, C = image.shape
    if (H, W) == (height, width):
        return image

    def mat(n_in, n_out):
        return torch.from_numpy(_linear_resize_matrix(
            n_in, n_out, align_corners)).to(image.device, image.dtype)

    out = torch.einsum("oh,bhwc->bowc", mat(H, height), image)
    return torch.einsum("ow,bhwc->bhoc", mat(W, width), out)


def upsample_nearest_2x(image: Tensor) -> Tensor:
    """Exact `F.interpolate(x, scale_factor=2, mode="nearest")` on NHWC."""
    return image.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def downsample_2x_avg(image: Tensor) -> Tensor:
    """2x2 area (average) downsample of [B, H, W, C]."""
    B, H, W, C = image.shape
    return image.reshape(B, H // 2, 2, W // 2, 2, C).mean(dim=(2, 4))


def pyramid(image: Tensor, num_scales: int) -> list[Tensor]:
    """[full, /2, /4, ...] — `num_scales` levels."""
    out = [image]
    for _ in range(num_scales - 1):
        out.append(downsample_2x_avg(out[-1]))
    return out
