"""The warp sampler: hand-written CUDA kernels and their plain torch versions.

`warp_sample(image, grid)` is bilinear grid-sample with border padding and
align_corners=True on NHWC float32 tensors, the same-size form the view
synthesis uses (grid [B, H, W, 2] over an image [B, H, W, C]).
`warp_sample_grads(image, grid)` also returns the tap differences
gx = d out / d wx and gy = d out / d wy, [B, H, W, C] each, from which
`WarpSample` (the train step's sampler) forms the gradient with respect to
the grid without a second gather.

- On a CUDA tensor each launches its entry point of `csrc/warp_sample.cu`
  (built with nvcc for sm_90a at first use, bound with ctypes) on the
  current stream, or raises. They replace the TPU kernel
  `monodepth_tpu/ops/pallas/warp_sample.py:_kernel` in its
  `with_grads=False` and `with_grads=True` forms. The bound is memory: at
  640x192, batch 12, C=3 one `warp_sample` moves at least 47.2 MB (grid
  8 B + image 12 B + out 12 B per pixel), 14.1 us at the H100's
  3.35 TB/s, and one `warp_sample_grads` 82.6 MB (gx and gy add 24 B per
  pixel), 24.6 us. The design note is in the CUDA source.
- On a CPU tensor each runs its plain version (`warp_sample_reference`,
  `warp_sample_grads_reference`), which rounds exactly as the kernel does.

`warp_sample.launches` and `warp_sample_grads.launches` count kernel
launches (not plain-version calls).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from monodepth_tpu_torch.ops.cuda.build import load_library
from monodepth_tpu_torch.ops.sampling import bilinear_taps, grid_sample

Tensor = torch.Tensor

SLAB = 8  # rows per slab of the `dy_span` telemetry metric


def _check(image: Tensor, grid: Tensor) -> None:
    if image.ndim != 4:
        raise ValueError(f"warp_sample needs image [B, H, W, C]; got {tuple(image.shape)}")
    B, H, W, C = image.shape
    if grid.ndim != 4 or grid.shape[0] != B or grid.shape[2] != W \
            or grid.shape[3] != 2:
        raise ValueError(f"warp_sample needs grid [B, Ho, W, 2] matching "
                         f"the image width; got image {tuple(image.shape)}, "
                         f"grid {tuple(grid.shape)}")
    if grid.shape[1] != H:
        raise ValueError("plain warp_sample needs image H == grid H; got "
                         f"image {tuple(image.shape)}, grid {tuple(grid.shape)}")
    if H < 2 or W < 2:
        raise ValueError(f"warp_sample needs H, W >= 2; got {H}x{W}")
    if image.device != grid.device:
        raise ValueError(f"image on {image.device}, grid on {grid.device}")


def warp_sample_reference(image: Tensor, grid: Tensor) -> Tensor:
    """Plain torch version of the kernel: `ops.sampling.grid_sample`, with
    the same coordinates, blend formula and rounding
    (top = v00 + (v01 - v00)·wx, bot likewise, out = top + (bot - top)·wy),
    restricted to the shapes the kernel takes."""
    _check(image, grid)
    return grid_sample(image, grid)


def warp_sample_grads_reference(image: Tensor, grid: Tensor):
    """Plain torch version of the train-form kernel -> (out, gx, gy), each
    [B, H, W, C]: out as `warp_sample_reference`,
    gx = (1 - wy)·(v01 - v00) + wy·(v11 - v10) and gy = bot - top, with the
    kernel's formulas and rounding."""
    _check(image, grid)
    (v00, v01, v10, v11), (wx, wy) = bilinear_taps(image, grid)
    d0 = v01 - v00
    d1 = v11 - v10
    top = v00 + d0 * wx
    bot = v10 + d1 * wx
    gy = bot - top
    return top + gy * wy, (1 - wy) * d0 + wy * d1, gy


def _kernel_args(image: Tensor, grid: Tensor, name: str):
    """Check what a kernel takes; -> (library, B, H, W, C, stream)."""
    if image.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {image.device}")
    if image.dtype != torch.float32 or grid.dtype != torch.float32:
        raise TypeError(f"{name} kernel takes float32; got image "
                        f"{image.dtype}, grid {grid.dtype}")
    if not (image.is_contiguous() and grid.is_contiguous()):
        raise ValueError(f"{name} kernel takes contiguous tensors")
    stream = torch.cuda.current_stream(image.device).cuda_stream
    return (_kernel_library(), *image.shape, stream)


def warp_sample(image: Tensor, grid: Tensor) -> Tensor:
    """Warp `image` [B, H, W, C] by `grid` [B, H, W, 2] -> [B, H, W, C].
    CUDA tensors go through the kernel, CPU tensors through the plain
    version. No gradient: the train step's sampler is `WarpSample`."""
    _check(image, grid)
    if image.device.type == "cpu":
        return warp_sample_reference(image, grid)
    lib, B, H, W, C, stream = _kernel_args(image, grid, "warp_sample")
    out = torch.empty_like(image)
    with torch.cuda.device(image.device):
        err = lib.warp_sample_fwd(image.data_ptr(), grid.data_ptr(),
                                  out.data_ptr(), B, H, W, C, stream)
    if err != 0:
        raise RuntimeError(f"warp_sample_fwd launch failed: CUDA error {err}")
    warp_sample.launches += 1
    return out


warp_sample.launches = 0


def warp_sample_grads(image: Tensor, grid: Tensor):
    """`warp_sample` plus the tap differences -> (out, gx, gy), each
    [B, H, W, C]. CUDA tensors go through the kernel, CPU tensors through
    the plain version."""
    _check(image, grid)
    if image.device.type == "cpu":
        return warp_sample_grads_reference(image, grid)
    lib, B, H, W, C, stream = _kernel_args(image, grid, "warp_sample_grads")
    out, gx, gy = (torch.empty_like(image) for _ in range(3))
    with torch.cuda.device(image.device):
        err = lib.warp_sample_fwd_grads(
            image.data_ptr(), grid.data_ptr(), out.data_ptr(), gx.data_ptr(),
            gy.data_ptr(), B, H, W, C, stream)
    if err != 0:
        raise RuntimeError(f"warp_sample_fwd_grads launch failed: CUDA error {err}")
    warp_sample_grads.launches += 1
    return out, gx, gy


warp_sample_grads.launches = 0


def _clip_slope(coord: Tensor, size: int) -> Tensor:
    """d w / d coord of one axis of `bilinear_taps`: 0.5·(size - 1) times
    the `jnp.clip` derivative of the unnormalized coordinate, which is 1
    inside [0, size - 1], 0.5 on its ends and 0 outside (and for NaN)."""
    u = (coord + 1.0) * 0.5 * (size - 1)
    inside = ((u > 0) & (u < size - 1)).to(coord.dtype)
    tie = ((u == 0) | (u == size - 1)).to(coord.dtype)
    return (inside + 0.5 * tie) * (0.5 * (size - 1))


def grid_vjp(grid: Tensor, dout: Tensor, gx: Tensor, gy: Tensor) -> Tensor:
    """The cotangent of `grid` [B, H, W, 2] from that of the warp's output
    and its tap differences (all [B, H, W, C]): d wx = sum_c dout·gx,
    d wy = sum_c dout·gy, chained through the coordinates' clip. The
    floor anchors pass no gradient. Counterpart of `_grid_vjp`."""
    H, W = gx.shape[1], gx.shape[2]
    dwx = (dout * gx).sum(-1)
    dwy = (dout * gy).sum(-1)
    return torch.stack([dwx * _clip_slope(grid[..., 0], W),
                        dwy * _clip_slope(grid[..., 1], H)], -1)


class WarpSample(torch.autograd.Function):
    """`warp_sample` with a gradient with respect to the grid: the train
    step's sampler, `WarpSample.apply(image, grid)`.

    The forward runs `warp_sample_grads` (the kernel on CUDA tensors; with
    `plain=True` the plain version on any device) and keeps grid, gx and
    gy; the backward is `grid_vjp` in torch ops. The image gets no
    gradient (None): JAX's `warp_sample` returns a zero image cotangent by
    contract, which is exact in the train step, where the sampled images
    are data with no dependence on parameters. Do not use it where the
    sampled image itself needs a gradient."""

    @staticmethod
    def forward(ctx, image: Tensor, grid: Tensor, plain: bool = False):
        fn = warp_sample_grads_reference if plain else warp_sample_grads
        out, gx, gy = fn(image, grid)
        ctx.save_for_backward(grid, gx, gy)
        return out

    @staticmethod
    def backward(ctx, dout: Tensor):
        grid, gx, gy = ctx.saved_tensors
        return None, grid_vjp(grid, dout, gx, gy), None


@functools.lru_cache(maxsize=None)
def _kernel_library() -> ctypes.CDLL:
    lib = load_library("warp_sample")
    ints = [ctypes.c_int] * 4  # B, H, W, C
    for fn, n_ptrs in ((lib.warp_sample_fwd, 3), (lib.warp_sample_fwd_grads, 5)):
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + ints + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def dy_span(grid: Tensor) -> Tensor:
    """Mean over 8-row slabs of the vertical anchor offset's span (px):
    the `warp_span` telemetry metric of the eval step. A large value means
    a degenerate warp field. Needs H % 8 == 0."""
    B, H, W, _ = grid.shape
    y = torch.clamp((grid[..., 1] + 1.0) * 0.5 * (H - 1), 0.0, H - 1)
    y0 = torch.clamp(torch.floor(y), 0, H - 2)
    rows = torch.arange(H, dtype=y0.dtype, device=y0.device)
    slabs = (y0 - rows[None, :, None]).reshape(B, H // SLAB, SLAB * W)
    return (slabs.amax(-1) - slabs.amin(-1)).mean()
