"""The warp sampler: hand-written CUDA kernels and their plain torch versions.

`warp_sample(image, grid)` is bilinear grid-sample with border padding and
align_corners=True on NHWC float32 tensors, the same-size form the view
synthesis uses (grid [B, H, W, 2] over an image [B, H, W, C]).
`warp_sample_grads(image, grid)` also returns the tap differences
gx = d out / d wx and gy = d out / d wy, [B, H, W, C] each, from which
`grid_vjp` forms the gradient with respect to the grid without a second
gather. `WarpSample` (the train step's sampler) is the pair as a
`torch.autograd.Function`.

`warp_sample_shifted(image, grid, row0, full_height)` and
`warp_sample_grads_shifted(...)` are the same two forms on a row slab
(K3): `image` [B, Himg, W, C] holds rows row0 .. row0 + Himg - 1 of an
image of `full_height` rows (own rows plus a halo from the neighbours,
under a spatial mesh), `grid` [B, Hout, W, 2] carries global coordinates.
Exact wherever every tap lies in the slab; an anchor outside it reads the
slab's edge (memory-safe, wrong), and the caller falls back.
`WarpSampleShifted` is its train-step gradient.

- On a CUDA tensor each launches its entry point of `csrc/warp_sample.cu`
  (built with nvcc for sm_90a at first use, bound with ctypes) on the
  current stream, or raises. They replace the TPU kernel
  `monodepth_tpu/ops/pallas/warp_sample.py:_kernel` in its
  `with_grads=False` and `with_grads=True` forms, and K3 replaces it in
  its shifted launches (`warp_sample_shifted`, `_fwd_shifted`).
  `grid_vjp` (K1-bwd) computes JAX's `_grid_vjp`, which is jnp there. The
  bound is memory: at 640x192, batch 12, C=3 one `warp_sample` moves at
  least 47.2 MB (grid 8 B + image 12 B + out 12 B per pixel), 14.1 us at
  the H100's 3.35 TB/s, one `warp_sample_grads` 82.6 MB (gx and gy add
  24 B per pixel), 24.6 us, and one `grid_vjp` 76.7 MB (grid, dout, gx,
  gy in, dgrid out: 52 B per pixel), 22.9 us. The design note is in the
  CUDA source.
- On a CPU tensor each runs its plain version (`warp_sample_reference`,
  `warp_sample_grads_reference`, `grid_vjp_reference`, ...), which rounds
  exactly as the kernel does.

`warp_sample.launches`, `warp_sample_grads.launches`,
`warp_sample_shifted.launches`, `warp_sample_grads_shifted.launches` and
`grid_vjp.launches` count kernel launches (not plain-version calls).
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


def _check_shifted(image: Tensor, grid: Tensor, row0: int,
                   full_height: int) -> None:
    if image.ndim != 4 or grid.ndim != 4:
        raise ValueError(f"warp_sample_shifted needs image [B, Himg, W, C] and "
                         f"grid [B, Hout, W, 2]; got {tuple(image.shape)}, "
                         f"{tuple(grid.shape)}")
    B, Himg, W, C = image.shape
    if grid.shape[0] != B or grid.shape[2] != W or grid.shape[3] != 2:
        raise ValueError(f"warp_sample_shifted needs grid [B, Hout, W, 2] "
                         f"matching the slab's batch and width; got image "
                         f"{tuple(image.shape)}, grid {tuple(grid.shape)}")
    if Himg < 2 or W < 2 or full_height < 2:
        raise ValueError(f"warp_sample_shifted needs Himg, W, full_height >= 2; "
                         f"got {Himg}, {W}, {full_height}")
    if not isinstance(row0, int):
        raise TypeError(f"row0 must be a Python int; got {type(row0).__name__}")
    if image.device != grid.device:
        raise ValueError(f"image on {image.device}, grid on {grid.device}")


def _blend(taps, weights):
    """out = top + (bot - top)·wy with top = v00 + (v01 - v00)·wx and bot
    likewise: the kernels' formula and rounding."""
    (v00, v01, v10, v11), (wx, wy) = taps, weights
    top = v00 + (v01 - v00) * wx
    bot = v10 + (v11 - v10) * wx
    return top + (bot - top) * wy


def _blend_grads(taps, weights):
    """(out, gx, gy) with gx = (1 - wy)·(v01 - v00) + wy·(v11 - v10) and
    gy = bot - top, in the train-form kernels' order."""
    (v00, v01, v10, v11), (wx, wy) = taps, weights
    d0 = v01 - v00
    d1 = v11 - v10
    top = v00 + d0 * wx
    bot = v10 + d1 * wx
    gy = bot - top
    return top + gy * wy, (1 - wy) * d0 + wy * d1, gy


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
    return _blend_grads(*bilinear_taps(image, grid))


def warp_sample_shifted_reference(image: Tensor, grid: Tensor, row0: int,
                                  full_height: int) -> Tensor:
    """Plain torch version of the eval-form K3: `bilinear_taps` with the
    shifted anchor (y over `full_height`, anchor - row0 clamped to the
    slab), blended as `warp_sample_reference` -> [B, Hout, W, C]."""
    _check_shifted(image, grid, row0, full_height)
    return _blend(*bilinear_taps(image, grid, full_height, row0))


def warp_sample_grads_shifted_reference(image: Tensor, grid: Tensor, row0: int,
                                        full_height: int):
    """Plain torch version of the train-form K3 -> (out, gx, gy), each
    [B, Hout, W, C], formulas as `warp_sample_grads_reference`."""
    _check_shifted(image, grid, row0, full_height)
    return _blend_grads(*bilinear_taps(image, grid, full_height, row0))


def _kernel_args(image: Tensor, grid: Tensor, name: str):
    """Check what a kernel takes; -> (library, B, Himg, W, C, stream)."""
    if image.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {image.device}")
    if image.dtype != torch.float32 or grid.dtype != torch.float32:
        raise TypeError(f"{name} kernel takes float32; got image "
                        f"{image.dtype}, grid {grid.dtype}")
    if not (image.is_contiguous() and grid.is_contiguous()):
        raise ValueError(f"{name} kernel takes contiguous tensors")
    stream = torch.cuda.current_stream(image.device).cuda_stream
    return (_kernel_library(), *image.shape, stream)


def _aligned(*tensors: Tensor) -> int:
    """1 if every tensor starts on 16 bytes (the kernels' vector loads and
    stores), else 0 (they go one pixel at a time)."""
    return int(all(t.data_ptr() % 16 == 0 for t in tensors))


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
            gy.data_ptr(), B, H, W, C, _aligned(grid, out, gx, gy), stream)
    if err != 0:
        raise RuntimeError(f"warp_sample_fwd_grads launch failed: CUDA error {err}")
    warp_sample_grads.launches += 1
    return out, gx, gy


warp_sample_grads.launches = 0


def warp_sample_shifted(image: Tensor, grid: Tensor, row0: int,
                        full_height: int) -> Tensor:
    """K3, eval form: warp the slab `image` [B, Himg, W, C] (global rows
    row0 .. row0 + Himg - 1 of a `full_height`-row image) by `grid`
    [B, Hout, W, 2] (global coordinates) -> [B, Hout, W, C]. CUDA tensors
    go through the kernel, CPU tensors through the plain version."""
    _check_shifted(image, grid, row0, full_height)
    if image.device.type == "cpu":
        return warp_sample_shifted_reference(image, grid, row0, full_height)
    lib, B, Himg, W, C, stream = _kernel_args(image, grid, "warp_sample_shifted")
    Hout = grid.shape[1]
    out = image.new_empty((B, Hout, W, C))
    with torch.cuda.device(image.device):
        err = lib.warp_sample_fwd_shifted(
            image.data_ptr(), grid.data_ptr(), out.data_ptr(), B, Himg, Hout, W,
            C, row0, full_height, stream)
    if err != 0:
        raise RuntimeError(f"warp_sample_fwd_shifted launch failed: CUDA error {err}")
    warp_sample_shifted.launches += 1
    return out


warp_sample_shifted.launches = 0


def warp_sample_grads_shifted(image: Tensor, grid: Tensor, row0: int,
                              full_height: int):
    """K3, train form: `warp_sample_shifted` plus the tap differences ->
    (out, gx, gy), each [B, Hout, W, C]. CUDA tensors go through the
    kernel, CPU tensors through the plain version."""
    _check_shifted(image, grid, row0, full_height)
    if image.device.type == "cpu":
        return warp_sample_grads_shifted_reference(image, grid, row0, full_height)
    lib, B, Himg, W, C, stream = _kernel_args(image, grid,
                                              "warp_sample_grads_shifted")
    Hout = grid.shape[1]
    out, gx, gy = (image.new_empty((B, Hout, W, C)) for _ in range(3))
    with torch.cuda.device(image.device):
        err = lib.warp_sample_fwd_grads_shifted(
            image.data_ptr(), grid.data_ptr(), out.data_ptr(), gx.data_ptr(),
            gy.data_ptr(), B, Himg, Hout, W, C, row0, full_height,
            _aligned(grid, out, gx, gy), stream)
    if err != 0:
        raise RuntimeError("warp_sample_fwd_grads_shifted launch failed: "
                           f"CUDA error {err}")
    warp_sample_grads_shifted.launches += 1
    return out, gx, gy


warp_sample_grads_shifted.launches = 0


def _clip_slope(coord: Tensor, size: int) -> Tensor:
    """d w / d coord of one axis of `bilinear_taps`: 0.5·(size - 1) times
    the `jnp.clip` derivative of the unnormalized coordinate, which is 1
    inside [0, size - 1], 0.5 on its ends and 0 outside (and for NaN)."""
    u = (coord + 1.0) * 0.5 * (size - 1)
    inside = ((u > 0) & (u < size - 1)).to(coord.dtype)
    tie = ((u == 0) | (u == size - 1)).to(coord.dtype)
    return (inside + 0.5 * tie) * (0.5 * (size - 1))


def _check_vjp(grid: Tensor, dout: Tensor, gx: Tensor, gy: Tensor,
               full_height: int) -> None:
    if gx.ndim != 4 or dout.shape != gx.shape or gy.shape != gx.shape:
        raise ValueError(f"grid_vjp needs dout, gx, gy [B, Ho, W, C] alike; got "
                         f"{tuple(dout.shape)}, {tuple(gx.shape)}, {tuple(gy.shape)}")
    if grid.shape != gx.shape[:3] + (2,):
        raise ValueError(f"grid_vjp needs grid [B, Ho, W, 2] matching gx "
                         f"{tuple(gx.shape)}; got {tuple(grid.shape)}")
    if gx.shape[2] < 2 or full_height < 2:
        raise ValueError(f"grid_vjp needs W, full_height >= 2; got "
                         f"{gx.shape[2]}, {full_height}")
    dtypes = {t.dtype for t in (grid, dout, gx, gy)}
    if len(dtypes) != 1 or not grid.dtype.is_floating_point:
        raise TypeError(f"grid_vjp needs one floating dtype; got {sorted(map(str, dtypes))}")
    if len({t.device for t in (grid, dout, gx, gy)}) != 1:
        raise ValueError("grid_vjp needs its tensors on one device")


def grid_vjp_reference(grid: Tensor, dout: Tensor, gx: Tensor, gy: Tensor,
                       full_height: int) -> Tensor:
    """Plain torch version of K1-bwd: the cotangent of `grid`
    [B, Ho, W, 2] from that of the warp's output and its tap differences
    (all [B, Ho, W, C]): d wx = sum_c dout·gx, d wy = sum_c dout·gy (summed
    left to right over the channels, as the kernel does), chained through
    the coordinates' clip. y was normalized over `full_height` rows: Ho for
    the same-size warp, the full image's height for a slab (K3). The floor
    anchors pass no gradient. Any float dtype. Counterpart of `_grid_vjp`."""
    _check_vjp(grid, dout, gx, gy, full_height)
    dwx, dwy = dout[..., 0] * gx[..., 0], dout[..., 0] * gy[..., 0]
    for c in range(1, gx.shape[3]):
        dwx = dwx + dout[..., c] * gx[..., c]
        dwy = dwy + dout[..., c] * gy[..., c]
    return torch.stack([dwx * _clip_slope(grid[..., 0], gx.shape[2]),
                        dwy * _clip_slope(grid[..., 1], full_height)], -1)


def grid_vjp(grid: Tensor, dout: Tensor, gx: Tensor, gy: Tensor,
             full_height: int) -> Tensor:
    """The gradient with respect to the grid (`grid_vjp_reference`), as
    one kernel (K1-bwd): CUDA tensors go through it (float32), CPU tensors
    through the plain version. `dout` may be strided or expanded, as
    autograd hands it."""
    dout = dout.contiguous()
    if grid.device.type == "cpu":
        return grid_vjp_reference(grid, dout, gx, gy, full_height)
    _check_vjp(grid, dout, gx, gy, full_height)
    if grid.device.type != "cuda":
        raise ValueError(f"grid_vjp runs on cuda or cpu, not {grid.device}")
    if grid.dtype != torch.float32:
        raise TypeError(f"grid_vjp kernel takes float32; got {grid.dtype}")
    if not all(t.is_contiguous() for t in (grid, gx, gy)):
        raise ValueError("grid_vjp kernel takes contiguous tensors")
    B, Ho, W, C = gx.shape
    dgrid = torch.empty_like(grid)
    with torch.cuda.device(grid.device):
        err = _kernel_library().warp_sample_bwd_grid(
            grid.data_ptr(), dout.data_ptr(), gx.data_ptr(), gy.data_ptr(),
            dgrid.data_ptr(), B, Ho, W, C, full_height,
            _aligned(grid, dout, gx, gy, dgrid),
            torch.cuda.current_stream(grid.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"warp_sample_bwd_grid launch failed: CUDA error {err}")
    grid_vjp.launches += 1
    return dgrid


grid_vjp.launches = 0


class WarpSample(torch.autograd.Function):
    """`warp_sample` with a gradient with respect to the grid: the train
    step's sampler, `WarpSample.apply(image, grid)`.

    The forward runs `warp_sample_grads` and keeps grid, gx and gy; the
    backward is `grid_vjp`: the kernels on CUDA tensors, the plain
    versions on CPU tensors, and with `plain=True` the plain versions of
    both on any device. The image gets no gradient (None): JAX's
    `warp_sample` returns a zero image cotangent by contract, which is
    exact in the train step, where the sampled images are data with no
    dependence on parameters. Do not use it where the sampled image itself
    needs a gradient."""

    @staticmethod
    def forward(ctx, image: Tensor, grid: Tensor, plain: bool = False):
        fn = warp_sample_grads_reference if plain else warp_sample_grads
        out, gx, gy = fn(image, grid)
        ctx.save_for_backward(grid, gx, gy)
        ctx.plain = plain
        return out

    @staticmethod
    def backward(ctx, dout: Tensor):
        grid, gx, gy = ctx.saved_tensors
        fn = grid_vjp_reference if ctx.plain else grid_vjp
        return None, fn(grid, dout, gx, gy, gx.shape[1]), None


class WarpSampleShifted(torch.autograd.Function):
    """`warp_sample_shifted` with a gradient with respect to the grid:
    `WarpSampleShifted.apply(slab, grid, row0, full_height)`, the train
    step's warp of a row slab under a spatial mesh.

    The forward runs `warp_sample_grads_shifted` (K3 on CUDA tensors, the
    plain version on CPU tensors); the backward is `grid_vjp` (K1-bwd)
    over `full_height` rows, as JAX's `_bwd_shifted`. The slab gets no gradient
    (None; JAX returns zeros shaped like the slab), by the same contract
    as `WarpSample`."""

    @staticmethod
    def forward(ctx, image: Tensor, grid: Tensor, row0: int, full_height: int):
        out, gx, gy = warp_sample_grads_shifted(image, grid, row0, full_height)
        ctx.save_for_backward(grid, gx, gy)
        ctx.full_height = full_height
        return out

    @staticmethod
    def backward(ctx, dout: Tensor):
        grid, gx, gy = ctx.saved_tensors
        return None, grid_vjp(grid, dout, gx, gy, ctx.full_height), None, None


@functools.lru_cache(maxsize=None)
def _kernel_library() -> ctypes.CDLL:
    lib = load_library("warp_sample")
    # (B, H, W, C), the train form + aligned; the shifted forms (B, Himg,
    # Hout, W, C, row0, full_height), the train form + aligned; the
    # backward (B, Hout, W, C, full_height, aligned)
    for fn, n_ptrs, n_ints in ((lib.warp_sample_fwd, 3, 4),
                               (lib.warp_sample_fwd_grads, 5, 5),
                               (lib.warp_sample_fwd_shifted, 3, 7),
                               (lib.warp_sample_fwd_grads_shifted, 5, 8),
                               (lib.warp_sample_bwd_grid, 5, 6)):
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def dy_span(grid: Tensor, row0: int = 0, full_height: int | None = None) -> Tensor:
    """Mean over 8-row slabs of the vertical anchor offset's span (px):
    the `warp_span` telemetry metric of the eval step. A large value means
    a degenerate warp field. Needs H % 8 == 0. With `full_height`, `grid`
    holds the rows from the global row `row0` of an image that high."""
    B, H, W, _ = grid.shape
    Hf = full_height or H
    y = torch.clamp((grid[..., 1] + 1.0) * 0.5 * (Hf - 1), 0.0, Hf - 1)
    y0 = torch.clamp(torch.floor(y), 0, Hf - 2)
    rows = torch.arange(row0, row0 + H, dtype=y0.dtype, device=y0.device)
    slabs = (y0 - rows[None, :, None]).reshape(B, H // SLAB, SLAB * W)
    return (slabs.amax(-1) - slabs.amin(-1)).mean()
