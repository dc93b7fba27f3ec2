"""The train-form warp's backward in the port (`grid_vjp`, K1-bwd on the
card): its plain version `grid_vjp_reference` against JAX's `_grid_vjp`
on the same inputs, the wrapper's CPU rule and checks, and `WarpSample`'s
backward on the stride-0 cotangent that `out.sum().backward()` hands it.
The CUDA kernel against its plain version is in tests/test_torch_gpu.py.

JAX's `_grid_vjp` takes gx and gy in the Pallas kernel's NCHW layout and
rounds the coordinates' weights to float32 (`_coords`), so it runs in
float32 only; the float64 cases go through `jax.vjp` of the jnp
`grid_sample`, whose weights keep the input's type, with gx and gy from
the port's float64 plain forward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monodepth_tpu.ops.pallas.warp_sample import _grid_vjp as jax_grid_vjp
from monodepth_tpu.ops.sampling import grid_sample as jax_grid_sample
from monodepth_tpu_torch.ops.cuda.warp_sample import (
    WarpSample,
    grid_vjp,
    grid_vjp_reference,
    warp_sample_grads_shifted_reference,
)
from test_torch_warp_sample import _warp_grid_np

B, W, C = 2, 20, 3
FIELDS = ["smooth+wild", "identity", "nan", "shifted"]


def _identity_grid(b, h, w):
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    grid = np.stack([xs / (w - 1) * 2 - 1, ys / (h - 1) * 2 - 1], -1)
    return grid[None].repeat(b, 0)


def _case(rng, field):
    """(grid [B, Ho, W, 2] float64, full_height): a smooth field with one
    wild batch entry; the identity grid, where every border pixel lies on
    a clip bound; the smooth field with NaN and +-inf coordinates; rows
    8-15 of a 24-row field (a slab's grid, y over the full height)."""
    if field == "smooth+wild":
        return _warp_grid_np(rng, B, 12, W).astype(np.float64), 12
    if field == "identity":
        return _identity_grid(B, 8, W), 8
    if field == "nan":
        grid = _warp_grid_np(rng, B, 8, W, wild_entry=False).astype(np.float64)
        grid[0, 1, 2] = np.nan
        grid[0, 4, 5, 1] = np.inf
        grid[-1, -1, -1, 0] = -np.inf
        grid[1, 3, 7, 0] = np.nan
        return grid, 8
    return _warp_grid_np(rng, B, 24, W).astype(np.float64)[:, 8:16].copy(), 24


def _scale(a):
    return max(float(np.nanmax(np.abs(a))), 1.0)


@pytest.mark.parametrize("field", FIELDS)
def test_reference_matches_jax_grid_vjp_f32(rng, field):
    """f32, random dout, gx and gy: only the order of the channel sum can
    differ from JAX's `jnp.sum`, so atol 2e-6·max(scale, 1)."""
    grid, full = _case(rng, field)
    grid = grid.astype(np.float32)
    dout, gx, gy = (rng.standard_normal(grid.shape[:3] + (C,)).astype(np.float32)
                    for _ in range(3))
    ours = grid_vjp_reference(*map(torch.from_numpy, (grid, dout, gx, gy)), full).numpy()
    theirs = np.asarray(jax_grid_vjp(jnp.asarray(grid), jnp.asarray(dout),
                                     jnp.asarray(gx.transpose(0, 3, 1, 2)),
                                     jnp.asarray(gy.transpose(0, 3, 1, 2)),
                                     full, grid.shape[2]))
    assert ours.dtype == np.float32 and ours.shape == grid.shape
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(theirs))
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=2e-6 * _scale(theirs))
    if field == "identity":  # the border columns are ties: half the slope
        dwx = (dout * gx).sum(-1)
        for col in (0, -1):
            np.testing.assert_allclose(ours[:, :, col, 0],
                                       dwx[:, :, col] * 0.25 * (W - 1), rtol=1e-5)
        np.testing.assert_allclose(ours[:, :, 1:-1, 0], dwx[:, :, 1:-1] * 0.5 * (W - 1),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("field", FIELDS)
def test_reference_matches_jax_vjp_f64(rng, field):
    """f64: dgrid from the port's plain forward and `grid_vjp_reference`
    against `jax.vjp` through the jnp `grid_sample` (y over the full
    height: the grid of the shifted case samples the whole 24-row image),
    atol 1e-12."""
    grid, full = _case(rng, field)
    img = rng.uniform(size=(B, full, W, C))
    dout = rng.standard_normal(grid.shape[:3] + (C,))
    _, gx, gy = warp_sample_grads_shifted_reference(
        torch.from_numpy(img), torch.from_numpy(grid), 0, full)
    ours = grid_vjp_reference(torch.from_numpy(grid), torch.from_numpy(dout),
                              gx, gy, full).numpy()
    with jax.enable_x64(True):
        _, vjp = jax.vjp(lambda g: jax_grid_sample(jnp.asarray(img), g), jnp.asarray(grid))
        theirs = np.asarray(vjp(jnp.asarray(dout))[0])
    assert ours.dtype == theirs.dtype == np.float64
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(theirs))
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-12)


def test_reference_rounds_as_the_kernel(rng):
    """f32, C = 4: the channel sums run left to right from the first
    product and the slope is (inside + 0.5·tie)·(0.5·(size - 1)), each
    step rounded to f32, which is what the kernel computes."""
    grid, full = _case(rng, "smooth+wild")
    grid = grid.astype(np.float32)
    dout, gx, gy = (rng.standard_normal(grid.shape[:3] + (4,)).astype(np.float32)
                    for _ in range(3))
    ours = grid_vjp_reference(*map(torch.from_numpy, (grid, dout, gx, gy)), full).numpy()

    def dot(a):
        s = dout[..., 0] * a[..., 0]
        for c in range(1, 4):
            s = s + dout[..., c] * a[..., c]
        return s

    def slope(g, size):
        u = (g + np.float32(1)) * np.float32(0.5) * np.float32(size - 1)
        inside = ((u > 0) & (u < size - 1)).astype(np.float32)
        tie = ((u == 0) | (u == size - 1)).astype(np.float32)
        return (inside + np.float32(0.5) * tie) * np.float32(0.5 * (size - 1))

    expected = np.stack([dot(gx) * slope(grid[..., 0], W),
                         dot(gy) * slope(grid[..., 1], full)], -1)
    assert expected.dtype == np.float32
    np.testing.assert_array_equal(ours, expected)


def test_cpu_tensors_take_plain_version_without_counting(rng):
    grid, full = _case(rng, "shifted")
    args = [torch.from_numpy(grid.astype(np.float32))] + [
        torch.from_numpy(rng.standard_normal(grid.shape[:3] + (C,)).astype(np.float32))
        for _ in range(3)]
    before = grid_vjp.launches
    ours = grid_vjp(*args, full)
    assert grid_vjp.launches == before
    assert torch.equal(ours, grid_vjp_reference(*args, full))


def test_grid_vjp_checks_what_it_takes():
    grid, t = torch.zeros(1, 4, 6, 2), torch.zeros(1, 4, 6, 3)
    with pytest.raises(ValueError, match="alike"):
        grid_vjp(grid, torch.zeros(1, 4, 6, 4), t, t, 4)
    with pytest.raises(ValueError, match="matching"):
        grid_vjp(torch.zeros(1, 4, 5, 2), t, t, t, 4)
    with pytest.raises(ValueError, match=">= 2"):
        grid_vjp(grid, t, t, t, 1)
    with pytest.raises(TypeError):
        grid_vjp(grid.double(), t, t, t, 4)
    with pytest.raises(TypeError):
        grid_vjp_reference(grid.int(), t.int(), t.int(), t.int(), 4)


def test_stride0_cotangent_gives_the_dgrid_of_explicit_ones(rng):
    """`out.sum().backward()` hands `WarpSample` an expanded (stride-0)
    cotangent; the dgrid is that of a contiguous `torch.ones`."""
    img = torch.from_numpy(rng.uniform(size=(B, 8, W, C)).astype(np.float32))
    field = torch.from_numpy(_warp_grid_np(rng, B, 8, W))
    dgrids = []
    for explicit in (False, True):
        g = field.clone().requires_grad_(True)
        out = WarpSample.apply(img, g)
        if explicit:
            out.backward(torch.ones_like(out))
        else:
            out.sum().backward()
        dgrids.append(g.grad)
    assert bool(dgrids[0].abs().max() > 0)
    assert torch.equal(dgrids[0], dgrids[1])
